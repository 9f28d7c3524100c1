// Row-chunked block-wide reverse scans of the fused schedule's panel kernel
// (ggr_panel_factor.cu), over the rows of one slab of a panel.
//
// A block sweeps nc columns over the active rows [row0, row1).  Its threads
// are laid out as nchunks = blockDim / nc row chunks times nc columns, column
// fastest, so neighbouring threads touch neighbouring columns of one row.  A
// reverse (suffix) sum over the rows then takes three steps:
//
//   1. each thread sums its chunk of its column (the chunk partial);
//   2. chunk_carry scans the chunk partials across the block, giving each
//      thread the sum over every row below its chunk (the carry);
//   3. each thread walks its chunk bottom-up from that carry, so every row
//      sees its inclusive suffix sum.
//
// Rows are never shared between chunks, so step 3 may write its rows; a value
// that a chunk needs from the chunk above (the DET2 shift's one-row halo) is
// read in step 1, before chunk_carry's barriers.
//
// chunk_dot and det2_walk take the column and its coefficients through
// accessors, so one walk serves a slab held in shared memory and one kept in
// device memory (a panel too tall for the blocks' shared memory).  Both issue
// the loads of G rows together before using any of them: a walk step that
// waited for each load in turn would pay the full load latency once per row.
#pragma once

#include <cuda_runtime.h>

#include "ggr_common.cuh"

namespace ggr {

struct Chunking {
  int nc;       // columns
  int nchunks;  // row chunks per column
  int k;        // this thread's chunk
  int jj;       // this thread's column, 0..nc-1
  int lo, hi;   // this thread's rows [lo, hi); empty when lo == hi
  bool active;  // k < nchunks (the last blockDim % nc threads idle)
};

// Split rows [row0, row1) of nc columns (1 <= nc <= blockDim.x) over the block.
__device__ __forceinline__ Chunking chunking(int nc, int row0, int row1) {
  Chunking s;
  s.nc = nc;
  s.nchunks = (int)blockDim.x / nc;
  const int n = row1 > row0 ? row1 - row0 : 0;
  const int len = (n + s.nchunks - 1) / s.nchunks;
  s.k = (int)threadIdx.x / nc;
  s.jj = (int)threadIdx.x - s.k * nc;
  s.active = s.k < s.nchunks;
  const int lo = row0 + s.k * len;
  s.lo = lo < row1 ? lo : row1;
  s.hi = s.lo + len < row1 ? s.lo + len : row1;
  if (!s.active) s.hi = s.lo;
  return s;
}

// The carry of this thread's chunk: the sum of the partials `x` of every
// chunk below it in the same column.  A Hillis-Steele reverse scan over the
// chunks in shared memory (`part`: blockDim.x slots), ceil(log2 nchunks)
// steps.  Every thread of the block calls it; it starts and ends with a
// barrier, so `part` may be reused at once.
template <typename T>
__device__ T chunk_carry(const Chunking& s, T x, T* part) {
  const int i = s.k * s.nc + s.jj;
  if (s.active) part[i] = x;
  __syncthreads();
  for (int d = 1; d < s.nchunks; d <<= 1) {
    T val = T(0);
    if (s.active) {
      val = part[i];
      if (s.k + d < s.nchunks) val += part[i + d * s.nc];
    }
    __syncthreads();
    if (s.active) part[i] = val;
    __syncthreads();
  }
  const T carry = (s.active && s.k + 1 < s.nchunks) ? part[i + s.nc] : T(0);
  __syncthreads();
  return carry;
}

// Step 1 for one column: sum_{r in [lo, hi)} v(r) * x(r).
template <typename T, int G, typename V, typename X>
__device__ __forceinline__ T chunk_dot(int lo, int hi, V v, X x) {
  T acc = T(0);
  int r0 = lo;
  for (; r0 + G <= hi; r0 += G) {  // whole groups: no guards
    T a[G], b[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      a[i] = v(r0 + i);
      b[i] = x(r0 + i);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) acc += a[i] * b[i];
  }
  for (; r0 < hi; ++r0) acc += v(r0) * x(r0);
  return acc;
}

// Step 3 of one GGR column step for one column of the thread's chunk
// [lo, hi), bottom-up from the carry P (the suffix dot of the rows below):
//   P_r = v_r x_r + P_{r+1}                       (inclusive suffix dot)
//   row p   <- P_p / tp                           (pivot row, p == lo)
//   row r>p <- valid_{r-1} ? k_{r-1} P_r - l_{r-1} x_{r-1} : x_r   (DET2)
// valid_i is carried in the sign of l_i (l = t_{i+1}/t_i > 0 when valid; the
// coefficient passes store -1 otherwise).  x_{lo-1} is the halo read before
// any chunk wrote.  Loads of a group of G rows all happen before the group's
// stores, and a group reads only rows at or above the rows it writes, so
// every read sees the old value.  Whole groups below the pivot row run
// without guards; the rest (fewer than G rows, or the group holding the
// pivot) runs the guarded form.
template <typename T, int G, typename X, typename St, typename V, typename K,
          typename L>
__device__ __forceinline__ void det2_walk(int lo, int hi, int p, T P, T halo,
                                          T tp, X x, St store, V v, K kk, L ll) {
  if (lo >= hi) return;
  T x_cur = x(hi - 1);
  int top = hi;
  for (; top - G >= lo && top - G > p; top -= G) {
    T vv[G], xp[G], k[G], l[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int r = top - 1 - i;
      vv[i] = v(r);
      xp[i] = i < G - 1 || r > lo ? x(r - 1) : halo;
      k[i] = kk(r - 1);
      l[i] = ll(r - 1);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      P += vv[i] * x_cur;
      store(top - 1 - i, l[i] > T(0) ? k[i] * P - l[i] * xp[i] : x_cur);
      x_cur = xp[i];
    }
  }
  for (; top > lo; top -= G) {
    T vv[G], xp[G], k[G], l[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int r = top - 1 - i;
      const bool body = r >= lo && r > p;
      vv[i] = r >= lo ? v(r) : T(0);
      xp[i] = body ? (r > lo ? x(r - 1) : halo) : T(0);
      k[i] = body ? kk(r - 1) : T(0);
      l[i] = body ? ll(r - 1) : T(0);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int r = top - 1 - i;
      if (r < lo) break;
      P += vv[i] * x_cur;
      if (r == p) {
        store(r, P / tp);
        break;
      }
      store(r, l[i] > T(0) ? k[i] * P - l[i] * xp[i] : x_cur);
      x_cur = xp[i];
    }
  }
}

// The coefficients of row i of a column step from its suffix norms t_i and
// t_{i+1} (0 past the last row) and scaled entry v_i: k = v / (t_i t_{i+1})
// and l = t_{i+1} / t_i with every divisor guarded, l = -1 where the
// rotation at (i, i+1) is degenerate (t_{i+1} <= eps).
template <typename T>
__device__ __forceinline__ void det2_coeffs(T v, T t, T tn, T& k, T& l) {
  const bool valid = tn > eps<T>();
  const T st = t > eps<T>() ? t : T(1);
  const T stn = valid ? tn : T(1);
  k = v / (st * stn);
  l = valid ? stn / st : T(-1);
}

// Rows a walk loads together: 8 in f32, 4 in f64 (about 40 registers).
template <typename T>
struct WalkGroup { static constexpr int value = 32 / sizeof(T); };

}  // namespace ggr
