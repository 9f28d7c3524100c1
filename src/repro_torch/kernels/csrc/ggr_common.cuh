// Shared device code of the GGR CUDA kernels (ggr_update.cu, ggr_panel.cu).
//
// One GGR column step over an active set of n rows (row 0 is the pivot row),
// the per-column body of both TPU kernels it replaces:
//
//   sigma = max_i |v_i|,  vs = v / sigma            (safe-Givens scaling)
//   t_i   = sqrt(sum_{r>=i} vs_r^2)                 (suffix norms)
//   P_i   = sum_{r>=i} vs_r a_r,  S_i = P_{i+1}     (inclusive / shifted suffix dots)
//   row 0   <- P_0 / t_0                            (pivot row)
//   row i+1 <- valid_i ? k_i S_i - l_i a_i : a_{i+1}  (DET2 grid)
//   k_i = vs_i / (t_i t_{i+1}),  l_i = t_{i+1} / t_i,  valid_i = t_{i+1} > EPS
//
// The exclusive suffix S is the inclusive one shifted by a row, never P - prod
// (which cancels catastrophically).  Every divisor is EPS-guarded, so an
// all-zero active column (t_0 <= EPS) leaves the problem bit-for-bit as it was.
#pragma once

#include <cuda_runtime.h>

namespace ggr {

// 1e-30 at every dtype: the constant of the TPU kernels (ggr_panel.py _EPS).
template <typename T>
__device__ __forceinline__ T eps() { return T(1e-30); }

// Shared-memory slots block_absmax needs for its partial maxima.
constexpr int kReduceSlots = 32;

// The max of every thread's `m` (each >= 0), a block reduction: every thread
// of the block calls it (blockDim is a multiple of 32) and every thread gets
// the result.  red: kReduceSlots shared slots.  The max is exact, so the
// order of the reduction does not matter.
template <typename T>
__device__ T block_max(T m, T* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const T o = __shfl_down_sync(0xffffffffu, m, off);
    m = o > m ? o : m;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_down_sync(0xffffffffu, m, off);
      m = o > m ? o : m;
    }
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  const T result = red[0];
  __syncthreads();  // red[0] is reused by the next reduction
  return result;
}

// sigma = max_i |col_i| over n rows (consecutive rows `stride` apart).
template <typename T>
__device__ T block_absmax(const T* col, int stride, int n, T* red) {
  T m = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T a = fabs(col[(size_t)i * stride]);
    m = a > m ? a : m;
  }
  return block_max(m, red);
}

// Coefficient chain of one active column, computed by ONE thread, given the
// column's max-abs scale sigma.  col: first active element, consecutive
// active rows `stride` apart; n rows.  Writes vs, kk, ll, vd (valid as 0/1)
// for rows 0..n-1 and returns t_0.
template <typename T>
__device__ T column_coeffs(const T* col, int stride, int n, T sigma, T* vs,
                           T* kk, T* ll, T* vd) {
  const T scale = sigma > T(0) ? sigma : T(1);
  for (int i = 0; i < n; ++i) vs[i] = col[(size_t)i * stride] / scale;
  T acc = T(0);
  T t_next = T(0);  // t_{i+1}; zero beyond the last row
  for (int i = n - 1; i >= 0; --i) {
    acc += vs[i] * vs[i];
    const T t = sqrt(acc);
    const bool valid = t_next > eps<T>();
    const T st = t > eps<T>() ? t : T(1);
    const T stn = valid ? t_next : T(1);
    kk[i] = vs[i] / (st * stn);
    ll[i] = stn / st;
    vd[i] = valid ? T(1) : T(0);
    t_next = t;
  }
  return t_next;
}

// DET2 sweep of one column j over the active rows, bottom-up, in place.
// col: the column's element in active row 0; rows `stride` apart.  Rows
// 1..n-1 receive their DET2 values; row 0 is left for the caller, which
// writes P_0 / t_0 (returned here as P_0).  The inclusive suffix dot rides in
// a register and the old value of row i stays in a register while row i+1 is
// written, so each element is read once and written once.
template <typename T>
__device__ T sweep_column(T* col, int stride, int n, const T* vs, const T* kk,
                          const T* ll, const T* vd) {
  T P = T(0);       // P_{i+1} = S_i while row i is processed
  T a_next = T(0);  // old value of row i+1
  for (int i = n - 1; i >= 0; --i) {
    const T a = col[(size_t)i * stride];
    if (i < n - 1)
      col[(size_t)(i + 1) * stride] = vd[i] != T(0) ? kk[i] * P - ll[i] * a : a_next;
    P = vs[i] * a + P;
    a_next = a;
  }
  return P;
}

}  // namespace ggr
