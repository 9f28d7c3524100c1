// The warp-parallel GGR column step shared by the row-append kernel
// (ggr_update.cu, B1) and the tile GEQRT kernel (ggr_panel.cu, B2): a
// column's coefficient chain computed by one warp with the active rows over
// its lanes (coeff_chain), and one thread's bottom-up walk of a whole column
// (column_walk), each row's coefficients in one 16-byte record (Rec).  See
// ggr_common.cuh for the column step itself.
#pragma once

#include <cuda_runtime.h>

#include "ggr_common.cuh"
#include "ggr_scan.cuh"

namespace ggr {

constexpr unsigned kFull = 0xffffffffu;

// What the walk of active row r needs, in one 16-byte-aligned record:
// v_r and the DET2 coefficients k_{r-1}, l_{r-1} of the row above (t_r is
// parked in pad while the coefficients are formed).
template <typename T>
struct __align__(16) Rec {
  T v, k, l, pad;
};

// Column c's coefficients over its n active rows, by one warp (every lane
// calls it).  col(i): active row i of column c.  Writes rec[i].v = v_i and
// rec[i+1].k, .l = k_i, l_i for every row, and slot[0] = sigma, slot[1] =
// t_0.  Lane L owns rows [L*R, L*R+R), held in registers when R <= RM (n <=
// 32*RM), else walked through rec in three passes; both in the same
// order, so with the same bits.  A zero column writes only the slots (both
// 0): its step is skipped, and its records are never read.
template <typename T, typename Col>
__device__ void coeff_chain(int lane, int n, Col col, Rec<T>* rec, T* slot) {
  constexpr int RM = 4;
  const int R = (n + 31) / 32;
  const int lo = min(lane * R, n), hi = min(lo + R, n);
  auto warp_max = [](T x) {  // the max is exact in any order
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_xor_sync(kFull, x, off);
      x = o > x ? o : x;
    }
    return x;
  };
  // reverse inclusive scan over the lanes (Hillis-Steele) of each lane's sum
  // of squares, then the carry: the sum over every lane below this one
  auto carry_below = [lane](T s) {
    for (int off = 1; off < 32; off <<= 1) {
      const T o = __shfl_down_sync(kFull, s, off);
      if (lane + off < 32) s += o;
    }
    const T c = __shfl_down_sync(kFull, s, 1);
    return lane == 31 ? T(0) : c;
  };
  auto t_below = [lane](T t_lo) {  // t of the row below this lane's rows
    const T t = __shfl_down_sync(kFull, t_lo, 1);
    return lane == 31 ? T(0) : t;
  };
  T mx = T(0), t_lo = T(0);
  // a zero column (sigma == 0, the same in every lane): t_0 = 0 tells the
  // caller to leave the problem as it is, so no coefficient is formed
  auto zero_column = [&] {
    if (lane == 0) slot[0] = slot[1] = T(0);
  };
  if (R <= RM) {
    T v[RM], t[RM];
#pragma unroll
    for (int q = 0; q < RM; ++q) {  // an in-range row even where unused:
      const T x = col(min(lo + q, n - 1));  // the load may be speculated
      v[q] = lo + q < hi ? x : T(0);
      mx = fabs(v[q]) > mx ? fabs(v[q]) : mx;
    }
    mx = warp_max(mx);
    if (mx == T(0)) return zero_column();
    const T scale = mx > T(0) ? mx : T(1);
    T s = T(0);  // this lane's sum of squares, bottom-up
#pragma unroll
    for (int q = RM - 1; q >= 0; --q)
      if (lo + q < hi) {
        v[q] = v[q] / scale;
        s += v[q] * v[q];
      }
    T acc = carry_below(s);
#pragma unroll
    for (int q = RM - 1; q >= 0; --q)
      if (lo + q < hi) {
        acc += v[q] * v[q];
        t[q] = sqrt(acc);
      }
    t_lo = lo < hi ? t[0] : T(0);
    T tn = t_below(t_lo);
#pragma unroll
    for (int q = RM - 1; q >= 0; --q)
      if (lo + q < hi) {
        const int i = lo + q;
        rec[i].v = v[q];
        if (i + 1 < n) det2_coeffs(v[q], t[q], tn, rec[i + 1].k, rec[i + 1].l);
        tn = t[q];
      }
  } else {
    for (int i = lo; i < hi; ++i) {
      const T a = fabs(col(i));
      mx = a > mx ? a : mx;
    }
    mx = warp_max(mx);
    if (mx == T(0)) return zero_column();
    const T scale = mx > T(0) ? mx : T(1);
    T s = T(0);
    for (int i = hi - 1; i >= lo; --i) {
      const T v = col(i) / scale;
      rec[i].v = v;
      s += v * v;
    }
    T acc = carry_below(s);
    for (int i = hi - 1; i >= lo; --i) {  // t_i, parked in pad
      acc += rec[i].v * rec[i].v;
      rec[i].pad = sqrt(acc);
    }
    t_lo = lo < hi ? rec[lo].pad : T(0);
    T tn = t_below(t_lo);
    for (int i = hi - 1; i >= lo; --i) {
      const T t = rec[i].pad;
      if (i + 1 < n) det2_coeffs(rec[i].v, t, tn, rec[i + 1].k, rec[i + 1].l);
      tn = t;
    }
  }
  if (lane == 0) {
    slot[0] = mx;
    slot[1] = t_lo;
  }
}

// One thread's walk of a whole column j, bottom-up:
// P_i = v_i a_i + P_{i+1}, row i <- valid_{i-1} ? k_{i-1} P_i - l_{i-1} a_{i-1}
// : a_i, and the pivot row P_0 / t_0 to *y (device memory, storage type S).
// colA: active row 1 of the column (rows ws apart), top: its pivot-row value.
// Each row written back is rounded through S at this step (round_to): the
// state of a mixed kernel holds only values of its tile dtype.  WG rows at a time load
// together before any of them is stored (every read sees the old value, and
// the load latency is paid once a group), each row's coefficients in one
// record.  The last 1..WG rows go one at a time in a loop kept rolled:
// NVVM (CUDA 12.8) unrolls it four times and, in the unrolled body, loads the
// fourth row above from an address register it sets only later in that body,
// a load that runs whenever more than four rows are left (PERF.md §6).
template <typename S, typename T, int WG>
__device__ __forceinline__ void column_walk(int n, T* colA, int ws, T top,
                                            const Rec<T>* rec, T t0, S* y) {
  T P = T(0);
  T* pa = colA + (n - 2) * ws;  // active row i = n-1, stepping up by ws
  T a = n > 1 ? *pa : top;
  int i = n - 1;                // the next row to write
  for (; i - WG >= 1; i -= WG, pa -= WG * ws) {  // rows i .. i-WG+1, all >= 2
    T up[WG];
    Rec<T> rc[WG];
#pragma unroll
    for (int q = 0; q < WG; ++q) {
      up[q] = pa[-(q + 1) * ws];
      rc[q] = rec[i - q];
    }
#pragma unroll
    for (int q = 0; q < WG; ++q) {
      P += rc[q].v * a;
      pa[-q * ws] = round_to<S>(rc[q].l > T(0) ? rc[q].k * P - rc[q].l * up[q] : a);
      a = up[q];
    }
  }
#pragma unroll 1
  for (; i >= 1; --i, pa -= ws) {
    const T up = i >= 2 ? pa[-ws] : top;
    const Rec<T> rc = rec[i];
    P += rc.v * a;
    *pa = round_to<S>(rc.l > T(0) ? rc.k * P - rc.l * up : a);
    a = up;
  }
  P += rec[0].v * a;
  *y = narrow<S>(P / t0);
}

// ---------------------------------------------------------------- narrow
// A narrow instance (bf16 / f16 tile S summed at its own width) computes
// what the plain version computes at that pair, operation by operation:
// each product, sum, ladder step, square root and division rounded to S
// (ggr_common.cuh, nmul ...), and each suffix sum in the order of the TPU
// kernel's doubling ladder, x_i += x_{i+d} for d = 1, 2, 4, ... (zero past
// the last row), which is also the plain version's
// (ggr_panel.py::_revcumsum).  The values are floats that S represents.

// k_i, l_i of a narrow instance, as det2_coeffs.
template <typename S>
__device__ __forceinline__ void det2_coeffs_narrow(float v, float t, float tn, float& k,
                                                   float& l) {
  const bool valid = tn > eps<float>();
  const float st = t > eps<float>() ? t : 1.f;
  const float stn = valid ? tn : 1.f;
  k = ndiv<S>(v, nmul<S>(st, stn));
  l = valid ? ndiv<S>(stn, st) : -1.f;
}

// coeff_chain of a narrow instance: the same records and slots.  Lane L
// takes rows L, L + 32, ...; the ladder over the squares runs between
// rec[].pad and rec[].k, a step a __syncwarp, and t_i ends in rec[i].pad.
template <typename S, typename Col>
__device__ void coeff_chain_narrow(int lane, int n, Col col, Rec<float>* rec, float* slot) {
  float mx = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float a = fabsf(col(i));
    mx = a > mx ? a : mx;
  }
  for (int off = 16; off > 0; off >>= 1) {  // the max is exact in any order
    const float o = __shfl_xor_sync(kFull, mx, off);
    mx = o > mx ? o : mx;
  }
  if (mx == 0.f) {  // a zero column: its step is skipped
    if (lane == 0) slot[0] = slot[1] = 0.f;
    return;
  }
  for (int i = lane; i < n; i += 32) {
    const float v = ndiv<S>(col(i), mx);
    rec[i].v = v;
    rec[i].pad = nmul<S>(v, v);
  }
  __syncwarp();
  bool in_pad = true;  // where the ladder's current values are
  for (int d = 1; d < n; d <<= 1) {
    for (int i = lane; i < n; i += 32) {
      const float x = in_pad ? rec[i].pad : rec[i].k;
      const float y = i + d < n ? (in_pad ? rec[i + d].pad : rec[i + d].k) : 0.f;
      if (in_pad)
        rec[i].k = nadd<S>(x, y);
      else
        rec[i].pad = nadd<S>(x, y);
    }
    in_pad = !in_pad;
    __syncwarp();
  }
  for (int i = lane; i < n; i += 32) rec[i].pad = nsqrt<S>(in_pad ? rec[i].pad : rec[i].k);
  __syncwarp();
  for (int i = lane; i + 1 < n; i += 32)
    det2_coeffs_narrow<S>(rec[i].v, rec[i].pad, rec[i + 1].pad, rec[i + 1].k, rec[i + 1].l);
  if (lane == 0) {
    slot[0] = mx;
    slot[1] = rec[0].pad;
  }
}

// column_walk of a narrow instance, one thread's column j: the products
// v_r a_r into the thread's scratch (row r at scr[r * ss]), the ladder over
// them in place (rows ascending: x_{i+d} is read before its own step), then
// the DET2 rows bottom-up and the pivot row P_0 / t_0 to *y.  L is the
// length of the plain version's ladder: n for B1; the tile height for B2,
// whose steps past the active rows add zeros (turning a -0 sum into +0).
template <typename S>
__device__ void column_walk_narrow(int n, int L, float* colA, int ws, float top,
                                   const Rec<float>* rec, float t0, S* y, float* scr,
                                   int ss) {
  for (int r = 0; r < n; ++r) scr[r * ss] = nmul<S>(rec[r].v, r == 0 ? top : colA[(r - 1) * ws]);
  int d = 1;
  for (; d < n; d <<= 1)
    for (int i = 0; i < n; ++i)
      scr[i * ss] = nadd<S>(scr[i * ss], i + d < n ? scr[(i + d) * ss] : 0.f);
  if (d < L)  // the ladder's steps past the last row, each adding zero
    for (int i = 0; i < n; ++i) scr[i * ss] = __fadd_rn(scr[i * ss], 0.f);
  float a = n > 1 ? colA[(n - 2) * ws] : top;  // row i, before its write
  for (int i = n - 1; i >= 1; --i) {
    const float up = i >= 2 ? colA[(i - 2) * ws] : top;
    const Rec<float> rc = rec[i];
    colA[(i - 1) * ws] =
        rc.l > 0.f ? nsub<S>(nmul<S>(rc.k, scr[i * ss]), nmul<S>(rc.l, up)) : a;
    a = up;
  }
  *y = narrow<S>(__fdiv_rn(scr[0], t0));
}

}  // namespace ggr
