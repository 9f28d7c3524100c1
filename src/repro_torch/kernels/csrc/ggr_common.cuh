// Shared device code of the GGR CUDA kernels.
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
//
// Two types per kernel: the storage type S (what device memory holds, the
// tile dtype of the JAX kernels) and the compute type T (their accumulation
// dtype).  Every kernel has the same seven instances: (float, float),
// (double, double), the mixed (__nv_bfloat16, float), (__half, float) and
// the wide (float, double), (__nv_bfloat16, double), (__half, double)
// (kernels/_cuda.py::suffix names their C entry points).  B1 and B2 also
// have narrow instances, bf16 / f16 tiles summed at their own width: they
// hold values in float registers and round every operation to the tile
// dtype (the n* helpers below).  A mixed
// kernel keeps its state in T but rounds every value it writes back to the
// state through S at the step that writes it (round_to), as the JAX kernels'
// .astype(cd) does, so the state always holds values S can represent; where
// S == T each helper is the identity and compiles to nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace ggr {

// An S value (device memory) as a T value: exact.
template <typename T, typename S>
__device__ __forceinline__ T widen(S x) {
  if constexpr (std::is_same_v<S, T>) {
    return x;
  } else if constexpr (std::is_same_v<S, float>) {
    static_assert(std::is_same_v<T, double>, "f32 tiles compute in double");
    return (double)x;
  } else if constexpr (std::is_same_v<S, __nv_bfloat16>) {
    static_assert(std::is_same_v<T, float> || std::is_same_v<T, double>,
                  "bf16 tiles compute in float or double");
    return T(__bfloat162float(x));
  } else {
    static_assert(std::is_same_v<S, __half> &&
                      (std::is_same_v<T, float> || std::is_same_v<T, double>),
                  "f16 tiles compute in float or double");
    return T(__half2float(x));
  }
}

// A T value stored as S, rounded to nearest even as XLA's convert (and the
// plain versions, kernels/backend.py::to_tile) round it: double to float and
// to half once; double to bf16 through float, twice, as torch and XLA both
// do (a single __double2bfloat16 would differ on ties of the second step).
template <typename S, typename T>
__device__ __forceinline__ S narrow(T x) {
  if constexpr (std::is_same_v<S, T>) {
    return x;
  } else if constexpr (std::is_same_v<T, double>) {
    if constexpr (std::is_same_v<S, float>)
      return __double2float_rn(x);
    else if constexpr (std::is_same_v<S, __nv_bfloat16>)
      return __float2bfloat16_rn(__double2float_rn(x));
    else
      return __double2half(x);
  } else if constexpr (std::is_same_v<S, __nv_bfloat16>) {
    return __float2bfloat16_rn(x);
  } else {
    return __float2half_rn(x);
  }
}

// x rounded through S, kept as T: the state's value after a write.
template <typename S, typename T>
__device__ __forceinline__ T round_to(T x) {
  if constexpr (std::is_same_v<S, T>)
    return x;
  else
    return widen<T>(narrow<S>(x));
}

// The arithmetic of a narrow instance (a bf16 / f16 tile S summed at its
// own width): float operands that S represents, each operation done in
// float and rounded to S before its result is used, as torch rounds each
// operation of the plain version at that dtype.  float carries 24 >= 2p + 2
// bits for S's p (8 or 11), so each result is S's correctly rounded
// operation.  The intrinsics are never contracted into an FMA, which would
// skip the rounding of a product.
template <typename S>
__device__ __forceinline__ float nmul(float a, float b) {
  return round_to<S>(__fmul_rn(a, b));
}
template <typename S>
__device__ __forceinline__ float nadd(float a, float b) {
  return round_to<S>(__fadd_rn(a, b));
}
template <typename S>
__device__ __forceinline__ float nsub(float a, float b) {
  return round_to<S>(__fsub_rn(a, b));
}
template <typename S>
__device__ __forceinline__ float ndiv(float a, float b) {
  return round_to<S>(__fdiv_rn(a, b));
}
template <typename S>
__device__ __forceinline__ float nsqrt(float a) {
  return round_to<S>(__fsqrt_rn(a));
}

// 1e-30 at every dtype: the constant of the TPU kernels (ggr_panel.py _EPS).
template <typename T>
__device__ __forceinline__ T eps() { return T(1e-30); }

// Shared-memory slots block_max needs for its partial maxima.
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

}  // namespace ggr
