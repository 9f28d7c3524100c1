// Batched dense GEQRT sweep on Hopper (sm_90a): the blocked driver's tile kernel.
//
// Replaces the TPU kernel src/repro/kernels/ggr_panel.py::_batched_geqrt_kernel
// (entry batched_geqrt_pallas -> _batched_geqrt_call -> pl.pallas_call).
//
// What it computes: for each of B tiles ((t x w), all t rows active) it
// triangularizes the first n_piv columns, pivot row c for column c (see
// ggr_common.cuh for the column step); the remaining columns ride along, so a
// tile [T | I] comes back as [R | Qt].  The annihilated column is written
// exactly as sigma*t_0 at the pivot and zeros below; a column that is zero
// from its pivot down leaves the tile bitwise as it was.
//
// Bound on this card: a tile is read once and written once, 2*B*t*w elements,
// while column c sweeps its t-c active rows over the w-c-1 columns right of it
// (columns left of c are already zero) at about 5 flops per element, so the
// work is B*sum_c (5*(t-c)*(w-c-1) + (w-c-1) + 8*(t-c)) flops
// (core/counts.py::geqrt_flops).  At the tree schedule's level-0 shape (t = b
// = 64, w = 2b) that is 17 flops per byte in f32 and 8.6 in f64, under the
// H100's ridge of 20 and 10 (67 / 34 TFLOP/s over 3.35 TB/s), so bytes bound
// it.  Each element is read from device memory once and written once: the
// tile is staged in shared memory, and each pivot row is stored at its own
// step (it is final once its column is annihilated), the rows past the last
// pivot at the end.
//
// What bounds it in practice is latency: a launch of the tree schedule holds
// at most 128 tiles, one block each, so it lasts as long as one tile's chain
// of column steps, and a step is a chain of dependent phases (max-abs,
// suffix norms, coefficients, suffix dots, DET2).  The design shortens each
// phase (B1's column step, ggr_warp.cuh):
//
//   * No serial coefficient chain: one warp computes column c's
//     coefficients with the active rows over its lanes (coeff_chain: a
//     shuffle max, a reverse shuffle scan with carries for the suffix norms,
//     each row's t computed once).  A zero column (sigma == 0, as in every
//     [0 | I] tile the tree pads with) stops after the max: the step is
//     skipped and the tile stays as it was.
//   * Only the w-c-1 columns right of c are swept: the columns left of c are
//     zero in the active rows (this kernel annihilated them), and the pivot
//     row keeps its values there.
//   * Each thread walks whole columns bottom-up (column_walk: each row's
//     (v, k, l) in one 16-byte record, four rows' loads ahead of their
//     stores).  Walks of row chunks from the carry of the chunks below (as
//     the panel kernel walks its slabs) were slower at every main-path
//     shape: a tile has at most 64 active rows there (PERF.md §6).
//   * The layout (threads G = blockDim, a thread a swept column, and the
//     row stride ws) comes from the tile's shape
//     (ggr_panel.py::_geqrt_layout), never from B, so a tile's bits do not
//     depend on its batch.
//
// Mixed precision: the bf16 / f16 instances (storage S, compute float) keep
// the float instance's layout (shared memory holds T values, so
// ggr_panel.py::_geqrt_layout takes the compute itemsize) and round the
// state as the JAX kernel does, at every column step: each DET2 row written
// back to shared memory, the pivot row P_c / t_c and the annihilated
// column's sigma * t_c go through S at the step that writes them
// (column_walk, narrow); v, sigma, the suffix norms and dots and k, l are
// float.  0 and 1 are exact in both tile dtypes, so the tree's [0 | I]
// tiles still come back bitwise as they were.  The wide instances (f32 /
// bf16 / f16 tiles, double sums: ggr_common.cuh) are the same code at T =
// double, shared memory at 8 bytes a value.
//
// Narrow instances (bf16 / f16 tiles summed at their own width, the
// plain version at (tile, tile)): T = float with every operation rounded to
// S (ggr_warp.cuh, coeff_chain_narrow and column_walk_narrow), each suffix
// sum in the ladder's order over the tile's t rows, as the plain version and
// the TPU kernel sum a column with zeros above its pivot.  Each thread keeps
// t floats of scratch for its column's suffix dots after the tile, row r of
// thread tid at [r * G + tid] (ggr_panel.py::_geqrt_layout(narrow=True)).
//
// Per column step the block passes two barriers (column c in place; the
// coefficients in place).  Dynamic shared memory (elements, tile_elems): a
// record for each of the t rows, the tile at row stride ws (w rounded up to
// odd where it fits: the coefficient warp reads a column down the rows),
// sigma and t_0.
#include <cuda_runtime.h>

#include "ggr_common.cuh"
#include "ggr_warp.cuh"

namespace {

// Elements of shared memory one tile takes, mirrored by
// ggr_panel.py::_geqrt_smem, a narrow instance's scratch last.  The records
// come first, so they are 16-byte aligned.
__host__ __device__ __forceinline__ size_t tile_elems(int t, int ws, size_t scratch) {
  return 4 * (size_t)t + (size_t)t * ws + 2 + scratch;
}

// Rows of the tile a thread loads together before storing them.
constexpr int kLoadGroup = 16;

// N: a narrow instance (T = float).
template <typename S, typename T, bool N>
__global__ void __launch_bounds__(512)
batched_geqrt_kernel(const S* __restrict__ in, S* __restrict__ out, int t, int w,
                     int n_piv, int ws) {
  static_assert(!N || std::is_same_v<T, float>, "a narrow instance holds floats");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ggr::Rec<T>* rec = reinterpret_cast<ggr::Rec<T>*>(smem_raw);
  T* X = reinterpret_cast<T*>(smem_raw) + 4 * (size_t)t;  // row i at X[i * ws]
  T* slot = X + (size_t)t * ws;                            // sigma, t_0
  const int G = (int)blockDim.x, tid = (int)threadIdx.x;
  [[maybe_unused]] T* scr = slot + 2 + tid;  // a narrow instance's suffix dots
  const S* src = in + (size_t)blockIdx.x * t * w;
  S* Y = out + (size_t)blockIdx.x * t * w;

  // the tile into shared memory, kLoadGroup loads in flight a thread
  const int total = t * w;
  int e = tid;
  for (; e + (kLoadGroup - 1) * G < total; e += kLoadGroup * G) {
    S v[kLoadGroup];
#pragma unroll
    for (int q = 0; q < kLoadGroup; ++q) v[q] = src[e + q * G];
#pragma unroll
    for (int q = 0; q < kLoadGroup; ++q) {
      const int f = e + q * G, i = f / w;
      X[(size_t)i * ws + (f - i * w)] = ggr::widen<T>(v[q]);
    }
  }
  for (; e < total; e += G) {
    const int i = e / w;
    X[(size_t)i * ws + (e - i * w)] = ggr::widen<T>(src[e]);
  }

  const int steps = n_piv < t ? n_piv : t;
  for (int c = 0; c < steps; ++c) {
    const int n = t - c;  // active rows c..t-1; the rows above are final
    T* top = X + (size_t)c * ws;
    __syncthreads();  // column c and the last step's rows in place
    if (tid < 32) {
      auto col = [&](int i) { return top[(size_t)i * ws + c]; };
      if constexpr (N)
        ggr::coeff_chain_narrow<S>(tid, n, col, rec, slot);
      else
        ggr::coeff_chain(tid, n, col, rec, slot);
    }
    __syncthreads();  // coefficients, sigma and t_0 in place
    const T sigma = slot[0], t0 = slot[1];
    S* Yc = Y + (size_t)c * w;
    if (!(t0 > ggr::eps<T>())) {  // do_any false: the tile stays as it is
      for (int j = tid; j < w; j += G) Yc[j] = ggr::narrow<S>(top[j]);
      continue;
    }
    for (int j = c + 1 + tid; j < w; j += G) {
      if constexpr (N)
        ggr::column_walk_narrow<S>(n, t, top + ws + j, ws, top[j], rec, t0, Yc + j, scr, G);
      else
        ggr::column_walk<S, T, 4>(n, top + ws + j, ws, top[j], rec, t0, Yc + j);
    }
    // the annihilated column: sigma*t_0 at the pivot, zeros below; the pivot
    // row keeps its values left of c
    for (int r = c + 1 + tid; r < t; r += G) X[(size_t)r * ws + c] = T(0);
    for (int j = tid; j <= c; j += G) Yc[j] = ggr::narrow<S>(j == c ? sigma * t0 : top[j]);
  }

  __syncthreads();
  for (int e2 = steps * w + tid; e2 < total; e2 += G) {  // rows past the last pivot
    const int i = e2 / w;
    Y[e2] = ggr::narrow<S>(X[(size_t)i * ws + (e2 - i * w)]);
  }
}

template <typename S, typename T, bool N = false>
int launch(const S* in, S* out, int B, int t, int w, int n_piv, int G, int ws,
           int device, void* stream) {
  if (G < 32 || G % 32 || G > 512 || ws < w || t < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = tile_elems(t, ws, N ? (size_t)t * G : 0) * sizeof(T);
  err = cudaFuncSetAttribute(batched_geqrt_kernel<S, T, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  batched_geqrt_kernel<S, T, N><<<B, G, smem, (cudaStream_t)stream>>>(in, out, t, w,
                                                                     n_piv, ws);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ggr_batched_geqrt_f32(const float* in, float* out, int B, int t, int w, int n_piv,
                          int G, int ws, int device, void* stream) {
  return launch<float, float>(in, out, B, t, w, n_piv, G, ws, device, stream);
}

int ggr_batched_geqrt_f64(const double* in, double* out, int B, int t, int w,
                          int n_piv, int G, int ws, int device, void* stream) {
  return launch<double, double>(in, out, B, t, w, n_piv, G, ws, device, stream);
}

int ggr_batched_geqrt_bf16_f32(const __nv_bfloat16* in, __nv_bfloat16* out, int B, int t,
                               int w, int n_piv, int G, int ws, int device, void* stream) {
  return launch<__nv_bfloat16, float>(in, out, B, t, w, n_piv, G, ws, device, stream);
}

int ggr_batched_geqrt_f16_f32(const __half* in, __half* out, int B, int t, int w,
                              int n_piv, int G, int ws, int device, void* stream) {
  return launch<__half, float>(in, out, B, t, w, n_piv, G, ws, device, stream);
}

int ggr_batched_geqrt_f32_f64(const float* in, float* out, int B, int t, int w,
                              int n_piv, int G, int ws, int device, void* stream) {
  return launch<float, double>(in, out, B, t, w, n_piv, G, ws, device, stream);
}

int ggr_batched_geqrt_bf16_f64(const __nv_bfloat16* in, __nv_bfloat16* out, int B, int t,
                               int w, int n_piv, int G, int ws, int device, void* stream) {
  return launch<__nv_bfloat16, double>(in, out, B, t, w, n_piv, G, ws, device, stream);
}

int ggr_batched_geqrt_f16_f64(const __half* in, __half* out, int B, int t, int w,
                              int n_piv, int G, int ws, int device, void* stream) {
  return launch<__half, double>(in, out, B, t, w, n_piv, G, ws, device, stream);
}

int ggr_batched_geqrt_bf16(const __nv_bfloat16* in, __nv_bfloat16* out, int B, int t,
                           int w, int n_piv, int G, int ws, int device, void* stream) {
  return launch<__nv_bfloat16, float, true>(in, out, B, t, w, n_piv, G, ws, device, stream);
}

int ggr_batched_geqrt_f16(const __half* in, __half* out, int B, int t, int w, int n_piv,
                          int G, int ws, int device, void* stream) {
  return launch<__half, float, true>(in, out, B, t, w, n_piv, G, ws, device, stream);
}

const char* ggr_panel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
