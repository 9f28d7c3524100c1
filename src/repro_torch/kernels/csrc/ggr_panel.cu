// Batched dense GEQRT sweep on Hopper (sm_90a): the blocked driver's tile kernel.
//
// Replaces the TPU kernel src/repro/kernels/ggr_panel.py::_batched_geqrt_kernel
// (entry batched_geqrt_pallas -> _batched_geqrt_call -> pl.pallas_call).
//
// What it computes: for each of B tiles ((t x w), all t rows active) it
// triangularizes the first n_piv columns, pivot row c for column c (see
// ggr_common.cuh for the column step); the remaining columns ride along, so a
// tile [T | I] comes back as [R | Qt].  The annihilated column is written
// exactly as sigma*t_c at the pivot and zeros below.
//
// Bound on this card: a tile is read once and written once, 2*B*t*w elements,
// while column c sweeps its t-c active rows over the w-c-1 columns right of it
// (columns left of c are already zero) at about 5 flops per element, so the
// work is B*sum_c (5*(t-c)*(w-c-1) + (w-c-1) + 8*(t-c)) flops.  At the tree
// schedule's level-0 shape (t = b = 64, w = 2b) that is 17 flops per byte in
// f32 and 8.6 in f64, under the H100's ridge of 20 and 10 (67 / 34 TFLOP/s
// over 3.35 TB/s), so bytes bound it.  The design reads and writes each element once:
// the whole tile is staged in shared memory (64 KB at b = 64 in f64) and
// swept there column after column; each thread owns one output column, so the
// global loads and stores are coalesced.  The per-column serial coefficient
// chain (one thread, t-c rows) and the block barriers around it are the
// latency this first version leaves in place.
//
// Layout: one thread block per tile, blockDim = w rounded up to 32.  Per
// column: a block reduction gives sigma, one thread runs the coefficient
// chain, every thread sweeps its column.  Dynamic shared memory: t*w tile
// elements, 4*t coefficient slots, 32 reduction slots and t_c.
#include <cuda_runtime.h>

#include "ggr_common.cuh"

namespace {

template <typename T>
__global__ void batched_geqrt_kernel(const T* __restrict__ in, T* __restrict__ out,
                                     int t, int w, int n_piv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* X = reinterpret_cast<T*>(smem_raw);  // t x w tile
  T* vs = X + (size_t)t * w;
  T* kk = vs + t;
  T* ll = kk + t;
  T* vd = ll + t;
  T* red = vd + t;  // block-reduction slots
  T* tc_slot = red + ggr::kReduceSlots;

  const T* src = in + (size_t)blockIdx.x * t * w;
  T* dst = out + (size_t)blockIdx.x * t * w;
  const int j = threadIdx.x;
  const bool active = j < w;

  if (active)
    for (int i = 0; i < t; ++i) X[(size_t)i * w + j] = src[(size_t)i * w + j];

  const int steps = n_piv < t ? n_piv : t;
  for (int c = 0; c < steps; ++c) {
    __syncthreads();  // the chain reads column c of every thread's last sweep
    const int n = t - c;  // active rows c..t-1; rows above c are untouched
    const T* piv = X + (size_t)c * w + c;
    const T sigma = ggr::block_absmax(piv, w, n, red);
    if (j == 0) *tc_slot = ggr::column_coeffs(piv, w, n, sigma, vs, kk, ll, vd);
    __syncthreads();
    const T tc = *tc_slot;
    if (active && tc > ggr::eps<T>()) {  // do_any: else the tile is left untouched
      T* col = X + (size_t)c * w + j;
      if (j == c) {
        col[0] = sigma * tc;  // annihilated column: sigma*t at the pivot, 0 below
        for (int i = 1; i < n; ++i) col[(size_t)i * w] = T(0);
      } else {
        col[0] = ggr::sweep_column(col, w, n, vs, kk, ll, vd) / tc;
      }
    }
  }
  __syncthreads();

  if (active)
    for (int i = 0; i < t; ++i) dst[(size_t)i * w + j] = X[(size_t)i * w + j];
}

template <typename T>
size_t smem_bytes(int t, int w) {
  return ((size_t)t * w + 4 * (size_t)t + ggr::kReduceSlots + 1) * sizeof(T);
}

template <typename T>
int launch(const T* in, T* out, int B, int t, int w, int n_piv, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<T>(t, w);
  err = cudaFuncSetAttribute(batched_geqrt_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (w + 31) / 32 * 32;
  batched_geqrt_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(in, out, t, w, n_piv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ggr_batched_geqrt_f32(const float* in, float* out, int B, int t, int w,
                          int n_piv, int device, void* stream) {
  return launch<float>(in, out, B, t, w, n_piv, device, stream);
}

int ggr_batched_geqrt_f64(const double* in, double* out, int B, int t, int w,
                          int n_piv, int device, void* stream) {
  return launch<double>(in, out, B, t, w, n_piv, device, stream);
}

const char* ggr_panel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
