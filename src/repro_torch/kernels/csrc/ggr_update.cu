// Batched row-append GGR sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ggr_update.py::_batched_update_kernel
// (entry batched_update_pallas -> _batched_update_call -> pl.pallas_call).
//
// What it computes: for each of B stacked problems X = [R | d; U | Y]
// ((n_piv + p) x w, R upper triangular) it triangularizes the first n_piv
// columns.  Per column c only the (p+1)-row active set — pivot row c plus the
// p appended rows — is swept (see ggr_common.cuh); the column is written
// exactly as sigma*t_0 at the pivot and zeros below, and rhs columns ride along.
//
// Bound on this card: each problem is read once and written once, 2*B*m*w
// elements.  Column c sweeps its p+1 active rows over the w-c-1 columns right
// of it (columns left of c are already zero), about 5 flops per element, so
// the work is B*sum_c (5*(p+1)*(w-c-1) + (w-c-1) + 8*(p+1)) flops.  That is
// 2.5 flops per byte at the serving append shape (40 x 33, f32), 8.3 at the
// kalman shape (104 x 65, f32) and 17 / 8.6 at the tree-coupling shape
// (128 x 192, b = 64) in f32 / f64: all under the H100's ridge of 20 f32 and
// 10 f64 flops per byte (67 and 34 TFLOP/s over 3.35 TB/s), so the kernel is
// bound by bytes at every main-path shape.  The design moves each element the
// least possible: the p appended rows plus the current pivot row stay
// resident in shared memory for the whole sweep, the top n_piv rows are
// streamed from device memory (each is touched once, at its own column), and
// each thread owns one column so loads and stores are coalesced across the
// block.  What this simple design does not hide is the per-column serial
// coefficient chain (one thread, p+1 rows) and the block barriers around it:
// with one block per problem and few threads per block, latency rather than
// bandwidth is what a later change has to attack.
//
// Layout: one thread block per problem, blockDim = w rounded up to 32, one
// thread per output column.  Per column: a block reduction gives sigma, one
// thread runs the coefficient chain, every thread sweeps its column.
// Dynamic shared memory: (p+1)*w tile rows, 4*(p+1) coefficient slots, 32
// reduction slots and t_0.
#include <cuda_runtime.h>

#include "ggr_common.cuh"

namespace {

template <typename T>
__global__ void batched_update_kernel(const T* __restrict__ in, T* __restrict__ out,
                                      int m, int w, int n_piv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p = m - n_piv;
  T* A = reinterpret_cast<T*>(smem_raw);  // (p+1) x w: pivot row + appended rows
  T* vs = A + (size_t)(p + 1) * w;
  T* kk = vs + (p + 1);
  T* ll = kk + (p + 1);
  T* vd = ll + (p + 1);
  T* red = vd + (p + 1);  // block-reduction slots
  T* t0_slot = red + ggr::kReduceSlots;

  const T* X = in + (size_t)blockIdx.x * m * w;
  T* Y = out + (size_t)blockIdx.x * m * w;
  const int j = threadIdx.x;
  const bool active = j < w;

  if (active)
    for (int i = 0; i < p; ++i) A[(size_t)(i + 1) * w + j] = X[(size_t)(n_piv + i) * w + j];

  for (int c = 0; c < n_piv; ++c) {
    if (active) A[j] = X[(size_t)c * w + j];  // pivot row c, read once
    __syncthreads();
    const T sigma = ggr::block_absmax(A + c, w, p + 1, red);
    if (j == 0) *t0_slot = ggr::column_coeffs(A + c, w, p + 1, sigma, vs, kk, ll, vd);
    __syncthreads();
    const T t0 = *t0_slot;
    if (active) {
      T row0 = A[j];
      if (t0 > ggr::eps<T>()) {  // do_any: else the problem is left untouched
        if (j == c) {
          row0 = sigma * t0;  // annihilated column: sigma*t at the pivot, 0 below
          for (int i = 1; i <= p; ++i) A[(size_t)i * w + j] = T(0);
        } else {
          row0 = ggr::sweep_column(A + j, w, p + 1, vs, kk, ll, vd) / t0;
        }
      }
      Y[(size_t)c * w + j] = row0;
    }
    __syncthreads();  // the next column's chain reads every thread's rows
  }

  if (active)
    for (int i = 0; i < p; ++i) Y[(size_t)(n_piv + i) * w + j] = A[(size_t)(i + 1) * w + j];
}

template <typename T>
size_t smem_bytes(int m, int w, int n_piv) {
  const size_t rows = (size_t)(m - n_piv) + 1;
  return (rows * w + 4 * rows + ggr::kReduceSlots + 1) * sizeof(T);
}

template <typename T>
int launch(const T* in, T* out, int B, int m, int w, int n_piv, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<T>(m, w, n_piv);
  err = cudaFuncSetAttribute(batched_update_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (w + 31) / 32 * 32;
  batched_update_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(in, out, m, w, n_piv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ggr_batched_update_f32(const float* in, float* out, int B, int m, int w,
                           int n_piv, int device, void* stream) {
  return launch<float>(in, out, B, m, w, n_piv, device, stream);
}

int ggr_batched_update_f64(const double* in, double* out, int B, int m, int w,
                           int n_piv, int device, void* stream) {
  return launch<double>(in, out, B, m, w, n_piv, device, stream);
}

const char* ggr_update_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
