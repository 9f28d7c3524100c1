// Fused trailing update on Hopper (sm_90a): replay a factored panel's b GGR
// column transforms over trailing columns — the fused schedule's DET2 grid.
//
// Replaces the TPU kernel src/repro/kernels/ggr_apply.py::_apply_kernel
// (entry apply_factors_pallas -> _apply_factors_call -> pl.pallas_call).
//
// What it computes: for each of B problems, given the compact factors (V, T)
// of b column steps ((m x b); V[:, c] the scaled column, T[:, c] its suffix
// norms) and trailing columns C (m x w), it applies step c = 0..b-1 with pivot
// row p = pivot0 + c to every column of C:
//   P_r = sum_{i>=r} v_i C_i   (inclusive suffix dot)
//   row p   <- P_p / t_p
//   row r>p <- valid_{r-1} ? k_{r-1} P_r - l_{r-1} C_{r-1} : C_r
// with k_i = v_i / (t_i t_{i+1}), l_i = t_{i+1} / t_i, valid_i = t_{i+1} > 1e-30,
// recomputed from (v, t).  Rows above p are untouched, and a step with
// t_p <= 1e-30 (or p >= m) changes nothing.
//
// Bound on this card: C is read once and written once and V, T read once,
// (2*m*w + 2*m*b) elements per problem, while step c sweeps m-p active rows of
// all w columns at about 5 flops per element, B*5*w*sum_c (m-p) flops.  At the
// first fused frame (4096, 4032) f32 with b = 64 that is 134 MB (0.040 ms at
// 3.35 TB/s) against 5.2 GFLOP (0.078 ms at 67 TFLOP/s): operations bound it.
//
// Design.  The Pallas kernel holds a (m, block_w) tile of C in VMEM and
// replays all b transforms on it — b-fold reuse.  Here the grid runs over
// (problem, column chunk of cw columns); each block stages its (m - pivot0) x cw
// chunk of C in shared memory, replays all b transforms there and writes it
// back once.  A first pass (coeff_kernel) turns (V, T) into per-row v, k, l
// vectors, contiguous per transform (3*b*m per problem, at most a few MB,
// L2-resident and shared by every block); the validity of each rotation rides
// in the sign of l.  Where they fit beside the chunk, each step's vectors are
// staged in shared memory first (one coalesced copy), so the walks never wait
// on the L2.  cw is chosen by the wrapper from the 227 KB budget (about 10
// columns at 4096 rows f32 with staging; half that in f64) and from the
// number of blocks the card needs.  Per
// transform the block runs the row-chunked reverse scan of ggr_scan.cuh: chunk
// partials of the suffix dots, chunk_carry, and a bottom-up walk carrying P in
// a register; the old row above a chunk (the DET2 shift's one-row halo) is
// read in the partial pass, before chunk_carry's barriers.  The walks load 8
// rows (f32; 4 in f64) at a time.  C and the output
// take a batch stride and a row stride, so the caller may update a strided
// view of a frame in place (out == C).
#include <cuda_runtime.h>

#include "ggr_common.cuh"
#include "ggr_scan.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kCoeffThreads = 256;

// coef[(c*3 + {0,1,2})*m + r] = v, k, l of transform c at row r (l = -1 where
// the rotation is degenerate; see det2_coeffs).
template <typename T>
__global__ void __launch_bounds__(kCoeffThreads)
coeff_kernel(const T* __restrict__ V, const T* __restrict__ Tn,
             T* __restrict__ coef, int m, int b, int pivot0) {
  const int c = blockIdx.y;
  const int p = pivot0 + c;
  const size_t off = (size_t)blockIdx.x * m * b;
  V += off;
  Tn += off;
  T* vs = coef + ((size_t)blockIdx.x * b + c) * 3 * m;
  T* kk = vs + m;
  T* ll = kk + m;
  for (int r = p + (int)threadIdx.x; r < m; r += blockDim.x) {
    const T v = V[(size_t)r * b + c];
    vs[r] = v;
    ggr::det2_coeffs(v, Tn[(size_t)r * b + c],
                     r + 1 < m ? Tn[(size_t)(r + 1) * b + c] : T(0), kk[r], ll[r]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ Tn, const T* C, T* out,
             const T* __restrict__ coef, int m, int b, int w, int pivot0,
             int cw, int stage, int c_bstride, int c_rstride, int o_bstride,
             int o_rstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);  // kThreads scan slots
  T* cstage = part + kThreads;               // v, k, l of a step (3 x n0, if stage)

  const int j0 = blockIdx.y * cw;
  const int ncol = w - j0 < cw ? w - j0 : cw;
  const int r0 = pivot0 < m ? pivot0 : m;  // rows above r0 are untouched
  const int n0 = m - r0;
  T* X = cstage + (stage ? 3 * (size_t)n0 : 0);  // n0 x ncol chunk of C
  const T* src = C + (size_t)blockIdx.x * c_bstride + j0;
  T* dst = out + (size_t)blockIdx.x * o_bstride + j0;
  Tn += (size_t)blockIdx.x * m * b;
  const T* cb = coef + (size_t)blockIdx.x * b * 3 * m;

  if (src != dst)
    for (int i = threadIdx.x; i < r0 * ncol; i += blockDim.x)
      dst[(size_t)(i / ncol) * o_rstride + i % ncol] =
          src[(size_t)(i / ncol) * c_rstride + i % ncol];
  for (int i = threadIdx.x; i < n0 * ncol; i += blockDim.x)
    X[i] = src[(size_t)(r0 + i / ncol) * c_rstride + i % ncol];
  __syncthreads();

  for (int c = 0; c < b; ++c) {
    const int p = pivot0 + c;
    if (p >= m) break;  // this and every later step is a no-op
    const T tp = Tn[(size_t)p * b + c];
    if (!(tp > ggr::eps<T>())) continue;  // do_any (block-uniform)
    // v, k, l of this step: staged in shared memory when they fit, else
    // read from the L2-resident coef; row r at vs[r - off]
    const T* vs = cb + (size_t)c * 3 * m;
    int off = 0;
    if (stage) {
      for (int r = p + threadIdx.x; r < m; r += blockDim.x)
        for (int a = 0; a < 3; ++a) cstage[a * n0 + r - r0] = vs[(size_t)a * m + r];
      __syncthreads();
      vs = cstage;
      off = r0;
    }
    const int cm = stage ? n0 : m;  // distance between the v, k, l vectors
    const T* kk = vs + cm;
    const T* ll = kk + cm;

    constexpr int G = ggr::WalkGroup<T>::value;
    const ggr::Chunking s = ggr::chunking(ncol, p, m);
    T* col = X + s.jj;  // row r of this column: col[(r - r0) * ncol]
    auto x = [=](int r) { return col[(r - r0) * ncol]; };  // < 227 KB: int
    auto v = [=](int r) { return vs[r - off]; };
    const T acc = ggr::chunk_dot<T, G>(s.lo, s.hi, v, x);
    const T halo = s.lo < s.hi && s.lo > p ? x(s.lo - 1) : T(0);
    const T P = ggr::chunk_carry(s, acc, part);
    ggr::det2_walk<T, G>(
        s.lo, s.hi, p, P, halo, tp, x,
        [=](int r, T val) { col[(r - r0) * ncol] = val; }, v,
        [=](int r) { return kk[r - off]; }, [=](int r) { return ll[r - off]; });
    __syncthreads();  // the next step's partial pass reads every chunk's rows
  }

  for (int i = threadIdx.x; i < n0 * ncol; i += blockDim.x)
    dst[(size_t)(r0 + i / ncol) * o_rstride + i % ncol] = X[i];
}

template <typename T>
size_t smem_bytes(int m, int pivot0, int cw, int stage) {
  const size_t n0 = m - (pivot0 < m ? pivot0 : m);
  return ((size_t)kThreads + n0 * (cw + (stage ? 3 : 0))) * sizeof(T);
}

template <typename T>
int launch(const T* V, const T* Tn, const T* C, T* out, T* coef, int B, int m,
           int b, int w, int pivot0, int cw, int stage, int c_bstride,
           int c_rstride, int o_bstride, int o_rstride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  coeff_kernel<T><<<dim3(B, b), kCoeffThreads, 0, st>>>(V, Tn, coef, m, b, pivot0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<T>(m, pivot0, cw, stage);
  err = cudaFuncSetAttribute(apply_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (w + cw - 1) / cw;
  apply_kernel<T><<<dim3(B, nblk), kThreads, smem, st>>>(
      Tn, C, out, coef, m, b, w, pivot0, cw, stage, c_bstride, c_rstride,
      o_bstride, o_rstride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ggr_apply_factors_f32(const float* V, const float* Tn, const float* C,
                          float* out, float* coef, int B, int m, int b, int w,
                          int pivot0, int cw, int stage, int c_bstride,
                          int c_rstride, int o_bstride, int o_rstride, int device,
                          void* stream) {
  return launch<float>(V, Tn, C, out, coef, B, m, b, w, pivot0, cw, stage,
                       c_bstride, c_rstride, o_bstride, o_rstride, device, stream);
}

int ggr_apply_factors_f64(const double* V, const double* Tn, const double* C,
                          double* out, double* coef, int B, int m, int b, int w,
                          int pivot0, int cw, int stage, int c_bstride,
                          int c_rstride, int o_bstride, int o_rstride, int device,
                          void* stream) {
  return launch<double>(V, Tn, C, out, coef, B, m, b, w, pivot0, cw, stage,
                        c_bstride, c_rstride, o_bstride, o_rstride, device, stream);
}

const char* ggr_apply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
