// Fused GGR panel factorization on Hopper (sm_90a): the fused schedule's
// panel kernel.
//
// Replaces the TPU kernel src/repro/kernels/ggr_panel.py::_panel_kernel
// (entry panel_factor_pallas -> _panel_factor_call -> pl.pallas_call; column
// body _ggr_column_update).
//
// What it computes: for each of B panels (m x b) it annihilates column c below
// pivot row p = pivot0 + c, for every c in 0..b-1 (see ggr_common.cuh for the
// column step), and returns the factored panel R together with the compact
// factors of each step: V[:, c] = the column scaled by its max-abs sigma, zero
// above p, and T[:, c] = its suffix norms (T above p holds t_p).  The
// annihilated column is written exactly as sigma * t_p at the pivot and zeros
// below; an all-zero active column (t_p <= 1e-30) leaves the panel untouched.
// A pivot on the last row is only sign-normalized, one past the end is a no-op.
//
// Bound on this card: the panel is read once and R, V, T are written once,
// 4*B*m*b elements, while column c sweeps its m-p active rows over the b-c-1
// columns right of it at about 5 flops per element, B*sum_c 5*(m-p)*(b-c-1)
// flops.  At the fused frame (4096, 64) f32 that is 4.2 MB (0.0013 ms at 3.35
// TB/s) against 41 MFLOP (0.0006 ms at 67 TFLOP/s), so bytes bound it.  One
// block factors one panel, and a fused frame is one panel: a launch runs on
// one of the card's 132 SMs and so can reach at most 1/132 of that bound.
//
// Design.  The Pallas kernel keeps the whole panel in VMEM; here a (4096, 64)
// f32 panel is 1 MB and an (8192, 64) f64 one 4 MB, far over the 227 KB a
// block may hold, so the panel stays in device memory, where after the first
// touch it lives in the 50 MB L2, and one SM's path to the L2 is what the
// kernel spends.  A column of the row-major panel is strided (one 32-byte
// sector per element), so each column is read that way once and everything
// per column lives in contiguous vectors: v/sigma, k and l in shared memory
// when 3*m of them fit (up to 18 k rows f32, 9 k f64), else in the device
// scratch `work`; v/sigma and t of every column in work as (b, m) planes,
// transposed into V and T (through shared-memory tiles) at the end.  Per
// column the block runs row-chunked reverse scans (ggr_scan.cuh) instead of
// a one-thread coefficient chain:
//   1. sigma, a block max over the active rows, copying the column to a
//      contiguous vector;
//   2. the suffix norms t: chunk partials of (v/sigma)^2, chunk_carry, then a
//      bottom-up walk writing v/sigma and t;
//   3. the coefficients k and l of every active row;
//   4. the DET2 sweep of the b-c-1 columns right of c: chunk partials of the
//      suffix dots P, chunk_carry, then a bottom-up walk that carries P in a
//      register and writes row r from old row r-1.  The exclusive suffix dot
//      S_{r-1} is the inclusive P_r (a shift, never P - prod), and the old
//      row above a chunk (its one-row halo) is read in the partial pass,
//      before the barriers, so no chunk reads a row its neighbour rewrote.
//      Both passes load 8 rows (f32; 4 in f64) at a time, so a walk step
//      waits for the L2 once per group, not once per row.
// The annihilated columns (sigma * t_p at the pivot, zeros below) are written
// in one coalesced pass at the end: no later column step reads them.  Columns
// left of c are zero below their own pivots and are not swept.
#include <cuda_runtime.h>

#include "ggr_common.cuh"
#include "ggr_scan.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 32;  // kTile x kTile transpose tiles (kThreads slots)

// Scratch `work` per panel: t and v/sigma of every column as (b, m) planes,
// sigma per column, then v/sigma, k, l of the current column (3*m; unused
// when they live in shared memory).
template <typename T>
__device__ __forceinline__ size_t work_size(int m, int b) {
  return 2 * (size_t)b * m + b + 3 * (size_t)m;
}

// dst (m x b, row-major) <- column plane src (b x m) for rows r >= pivot0 + c,
// and `above` (0 or t_p) for the rows above each pivot; coalesced both ways
// through a kTile x kTile shared tile.
template <typename T, typename Above>
__device__ void transpose_out(const T* src, T* dst, int m, int b, int pivot0,
                              T* tile, Above above) {
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  for (int r0 = 0; r0 < m; r0 += kTile) {
    for (int c0 = 0; c0 < b; c0 += kTile) {
      const int c = c0 + ty, r = r0 + tx;  // read along r
      if (c < b && r < m)
        tile[ty * (kTile + 1) + tx] = r >= pivot0 + c ? src[(size_t)c * m + r] : above(c);
      __syncthreads();
      const int cw = c0 + tx, rw = r0 + ty;  // write along c
      if (cw < b && rw < m) dst[(size_t)rw * b + cw] = tile[tx * (kTile + 1) + ty];
      __syncthreads();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_factor_kernel(const T* __restrict__ in, T* __restrict__ R, T* __restrict__ V,
                    T* __restrict__ Tn, T* __restrict__ work, int m, int b,
                    int pivot0, int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);  // kThreads scan slots (+ tile pad)
  T* red = part + kThreads + kTile;          // block-reduction slots
  T* cvec = red + ggr::kReduceSlots;         // v/sigma, k, l of the column

  const size_t off = (size_t)blockIdx.x * m * b;
  in += off;
  R += off;
  V += off;
  Tn += off;
  work += blockIdx.x * work_size<T>(m, b);
  T* tplane = work;                  // t of column c at tplane[c * m + r]
  T* vplane = tplane + (size_t)b * m;
  T* sig = vplane + (size_t)b * m;   // sigma of column c
  if (!stage) cvec = sig + b;
  T* vs = cvec;
  T* kk = vs + m;
  T* ll = kk + m;

  for (size_t i = threadIdx.x; i < (size_t)m * b; i += blockDim.x) R[i] = in[i];
  __syncthreads();

  for (int c = 0; c < b; ++c) {
    const int p = pivot0 + c < m ? pivot0 + c : m;  // first active row
    T* tcol = tplane + (size_t)c * m;
    T* vcol = vplane + (size_t)c * m;

    // 1. safe-Givens scale; the column, copied to vs
    T amax = T(0);
    for (int r = p + threadIdx.x; r < m; r += blockDim.x) {
      const T a = R[(size_t)r * b + c];
      vs[r] = a;
      amax = fabs(a) > amax ? fabs(a) : amax;
    }
    const T sigma = ggr::block_max(amax, red);
    const T scale = sigma > T(0) ? sigma : T(1);

    // 2. suffix norms of the scaled column (active rows)
    {
      const ggr::Chunking s = ggr::chunking(1, p, m);
      T acc = T(0);
      for (int r = s.lo; r < s.hi; ++r) {
        const T v = vs[r] / scale;
        acc += v * v;
      }
      T t2 = ggr::chunk_carry(s, acc, part);
      for (int r = s.hi - 1; r >= s.lo; --r) {
        const T v = vs[r] / scale;
        t2 += v * v;
        vs[r] = v;
        vcol[r] = v;
        tcol[r] = sqrt(t2);
      }
    }
    __syncthreads();
    const T tp = p < m ? tcol[p] : T(0);
    if (threadIdx.x == 0) sig[c] = sigma;
    if (!(tp > ggr::eps<T>())) continue;  // do_any (block-uniform): untouched

    // 3. coefficients of the active rows
    for (int r = p + threadIdx.x; r < m; r += blockDim.x)
      ggr::det2_coeffs(vs[r], tcol[r], r + 1 < m ? tcol[r + 1] : T(0), kk[r], ll[r]);
    __syncthreads();

    // 4. DET2 sweep of the columns right of c
    const int nc = b - c - 1;
    if (nc > 0) {
      constexpr int G = ggr::WalkGroup<T>::value;
      const ggr::Chunking s = ggr::chunking(nc, p, m);
      T* col = R + c + 1 + s.jj;  // this thread's column; row r at col[r * b]
      auto x = [=](int r) { return col[r * b]; };  // m * b < 2^31 (wrapper)
      auto v = [=](int r) { return vs[r]; };
      const T acc = ggr::chunk_dot<T, G>(s.lo, s.hi, v, x);
      const T halo = s.lo < s.hi && s.lo > p ? x(s.lo - 1) : T(0);
      const T P = ggr::chunk_carry(s, acc, part);
      ggr::det2_walk<T, G>(
          s.lo, s.hi, p, P, halo, tp, x,
          [=](int r, T val) { col[r * b] = val; }, v,
          [=](int r) { return kk[r]; }, [=](int r) { return ll[r]; });
    }
    __syncthreads();
  }

  // the annihilated columns: sigma * t_p at the pivot, 0 below (do_any only)
  for (size_t i = threadIdx.x; i < (size_t)m * b; i += blockDim.x) {
    const int r = (int)(i / b), c = (int)(i % b);
    const int p = pivot0 + c;
    if (p < m && r >= p) {
      const T tp = tplane[(size_t)c * m + p];
      if (tp > ggr::eps<T>()) R[i] = r == p ? sig[c] * tp : T(0);
    }
  }
  // V and T: the column planes, zero / t_p above each pivot
  auto t_piv = [=](int c) { return pivot0 + c < m ? tplane[(size_t)c * m + pivot0 + c] : T(0); };
  transpose_out(vplane, V, m, b, pivot0, part, [](int) { return T(0); });
  transpose_out(tplane, Tn, m, b, pivot0, part, t_piv);
}

template <typename T>
size_t smem_bytes(int m, int stage) {
  return ((size_t)kThreads + kTile + ggr::kReduceSlots + (stage ? 3 * (size_t)m : 0)) *
         sizeof(T);
}

template <typename T>
int launch(const T* in, T* R, T* V, T* Tn, T* work, int B, int m, int b,
           int pivot0, int stage, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<T>(m, stage);
  err = cudaFuncSetAttribute(panel_factor_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_factor_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      in, R, V, Tn, work, m, b, pivot0, stage);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ggr_panel_factor_f32(const float* in, float* R, float* V, float* Tn,
                         float* work, int B, int m, int b, int pivot0, int stage,
                         int device, void* stream) {
  return launch<float>(in, R, V, Tn, work, B, m, b, pivot0, stage, device, stream);
}

int ggr_panel_factor_f64(const double* in, double* R, double* V, double* Tn,
                         double* work, int B, int m, int b, int pivot0, int stage,
                         int device, void* stream) {
  return launch<double>(in, R, V, Tn, work, B, m, b, pivot0, stage, device, stream);
}

const char* ggr_panel_factor_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
