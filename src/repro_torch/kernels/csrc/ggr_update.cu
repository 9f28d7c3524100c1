// Batched row-append GGR sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ggr_update.py::_batched_update_kernel
// (entry batched_update_pallas -> _batched_update_call -> pl.pallas_call).
//
// What it computes: for each of B stacked problems X = [R | d; U | Y]
// ((n_piv + p) x w, R upper triangular) it triangularizes the first n_piv
// columns.  Per column c only the (p+1)-row active set — pivot row c plus the
// p appended rows — is swept (see ggr_common.cuh for the column step); the
// column is written exactly as sigma*t_0 at the pivot and zeros below, and
// rhs columns ride along.  An all-zero problem comes back bitwise zero.
//
// Bound on this card: each problem is read once and written once, 2*B*m*w
// elements.  Column c sweeps its p+1 active rows over the w-c-1 columns right
// of it (columns left of c are already zero), about 5 flops per element, so
// the work is B*sum_c (5*(p+1)*(w-c-1) + (w-c-1) + 8*(p+1)) flops
// (core/counts.py::update_flops).  That is 2.5 flops per byte at the serving
// append shape (40 x 33, f32), 8.3 at the kalman shape (104 x 65, f32) and
// 17 / 8.6 at the tree-coupling shape (128 x 192, 64 pivots) in f32 / f64:
// all under the H100's ridge of 20 f32 and 10 f64 flops per byte (67 and 34
// TFLOP/s over 3.35 TB/s), so bytes bound the kernel at every main-path shape.
// Each element is read from device memory once and written once: the p
// appended rows stay in shared memory for the whole sweep, and each pivot row
// is fetched once, a column step ahead (cp.async into the second of two pivot
// buffers), and written once, at its own step.
//
// What bounds it in practice is latency and instruction count: a column
// step is a chain of dependent phases (max-abs, suffix norms, coefficients,
// suffix dots, DET2) and a problem is small.  The design attacks both:
//
//   * No serial coefficient chain.  One warp computes column c's
//     coefficients (ggr_warp.cuh::coeff_chain, shared with the tile GEQRT
//     kernel) with its active rows split over the lanes (lane L holds
//     rows [L*R, L*R+R), R = ceil((p+1)/32)): sigma by a shuffle max; the
//     suffix sums of squares by a reverse inclusive shuffle scan of the
//     lanes' partial sums (the carry from the lanes below), then each lane
//     walks its rows bottom-up from its carry for t_i; t of the row below a
//     lane's last row comes from the next lane by one shuffle, so every row's
//     t is computed once; each lane then forms k_i and l_i for its own rows
//     (ggr_scan.cuh::det2_coeffs, l_i = -1 where invalid).  t_0, and so
//     do_any = t_0 > 1e-30, is one value in shared memory for the problem.
//   * Only the w-c-1 columns right of c are swept: columns left of c are
//     zero in every active row (R is upper triangular, and every earlier
//     column was annihilated), so they keep their zeros, and the pivot row
//     keeps its own values there.
//   * A thread layout chosen by shape (ggr_update.py::_update_layout, from
//     m, w, n_piv, the dtype and the card's limits, never from B): G threads
//     (a multiple of 32) work on one problem, PB problems share a block, and
//     each thread walks whole columns (column_walk), its loads four rows
//     ahead of its stores.  The serving shapes (thousands of problems, bound
//     by instruction issue) take one warp a problem at append (33 columns),
//     two at kalman (65), several problems a block; the tree coupling (65 x
//     192, 1-64 problems a launch, bound by latency) takes a block of 192
//     threads, one a column.  The kernel is launch-bounded at 512 threads a
//     block, so a thread may hold 128 registers: enough to keep a group of
//     rows' loads in flight.  A group of one warp synchronizes with
//     __syncwarp only; a larger group with its own named barrier (bar.sync
//     1+g, G), never the whole block.
//   * The bits of a problem depend only on its shape: the same layout and the
//     same order run whatever B is or where the problem sits in the batch.
//
// Per column step a group passes two barriers (pivot row in place; the
// coefficients in place).  Dynamic shared memory per problem (elements): a
// record (v, k, l) for each of the p+1 active rows, nbuf pivot rows and p
// appended rows of stride ws (w rounded up to odd when it fits: the
// coefficient warp reads a column down the rows), sigma and t_0.  Where two
// pivot buffers and the padded stride do not fit, nbuf = 1 and ws = w: the
// pivot row is then loaded at the start of its step (the parent kernel's
// footprint).
//
// Mixed precision: the bf16 / f16 instances (storage S, compute float) keep
// the layout and the schedule of the float instance (shared memory holds T
// values, so the layout takes T's size: ggr_update.py::_update_layout is
// given the compute itemsize).  The state rounds as the JAX kernel rounds
// it, at every column step: each DET2 row written back to shared memory,
// the pivot row P_0 / t_0 and the annihilated column's sigma * t_0 go
// through S at the step that writes them (column_walk, narrow), so shared
// memory only ever holds values of the tile dtype; v, sigma, the suffix
// norms and dots and k, l are float.  cp.async copies bytes and cannot
// convert, so a mixed instance loads the next pivot row through registers
// instead: each thread issues its (at most two) loads where the float
// instance issues its cp.async, before the coefficient chain, and widens
// them into the other pivot buffer after the sweep (the launch refuses a
// layout that would give a thread more than two).  The wide instances
// (f32 / bf16 / f16 tiles, double sums: ggr_common.cuh) are the same code at
// T = double: shared memory holds doubles (8 bytes a value, so fewer
// problems share a block), the next pivot row goes through registers as in
// a mixed instance, and every write to the state rounds through S once
// (bf16 through float, as XLA rounds).
//
// Narrow instances (bf16 / f16 tiles summed at their own width, the
// plain version at (tile, tile)): T = float with every operation rounded to
// S (ggr_warp.cuh, coeff_chain_narrow and column_walk_narrow), each suffix
// sum in the ladder's order.  A thread's column needs its n suffix dots at
// once (the ladder runs over all of them before the DET2 rows), so each
// thread keeps n floats of scratch after the problem's region, row r of
// thread tid at [r * G + tid]: G * n more elements a problem
// (ggr_update.py::_update_layout(narrow=True)).  The ladder costs up to
// log2(n) rounded adds a row where the serial walk costs one.
//
// Every shared access stays inside its problem's region: records 0..n-1 only
// (coefficients of row i+1 are written only where i+1 < n), pivot-row and
// appended-row columns below w <= ws, appended rows 1..n-1 only (a walk's
// look-ahead stops at row 1 and takes the pivot row above it; the
// coefficient warp clamps a lane's unused row slots to row n-1 rather than
// loading past the last row and masking), and each region a multiple of 16
// bytes, so every record is 16-byte aligned.
#include <cuda_runtime.h>

#include "ggr_common.cuh"
#include "ggr_warp.cuh"

namespace {

// Elements of shared memory one problem takes, a multiple of 4 so that every
// problem's records stay 16-byte aligned (mirrored by
// ggr_update.py::_smem_elems): the n active rows' records, nbuf pivot rows
// and n - 1 appended rows of stride ws, sigma and t_0, then a narrow
// instance's scratch.
__host__ __device__ __forceinline__ size_t group_elems(int n, int ws, int nbuf,
                                                      size_t scratch) {
  const size_t e = 4 * (size_t)n + (size_t)(nbuf + n - 1) * ws + 2 + scratch;
  return (e + 3) / 4 * 4;
}

// The G threads of group g meet: one warp by __syncwarp, more by named
// barrier 1+g (0 is __syncthreads').
__device__ __forceinline__ void group_sync(int g, int G) {
  if (G == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(G) : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"((int)sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Pivot-row elements a thread of a mixed instance holds in registers.
constexpr int kNextRegs = 2;

// Every thread walks whole columns (column_walk), w - c - 1 of them over the
// G threads of a problem.  N: a narrow instance (T = float).
template <typename S, typename T, bool N>
__global__ void __launch_bounds__(512)
batched_update_kernel(const S* __restrict__ in, S* __restrict__ out, int B,
                      int m, int w, int n_piv, int G, int ws, int nbuf) {
  constexpr bool kSame = std::is_same_v<S, T>;
  static_assert(!N || std::is_same_v<T, float>, "a narrow instance holds floats");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p = m - n_piv;
  const int n = p + 1;  // active rows: the pivot row, then the appended rows
  const int g = (int)threadIdx.x / G;
  const int tid = (int)threadIdx.x - g * G;
  const size_t prob = (size_t)blockIdx.x * (blockDim.x / G) + g;
  if (prob >= (size_t)B) return;  // the whole group leaves together

  T* base = reinterpret_cast<T*>(smem_raw) +
            g * group_elems(n, ws, nbuf, N ? (size_t)n * G : 0);
  ggr::Rec<T>* rec = reinterpret_cast<ggr::Rec<T>*>(base);
  T* piv = base + 4 * n;
  T* A = piv + nbuf * ws;  // active rows 1..p at A[(r-1)*ws]
  T* slot = A + p * ws;    // sigma, t_0
  [[maybe_unused]] T* scr = slot + 2 + tid;  // a narrow instance's suffix dots
  const S* X = in + prob * m * w;
  S* Y = out + prob * m * w;

  for (int e = tid; e < p * w; e += G) {
    const int i = e / w, j = e - i * w;
    A[i * ws + j] = ggr::widen<T>(X[(size_t)(n_piv + i) * w + j]);
  }
  for (int j = tid; j < w; j += G) piv[j] = ggr::widen<T>(X[j]);
  [[maybe_unused]] S nx[kNextRegs];  // a mixed instance's next pivot row, in flight

  for (int c = 0; c < n_piv; ++c) {
    T* row0 = piv + (nbuf == 2 ? (c & 1) * ws : 0);
    if (nbuf == 1 && c > 0) {
      group_sync(g, G);  // every read of the last pivot row is done
      for (int j = tid; j < w; j += G) row0[j] = ggr::widen<T>(X[(size_t)c * w + j]);
    }
    group_sync(g, G);  // pivot row c in place; the last step's sweep done
    if (nbuf == 2 && c + 1 < n_piv) {
      if constexpr (kSame) {
        T* next = piv + ((c + 1) & 1) * ws;
        for (int j = tid; j < w; j += G) cp_async(next + j, X + (size_t)(c + 1) * w + j);
      } else {
#pragma unroll
        for (int q = 0; q < kNextRegs; ++q)
          if (tid + q * G < w) nx[q] = X[(size_t)(c + 1) * w + tid + q * G];
      }
    }
    if (tid < 32) {
      auto col = [&](int r) { return r == 0 ? row0[c] : A[(r - 1) * ws + c]; };
      if constexpr (N)
        ggr::coeff_chain_narrow<S>(tid, n, col, rec, slot);
      else
        ggr::coeff_chain(tid, n, col, rec, slot);
    }
    group_sync(g, G);  // coefficients, sigma and t_0 in place
    const T sigma = slot[0], t0 = slot[1];
    S* Yc = Y + (size_t)c * w;
    if (t0 > ggr::eps<T>()) {  // do_any: the same for every thread of the problem
      // Columns left of c are zero in every active row (R is upper
      // triangular, and each earlier column was annihilated), so only the
      // w - c - 1 columns right of c are swept.
      for (int j = c + 1 + tid; j < w; j += G) {
        if constexpr (N)
          ggr::column_walk_narrow<S>(n, n, A + j, ws, row0[j], rec, t0, Yc + j, scr, G);
        else
          ggr::column_walk<S, T, 4>(n, A + j, ws, row0[j], rec, t0, Yc + j);
      }
      // the annihilated column: sigma*t_0 at the pivot, zeros below
      for (int r = 1 + tid; r < n; r += G) A[(r - 1) * ws + c] = T(0);
      for (int j = tid; j <= c; j += G)
        Yc[j] = ggr::narrow<S>(j == c ? sigma * t0 : row0[j]);
    } else {  // nothing to annihilate: the problem stays as it is
      for (int j = tid; j < w; j += G) Yc[j] = ggr::narrow<S>(row0[j]);
    }
    if (nbuf == 2) {
      if constexpr (kSame) {
        cp_async_wait_all();
      } else if (c + 1 < n_piv) {  // the last step's reads of this buffer are done
        T* next = piv + ((c + 1) & 1) * ws;
#pragma unroll
        for (int q = 0; q < kNextRegs; ++q)
          if (tid + q * G < w) next[tid + q * G] = ggr::widen<T>(nx[q]);
      }
    }
  }

  group_sync(g, G);
  for (int e = tid; e < p * w; e += G) {
    const int i = e / w, j = e - i * w;
    Y[(size_t)(n_piv + i) * w + j] = ggr::narrow<S>(A[i * ws + j]);
  }
}

template <typename S, typename T, bool N = false>
int launch(const S* in, S* out, int B, int m, int w, int n_piv, int G, int PB,
           int ws, int nbuf, int device, void* stream) {
  if (G < 32 || G % 32 || PB < 1 || G * PB > 512 || (G > 32 && PB > 15) ||
      (nbuf != 1 && nbuf != 2) || ws < w || n_piv < 1 || m <= n_piv ||
      (!std::is_same_v<S, T> && nbuf == 2 && (w + G - 1) / G > kNextRegs))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n = m - n_piv + 1;
  const size_t smem = PB * group_elems(n, ws, nbuf, N ? (size_t)n * G : 0) * sizeof(T);
  err = cudaFuncSetAttribute(batched_update_kernel<S, T, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((B + PB - 1) / PB);
  batched_update_kernel<S, T, N><<<grid, G * PB, smem, (cudaStream_t)stream>>>(
      in, out, B, m, w, n_piv, G, ws, nbuf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ggr_batched_update_f32(const float* in, float* out, int B, int m, int w,
                           int n_piv, int G, int PB, int ws, int nbuf, int device,
                           void* stream) {
  return launch<float, float>(in, out, B, m, w, n_piv, G, PB, ws, nbuf, device, stream);
}

int ggr_batched_update_f64(const double* in, double* out, int B, int m, int w,
                           int n_piv, int G, int PB, int ws, int nbuf, int device,
                           void* stream) {
  return launch<double, double>(in, out, B, m, w, n_piv, G, PB, ws, nbuf, device,
                                stream);
}

int ggr_batched_update_bf16_f32(const __nv_bfloat16* in, __nv_bfloat16* out, int B,
                                int m, int w, int n_piv, int G, int PB, int ws,
                                int nbuf, int device, void* stream) {
  return launch<__nv_bfloat16, float>(in, out, B, m, w, n_piv, G, PB, ws, nbuf, device,
                                      stream);
}

int ggr_batched_update_f16_f32(const __half* in, __half* out, int B, int m, int w,
                               int n_piv, int G, int PB, int ws, int nbuf, int device,
                               void* stream) {
  return launch<__half, float>(in, out, B, m, w, n_piv, G, PB, ws, nbuf, device, stream);
}

int ggr_batched_update_f32_f64(const float* in, float* out, int B, int m, int w,
                               int n_piv, int G, int PB, int ws, int nbuf, int device,
                               void* stream) {
  return launch<float, double>(in, out, B, m, w, n_piv, G, PB, ws, nbuf, device, stream);
}

int ggr_batched_update_bf16_f64(const __nv_bfloat16* in, __nv_bfloat16* out, int B,
                                int m, int w, int n_piv, int G, int PB, int ws,
                                int nbuf, int device, void* stream) {
  return launch<__nv_bfloat16, double>(in, out, B, m, w, n_piv, G, PB, ws, nbuf, device,
                                       stream);
}

int ggr_batched_update_f16_f64(const __half* in, __half* out, int B, int m, int w,
                               int n_piv, int G, int PB, int ws, int nbuf, int device,
                               void* stream) {
  return launch<__half, double>(in, out, B, m, w, n_piv, G, PB, ws, nbuf, device, stream);
}

int ggr_batched_update_bf16(const __nv_bfloat16* in, __nv_bfloat16* out, int B, int m,
                            int w, int n_piv, int G, int PB, int ws, int nbuf, int device,
                            void* stream) {
  return launch<__nv_bfloat16, float, true>(in, out, B, m, w, n_piv, G, PB, ws, nbuf,
                                            device, stream);
}

int ggr_batched_update_f16(const __half* in, __half* out, int B, int m, int w, int n_piv,
                           int G, int PB, int ws, int nbuf, int device, void* stream) {
  return launch<__half, float, true>(in, out, B, m, w, n_piv, G, PB, ws, nbuf, device,
                                     stream);
}

const char* ggr_update_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
