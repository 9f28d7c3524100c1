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
// Design: a systolic pipeline, one bottom-up pass over each column for all b
// transforms.  Read a column bottom-up; on reading row r, transform c already
// holds both inputs of its output row r+1 — P_{r+1} in a register (it adds
// v_r x_r after the emit) and x_{r+1}, its previous input — so it can emit row
// r+1 at once: the DET2 value below its pivot, P_p / t_p at the pivot, the old
// value above it.  Its output stream, bottom-up too, is the input stream of
// transform c+1, so the b transforms run as a chain of b stages.  A flush
// token after row pivot0 emits the last row.
//
// Mapping.  A segment of W lanes (8, 16 or 32) of a warp runs one column's
// pipeline: lane s holds NS consecutive stages (transforms s*NS .. s*NS+NS-1)
// with their state (suffix dot, previous input, last output) in registers.  Every
// tick each lane takes its stages' steps, last stage first, so each stage
// reads the value its predecessor emitted on the previous tick (in a register,
// or from lane s-1 through one __shfl_up_sync): stage q works on the stream's
// element e = tick - 2q.  Lane 0 reads C, W rows at a time, one load per lane
// per W ticks, a tile ahead; the lane of stage b-1 writes each output row.  In
// place (out == C) is safe: a column belongs to one segment, and its row r is
// written long after it was read.  So every element of C is read from device
// memory once and written once, and no barrier runs inside the replay.
//
// Each stage carries the scaled suffix dot Q = P_{r+1} / t_{r+1} instead of
// P, which turns its step into a plane rotation with two coefficients,
// a_r = v_r / t_r and c_r = t_{r+1} / t_r (a^2 + c^2 = 1):
//   emit row r+1:  a_r Q - c_r x_r   (= k_r P_{r+1} - l_r x_r)
//   then        Q <- a_r x_r + c_r Q  (= P_r / t_r)
// and the pivot row is Q itself (a = 1, c = 0 on reading row p-1): no
// division in the replay.  Where t_{r+1} <= 1e-30 the stage passes its
// previous input on; that is flagged by c = -0.0 (its sign bit), which
// leaves Q <- a_r x_r, the right update there (|P_{r+1}| <= t_{r+1} |x|
// is negligible).
//
// Coefficients: a first pass (coeff_kernel) writes, for every tick and stage,
// the pair (a, c) that the stage uses at that tick — skewed by tick, so the
// lanes of a warp read consecutive pairs; rows outside a stage's stream
// store (0, -0.0).  A block of NW warps covers NW*32/W adjacent columns of
// one problem and stages the coefficients of 32 ticks at a time in shared
// memory (cp.async, double buffered), shared by all its columns: two
// __syncthreads per 32 ticks.  Each tick's pairs are loaded one tick ahead.
//
// Mixed precision: an instance whose storage S (V, T, C and the output)
// differs from its compute T — bf16 / f16 tiles with float sums, and f32 /
// bf16 / f16 tiles with double sums — keeps the uniform T instance's
// pipeline, with the coefficients computed in T from the S-valued V and T
// and staged as T pairs (float2, or double2 at 64 KiB of shared memory a
// block at (32, 4), as the double instance).  The JAX kernel stores C at the
// tile dtype after every transform, so each stage rounds what it emits
// through S (round_to; from double, f32 and f16 round once, bf16 through
// float, as kernels/backend.py::to_tile does) before stage c+1 takes it as
// its input: the DET2 rows and the pivot row Q alike, at every transform.
// Only the running scaled suffix dot Q stays in T across rows, as the suffix
// dot P does in the JAX kernel.  x is loaded as S and widened exactly; the
// writer lane narrows a value that is already an S value, so its store is
// exact.
#include <cuda_runtime.h>

#include "ggr_common.cuh"

namespace {

constexpr int kTicks = 32;  // ticks per staged coefficient tile
constexpr int kCoeffThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
struct Pair;
template <>
struct Pair<float> { using type = float2; };
template <>
struct Pair<double> { using type = double2; };

// The pass flag: the sign bit of c (c = -0.0 passes, c >= +0.0 rotates).
__device__ __forceinline__ bool passes(float c) { return __float_as_int(c) < 0; }
__device__ __forceinline__ bool passes(double c) { return __double_as_longlong(c) < 0; }

// coef[((prob*nticks + tick)*Qp + pos)*2 + {0,1}] = a, c of stage
// q = (pos % lanes)*per_lane + pos / lanes at that tick (Qp = lanes*per_lane).
template <typename S, typename T>
__global__ void __launch_bounds__(kCoeffThreads)
coeff_kernel(const S* __restrict__ V, const S* __restrict__ Tn,
             T* __restrict__ coef, int B, int m, int b, int pivot0, int lanes,
             int per_lane, int nticks) {
  const int Qp = lanes * per_lane;
  const int r0 = pivot0 < m ? pivot0 : m;
  const size_t total = (size_t)B * nticks * Qp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int pos = (int)(i % Qp);
    const size_t rest = i / Qp;
    const int tick = (int)(rest % nticks);
    const size_t prob = rest / nticks;
    const int q = (pos % lanes) * per_lane + pos / lanes;
    const int e = tick - 2 * q;  // the stream element stage q reads
    const int r = m - 1 - e;     // its row; r0 - 1 is the flush token
    const int p = pivot0 + q;
    T a = T(0), c = -T(0);  // pass
    if (q < b && p < m && e >= 0 && r >= r0 - 1) {
      const S* Vp = V + prob * m * b;
      const S* Tp = Tn + prob * m * b;
      if (ggr::widen<T>(Tp[(size_t)p * b + q]) > ggr::eps<T>()) {
        if (r >= p) {
          const T t = ggr::widen<T>(Tp[(size_t)r * b + q]);
          const T tn = r + 1 < m ? ggr::widen<T>(Tp[(size_t)(r + 1) * b + q]) : T(0);
          const T st = t > ggr::eps<T>() ? t : T(1);
          a = ggr::widen<T>(Vp[(size_t)r * b + q]) / st;
          if (tn > ggr::eps<T>()) c = tn / st;
        } else if (r == p - 1) {  // emits the pivot row: Q = P_p / t_p
          a = T(1);
          c = T(0);
        }
      }
    }
    T* out = coef + ((prob * nticks + tick) * Qp + pos) * 2;
    out[0] = a;
    out[1] = c;
  }
}

template <typename S, typename T, int W, int NS>
__global__ void __launch_bounds__(512, 2)
apply_kernel(const S* C, S* out, const T* __restrict__ coef, int m, int b,
             int w, int pivot0, int ntiles, int ncb, int c_bstride,
             int c_rstride, int o_bstride, int o_rstride) {
  constexpr int Qp = W * NS;
  constexpr int kTile = kTicks * Qp * 2;  // elements of one coefficient tile
  constexpr int XQ = kTicks / W;          // rows of C each lane loads per tile
  constexpr int kChunks = kTile * (int)sizeof(T) / 16;  // 16-byte copies per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // two tiles

  const int lane = threadIdx.x & 31;
  const int s = lane % W;  // this lane's place in its column's pipeline
  const size_t prob = blockIdx.x / ncb;
  const int cb = blockIdx.x - (int)prob * ncb;
  const int col = (cb * (int)(blockDim.x >> 5) + (int)(threadIdx.x >> 5)) * (32 / W)
                  + lane / W;
  const bool has_col = col < w;
  const S* src = C + prob * c_bstride + col;
  S* dst = out + prob * o_bstride + col;
  const T* cf = coef + prob * ntiles * kTile;
  const int r0 = pivot0 < m ? pivot0 : m;  // rows above r0 are untouched
  const int n0 = m - r0;
  const bool writer = has_col && s == (b - 1) / NS;
  const int wslot = (b - 1) % NS;

  if (C != out && has_col)
    for (int r = s; r < r0; r += W) dst[(size_t)r * o_rstride] = src[(size_t)r * c_rstride];

  auto load_tile = [&](int it) {
    const char* g = reinterpret_cast<const char*>(cf + (size_t)it * kTile);
    char* sm = reinterpret_cast<char*>(buf + (it & 1) * kTile);
    for (int i = threadIdx.x; i < kChunks; i += blockDim.x)
      cp_async16(sm + 16 * i, g + 16 * i);
    cp_async_commit();
  };
  // stream element e = it*kTicks + kb*W + s: row m-1-e, or 0 past row r0
  auto load_x = [&](int it, T* xq) {
#pragma unroll
    for (int kb = 0; kb < XQ; ++kb) {
      const int e = it * kTicks + kb * W + s;
      xq[kb] = has_col && e < n0 ? ggr::widen<T>(src[(size_t)(m - 1 - e) * c_rstride]) : T(0);
    }
  };

  using T2 = typename Pair<T>::type;
  T Q[NS], xp[NS], y[NS];  // per stage: scaled suffix dot, previous input, last output
#pragma unroll
  for (int j = 0; j < NS; ++j) Q[j] = xp[j] = y[j] = T(0);
  T xq[XQ];
  load_tile(0);
  load_x(0, xq);

  for (int it = 0; it < ntiles; ++it) {
    T xn[XQ];
#pragma unroll
    for (int kb = 0; kb < XQ; ++kb) xn[kb] = T(0);
    if (it + 1 < ntiles) {
      load_tile(it + 1);
      load_x(it + 1, xn);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it is in shared memory for every warp
    const T2* tile = reinterpret_cast<const T2*>(buf + (it & 1) * kTile) + s;
    const int ew0 = it * kTicks - 2 * (b - 1);  // stage b-1's element at t = 0
    T2 next[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) next[j] = tile[j * W];
#pragma unroll
    for (int t = 0; t < kTicks; ++t) {
      T2 cf[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        cf[j] = next[j];
        if (t + 1 < kTicks) next[j] = tile[(t + 1) * Qp + j * W];
      }
      const T x0 = __shfl_sync(kFull, xq[t / W], t % W, W);
      T in = __shfl_up_sync(kFull, y[NS - 1], 1, W);
      if (s == 0) in = x0;
#pragma unroll
      for (int j = NS - 1; j >= 0; --j) {
        const T x = j > 0 ? y[j > 0 ? j - 1 : 0] : in;
        const T a = cf[j].x, c = cf[j].y;
        const T d = fma(a, Q[j], -c * x);
        y[j] = passes(c) ? xp[j] : ggr::round_to<S>(d);
        Q[j] = fma(a, x, c * Q[j]);
        xp[j] = x;
      }
      const int ew = ew0 + t;  // stage b-1 emits row m - ew
      if (writer && ew >= 1 && ew <= n0) {
        T o = y[0];
#pragma unroll
        for (int j = 1; j < NS; ++j)
          if (j == wslot) o = y[j];
        if constexpr (std::is_same_v<S, T>)
          __stcg(dst + (size_t)(m - ew) * o_rstride, o);  // a global store: no smem alias
        else
          dst[(size_t)(m - ew) * o_rstride] = ggr::narrow<S>(o);
      }
    }
    __syncthreads();  // every warp is done with tile it before it is reloaded
#pragma unroll
    for (int kb = 0; kb < XQ; ++kb) xq[kb] = xn[kb];
  }
}

template <typename S, typename T, int W, int NS>
int run_apply(const S* C, S* out, const T* coef, int B, int m, int b, int w,
              int pivot0, int nwarps, int ntiles, int c_bstride, int c_rstride,
              int o_bstride, int o_rstride, cudaStream_t st) {
  const int smem = 2 * kTicks * W * NS * 2 * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      apply_kernel<S, T, W, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int cols = nwarps * (32 / W);
  const int ncb = (w + cols - 1) / cols;
  apply_kernel<S, T, W, NS><<<(unsigned)B * ncb, 32 * nwarps, smem, st>>>(
      C, out, coef, m, b, w, pivot0, ntiles, ncb, c_bstride, c_rstride,
      o_bstride, o_rstride);
  return (int)cudaGetLastError();
}

template <typename S, typename T>
int launch(const S* V, const S* Tn, const S* C, S* out, T* coef, int B, int m,
           int b, int w, int pivot0, int lanes, int per_lane, int nwarps,
           int ntiles, int c_bstride, int c_rstride, int o_bstride,
           int o_rstride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t total = (size_t)B * ntiles * kTicks * lanes * per_lane;
  const size_t want = (total + kCoeffThreads - 1) / kCoeffThreads;
  const int nblk = want < 4096 ? (int)want : 4096;
  coeff_kernel<S, T><<<nblk, kCoeffThreads, 0, st>>>(
      V, Tn, coef, B, m, b, pivot0, lanes, per_lane, ntiles * kTicks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define GGR_APPLY_CASE(W_, NS_)                                                \
  if (lanes == W_ && per_lane == NS_)                                          \
    return run_apply<S, T, W_, NS_>(C, out, coef, B, m, b, w, pivot0, nwarps,  \
                                 ntiles, c_bstride, c_rstride, o_bstride,      \
                                 o_rstride, st);
  GGR_APPLY_CASE(8, 1)
  GGR_APPLY_CASE(16, 1)
  GGR_APPLY_CASE(32, 1)
  GGR_APPLY_CASE(32, 2)
  GGR_APPLY_CASE(32, 4)
#undef GGR_APPLY_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int ggr_apply_factors_f32(const float* V, const float* Tn, const float* C,
                          float* out, float* coef, int B, int m, int b, int w,
                          int pivot0, int lanes, int per_lane, int nwarps,
                          int ntiles, int c_bstride, int c_rstride,
                          int o_bstride, int o_rstride, int device, void* stream) {
  return launch<float, float>(V, Tn, C, out, coef, B, m, b, w, pivot0, lanes, per_lane,
                              nwarps, ntiles, c_bstride, c_rstride, o_bstride,
                              o_rstride, device, stream);
}

int ggr_apply_factors_f64(const double* V, const double* Tn, const double* C,
                          double* out, double* coef, int B, int m, int b, int w,
                          int pivot0, int lanes, int per_lane, int nwarps,
                          int ntiles, int c_bstride, int c_rstride,
                          int o_bstride, int o_rstride, int device, void* stream) {
  return launch<double, double>(V, Tn, C, out, coef, B, m, b, w, pivot0, lanes,
                                per_lane, nwarps, ntiles, c_bstride, c_rstride,
                                o_bstride, o_rstride, device, stream);
}

int ggr_apply_factors_bf16_f32(const __nv_bfloat16* V, const __nv_bfloat16* Tn,
                               const __nv_bfloat16* C, __nv_bfloat16* out, float* coef,
                               int B, int m, int b, int w, int pivot0, int lanes,
                               int per_lane, int nwarps, int ntiles, int c_bstride,
                               int c_rstride, int o_bstride, int o_rstride, int device,
                               void* stream) {
  return launch<__nv_bfloat16, float>(V, Tn, C, out, coef, B, m, b, w, pivot0, lanes,
                                      per_lane, nwarps, ntiles, c_bstride, c_rstride,
                                      o_bstride, o_rstride, device, stream);
}

int ggr_apply_factors_f16_f32(const __half* V, const __half* Tn, const __half* C,
                              __half* out, float* coef, int B, int m, int b, int w,
                              int pivot0, int lanes, int per_lane, int nwarps,
                              int ntiles, int c_bstride, int c_rstride, int o_bstride,
                              int o_rstride, int device, void* stream) {
  return launch<__half, float>(V, Tn, C, out, coef, B, m, b, w, pivot0, lanes, per_lane,
                               nwarps, ntiles, c_bstride, c_rstride, o_bstride,
                               o_rstride, device, stream);
}

int ggr_apply_factors_f32_f64(const float* V, const float* Tn, const float* C,
                              float* out, double* coef, int B, int m, int b, int w,
                              int pivot0, int lanes, int per_lane, int nwarps,
                              int ntiles, int c_bstride, int c_rstride, int o_bstride,
                              int o_rstride, int device, void* stream) {
  return launch<float, double>(V, Tn, C, out, coef, B, m, b, w, pivot0, lanes, per_lane,
                               nwarps, ntiles, c_bstride, c_rstride, o_bstride,
                               o_rstride, device, stream);
}

int ggr_apply_factors_bf16_f64(const __nv_bfloat16* V, const __nv_bfloat16* Tn,
                               const __nv_bfloat16* C, __nv_bfloat16* out, double* coef,
                               int B, int m, int b, int w, int pivot0, int lanes,
                               int per_lane, int nwarps, int ntiles, int c_bstride,
                               int c_rstride, int o_bstride, int o_rstride, int device,
                               void* stream) {
  return launch<__nv_bfloat16, double>(V, Tn, C, out, coef, B, m, b, w, pivot0, lanes,
                                       per_lane, nwarps, ntiles, c_bstride, c_rstride,
                                       o_bstride, o_rstride, device, stream);
}

int ggr_apply_factors_f16_f64(const __half* V, const __half* Tn, const __half* C,
                              __half* out, double* coef, int B, int m, int b, int w,
                              int pivot0, int lanes, int per_lane, int nwarps,
                              int ntiles, int c_bstride, int c_rstride, int o_bstride,
                              int o_rstride, int device, void* stream) {
  return launch<__half, double>(V, Tn, C, out, coef, B, m, b, w, pivot0, lanes, per_lane,
                                nwarps, ntiles, c_bstride, c_rstride, o_bstride,
                                o_rstride, device, stream);
}

const char* ggr_apply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
