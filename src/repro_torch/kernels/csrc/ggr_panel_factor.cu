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
// TB/s) against 41 MFLOP (0.0006 ms at 67 TFLOP/s), so bytes bound it.
//
// Design: a row split over co-resident blocks.  The Pallas kernel keeps the
// panel in VMEM for all b column steps; a fused frame (1-2 MB) is far over
// the 227 KB of one block, and one block per panel used 1/132 of the card.
// So panel q is cut into nblk contiguous row slabs [lo_k, hi_k) (heights
// differ by at most one row), block (q, k) loads its slab into shared memory
// once (row stride b + 1: a column read is free of bank conflicts) and keeps
// it there for all b steps; R is written back once at the end.  nblk is
// chosen by ggr_panel.py::_panel_blocks from the panel's shape, dtype and the
// card (slabs of about 128 rows, never more than one block's shared memory
// or the co-resident capacity), never from B, so a panel's result does not
// depend on its batch; the launch function checks it against the capacity.
// Per column c only a few numbers per slab cross between blocks, through
// three scratch arrays in `work` and a grid-wide barrier after each:
//   A. sigma: each block publishes the max-abs of its active rows of column
//      c; every block takes the max of all nblk (exact).
//   B. suffix norms: each block publishes sum (v/sigma)^2 over its active
//      rows; every block reduces all nblk partials in one fixed order (so
//      t_p, and do_any = t_p > 1e-30, are bitwise the same in every block
//      and no block can skip a barrier the others wait at), takes its carry
//      (the partials of the slabs below) and walks its rows bottom-up from
//      it in one warp; the slab's last row needs t_hi = sqrt(carry).  The
//      owner of row p uses the shared t_p there.
//   C. suffix dots and halo: each block publishes the partial dots
//      sum v*x of its active rows over the b-c-1 columns right of c, its
//      bottom row's old values over those columns, and that row's k and l.
//      A block's carry for P is the sum of the partials below it; its top
//      row's DET2 takes the row above (the halo: row, k and l published by
//      slab k-1).  Inside the slab the sweep is ggr_scan.cuh's row-chunked
//      scan and det2_walk, on shared memory, over groups of at most
//      blockDim.x columns: a panel wider than the block takes several groups
//      (and its dots twice), so any width whose per-column values fit a
//      block's shared memory runs.
// Blocks above the pivot take part with zero partials.  Three arrays, so no
// fourth barrier: a block can only overwrite column c+1's array X after
// every block has passed column c+1's barriers before X.  A launch takes at
// most 3b grid barriers: a column whose pivot is past the end takes none, and
// one with do_any false skips exchange C when the grid holds one panel.
//
// The launch: nblk == 1 (small frames) is an ordinary launch of B blocks
// with block barriers only.  nblk > 1 launches with cudaLaunchCooperativeKernel,
// which guarantees that all blocks are co-resident, and the barrier is
// cooperative_groups::this_grid().sync() (no -rdc needed).  The capacity
// (occupancy x SMs at the launch's shared memory) comes from
// ggr_panel_factor_capacity, which the caller queries once per shape and
// passes in; an nblk over it is refused, and a batch whose B * nblk exceeds
// it runs in sub-batches of floor(capacity / nblk) panels on the caller's
// stream.  A panel so tall that
// capacity blocks cannot hold it in shared memory keeps its slabs in R in
// device memory (resident == 0) and runs the same code through a generic
// pointer.  Per-column planes of v/sigma and t go to `work` as (b, m) rows
// and are transposed into V and T through shared-memory tiles at the end.
//
// Mixed precision: an instance whose storage S differs from its compute T
// — bf16 / f16 tiles with float sums, and f32 / bf16 / f16 tiles with
// double sums — keeps the uniform T instance's design and layout: the slab,
// the vectors, the exchange arrays and `work` hold T (ggr_panel.py sizes
// shared memory, the capacity and `work` at the compute itemsize, so a
// wide panel takes the nblk and residency of an f64 panel of its shape).
// The state rounds as the JAX kernel rounds it, at every column step: each
// row det2_walk writes back (the DET2 rows and the pivot row P_p / t_p) goes
// through S as it is stored (round_to: from double, f32 and f16 round once,
// bf16 through float, as kernels/backend.py::to_tile does), and the
// annihilated column is written as sigma * t_p with both factors rounded to
// S first and the product rounded again (the JAX kernel takes sigma and t at
// cd there; two S values multiply exactly in double, so at a wide pair the
// product rounds once, as the plain version's to_tile(sigma) * to_tile(t)
// at the tile dtype does).  The step's own DET2 takes the T-valued v and t;
// only the stored V and T planes are rounded, narrowed from the T planes in
// transpose_out, as the JAX kernel returns v.astype(cd) and t.astype(cd).  A
// slab kept in device memory (resident == 0) cannot live in R, which holds
// S: such an instance keeps it in `work`, m * b more values a panel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ggr_common.cuh"
#include "ggr_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // kTile x kTile transpose tiles
constexpr int kPart = kTile * (kTile + 1) > kThreads ? kTile * (kTile + 1) : kThreads;

// Scratch `work` per panel: t and v/sigma of every column as (b, m) planes,
// then the exchange arrays A (nblk), B (nblk) and C (nblk x (2b + 2): the
// slab's dots, its bottom row, that row's k and l), then, when the slabs live
// in device memory, each slab's vectors v/sigma, t, k, l (rows_max + 2 each)
// and, for a mixed instance, the slabs themselves (m x b).
size_t work_size(int m, int b, int nblk, int resident, bool mixed) {
  const size_t rows_max = (m + nblk - 1) / nblk;
  return 2 * (size_t)b * m + (size_t)nblk * (2 * b + 4) +
         (resident ? 0 : 4 * (size_t)nblk * (rows_max + 2) + (mixed ? (size_t)m * b : 0));
}

// Shared memory per block: scan/transpose slots, reduction slots, sigma, t_p,
// the dot carry and the halo row per column, then (resident) the vectors and
// the slab; mirrors ggr_panel.py::_panel_smem.
template <typename T>
size_t smem_bytes(int m, int b, int nblk, int resident) {
  const size_t rows_max = (m + nblk - 1) / nblk;
  size_t n = kPart + ggr::kReduceSlots + 4 * (size_t)b;
  if (resident) n += 4 * (rows_max + 2) + rows_max * (b + 1);
  return n * sizeof(T);
}

__device__ __forceinline__ void grid_barrier(int nblk) {
  if (nblk > 1)
    cg::this_grid().sync();
  else
    __syncthreads();
}

// dst rows [lo, hi) (m x b, row-major) <- column planes src (b x m) for rows
// r >= pivot0 + c, and `above` (0 or t_p) for the rows above each pivot,
// rounded to S; coalesced both ways through a kTile x kTile shared tile.
template <typename S, typename T, typename Above>
__device__ void transpose_out(const T* src, S* dst, int m, int b, int lo, int hi,
                              int pivot0, T* tile, Above above) {
  const int tx = threadIdx.x % kTile, ty0 = threadIdx.x / kTile;
  const int tys = blockDim.x / kTile;
  for (int r0 = lo; r0 < hi; r0 += kTile) {
    for (int c0 = 0; c0 < b; c0 += kTile) {
      for (int ty = ty0; ty < kTile; ty += tys) {  // read along r
        const int c = c0 + ty, r = r0 + tx;
        if (c < b && r < hi)
          tile[ty * (kTile + 1) + tx] = r >= pivot0 + c ? src[(size_t)c * m + r] : above(c);
      }
      __syncthreads();
      for (int ty = ty0; ty < kTile; ty += tys) {  // write along c
        const int cw = c0 + tx, rw = r0 + ty;
        if (cw < b && rw < hi) dst[(size_t)rw * b + cw] = ggr::narrow<S>(tile[tx * (kTile + 1) + ty]);
      }
      __syncthreads();
    }
  }
}

// Grid (panels, nblk): block (q, k) factors slab k of panel q.
template <typename S, typename T>
__global__ void __launch_bounds__(kThreads)
panel_factor_kernel(const S* __restrict__ in, S* __restrict__ R, S* __restrict__ V,
                    S* __restrict__ Tn, T* __restrict__ work, int m, int b,
                    int pivot0, int nblk, int resident, int ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);  // scan slots / transpose tile
  T* red = part + kPart;                     // block-reduction slots
  T* sig = red + ggr::kReduceSlots;          // sigma of column c
  T* tpv = sig + b;                          // t_p of column c
  T* pcar = tpv + b;                         // dot carry of the slabs below
  T* halo = pcar + b;                        // old bottom row of the slab above

  const int k = blockIdx.y;
  const int lo = (int)((long long)k * m / nblk);
  const int hi = (int)((long long)(k + 1) * m / nblk);
  const int rows = hi - lo;
  const int nv = (m + nblk - 1) / nblk + 2;  // vector length: rows + 2 slots
  const size_t off = (size_t)blockIdx.x * m * b;
  in += off;
  R += off;
  V += off;
  Tn += off;
  T* pw = work + (size_t)blockIdx.x * ws;
  T* tplane = pw;  // t of column c at tplane[c * m + r]
  T* vplane = tplane + (size_t)b * m;
  T* exA = vplane + (size_t)b * m;
  T* exB = exA + nblk;
  T* exC = exB + nblk;
  const int cs = 2 * b + 2;  // exC per slab: dots [0, b), bottom row [b, 2b), k, l
  T* vec;                    // vectors of the slab; row r at slot r - lo + 1
  T* X;                      // the slab; row r, column j at X[(r - lo) * ld + j]
  int ld;
  if (resident) {
    vec = halo + b;
    X = vec + 4 * nv;
    ld = b + 1;
  } else {
    vec = exC + (size_t)nblk * cs + (size_t)k * 4 * nv;
    if constexpr (std::is_same_v<S, T>)
      X = R + (size_t)lo * b;
    else  // the slabs after every slab's vectors
      X = exC + (size_t)nblk * cs + (size_t)nblk * 4 * nv + (size_t)lo * b;
    ld = b;
  }
  T* vs = vec;      // v/sigma
  T* tt = vs + nv;  // suffix norms; slot rows + 1: t of row hi
  T* kk = tt + nv;  // coefficients; slot 0: row lo - 1 (from the slab above)
  T* ll = kk + nv;

  for (int i = threadIdx.x; i < rows * b; i += blockDim.x) {
    const int r = i / b;
    X[r * ld + (i - r * b)] = ggr::widen<T>(in[(size_t)lo * b + i]);
  }
  for (int c = threadIdx.x; c < b; c += blockDim.x) sig[c] = tpv[c] = T(0);
  __syncthreads();

  for (int c = 0; c < b; ++c) {
    const int p = pivot0 + c;
    if (p >= m) break;  // this column and every later one: no transform
    const int a0 = p > lo ? p : lo;  // first active row of the slab (none if >= hi)
    T* tcol = tplane + (size_t)c * m;
    T* vcol = vplane + (size_t)c * m;

    // A. sigma: the max-abs of the active rows over all slabs
    T amax = T(0);
    for (int r = a0 + threadIdx.x; r < hi; r += blockDim.x) {
      const T a = fabs(X[(r - lo) * ld + c]);
      amax = a > amax ? a : amax;
    }
    amax = ggr::block_max(amax, red);
    if (threadIdx.x == 0) exA[k] = amax;
    grid_barrier(nblk);
    T smax = T(0);
    for (int i = threadIdx.x; i < nblk; i += blockDim.x) {
      const T a = __ldcg(exA + i);
      smax = a > smax ? a : smax;
    }
    const T sigma = ggr::block_max(smax, red);
    const T scale = sigma > T(0) ? sigma : T(1);

    // B. suffix norms: warp 0 scans the slab (a chunk of rows per lane)
    const int lane = threadIdx.x & 31;
    const int n = hi > a0 ? hi - a0 : 0;
    const int len = (n + 31) / 32;
    const int wlo = a0 + lane * len < hi ? a0 + lane * len : hi;
    const int whi = wlo + len < hi ? wlo + len : hi;
    T excl = T(0);  // sum over the slab's rows below this lane's chunk
    if (threadIdx.x < 32) {
      T acc = T(0);
      for (int r = wlo; r < whi; ++r) {
        const T v = X[(r - lo) * ld + c] / scale;
        vs[r - lo + 1] = v;
        acc += v * v;
      }
      T s = acc;  // inclusive suffix over the lanes
      for (int d = 1; d < 32; d <<= 1) {
        const T y = __shfl_down_sync(0xffffffffu, s, d);
        if (lane + d < 32) s += y;
      }
      excl = __shfl_down_sync(0xffffffffu, s, 1);
      if (lane == 31) excl = T(0);
      if (lane == 0) exB[k] = s;
    }
    grid_barrier(nblk);
    if (threadIdx.x < 32) {
      // every block reduces the nblk partials in the same order: t_p is
      // bitwise the same in all of them
      T all = T(0), below = T(0);
      for (int i = lane; i < nblk; i += 32) {
        const T x = __ldcg(exB + i);
        all += x;
        if (i > k) below += x;
      }
      for (int d = 16; d > 0; d >>= 1) {
        all += __shfl_xor_sync(0xffffffffu, all, d);
        below += __shfl_xor_sync(0xffffffffu, below, d);
      }
      T t2 = below + excl;
      for (int r = whi - 1; r >= wlo; --r) {
        const T v = vs[r - lo + 1];
        t2 += v * v;
        tt[r - lo + 1] = sqrt(t2);
      }
      __syncwarp();
      if (lane == 0) {
        const T tp = sqrt(all);
        tt[rows + 1] = sqrt(below);
        if (p >= lo && p < hi) tt[p - lo + 1] = tp;
        sig[c] = sigma;
        tpv[c] = tp;
      }
    }
    __syncthreads();
    const T tp = tpv[c];
    for (int r = a0 + threadIdx.x; r < hi; r += blockDim.x) {
      vcol[r] = vs[r - lo + 1];
      tcol[r] = tt[r - lo + 1];
    }
    const bool do_any = tp > ggr::eps<T>();  // the same in every block of the panel
    const int nc = b - c - 1;
    if (nc == 0 || (!do_any && gridDim.x == 1)) continue;  // grid-uniform

    // C. suffix dots of the columns right of c, and the halo.  The columns
    // go in groups of at most blockDim.x (one group unless the panel is
    // wider than the block); dots(j0) takes group j0's chunking, the partial
    // dot of the thread's chunk, its halo row and its carry within the slab.
    for (int r = a0 + threadIdx.x; r < hi; r += blockDim.x)
      ggr::det2_coeffs(vs[r - lo + 1], tt[r - lo + 1], tt[r - lo + 2], kk[r - lo + 1],
                       ll[r - lo + 1]);
    __syncthreads();
    constexpr int G = ggr::WalkGroup<T>::value;
    const int gw = blockDim.x;
    auto v = [=](int r) { return vs[r - lo + 1]; };
    ggr::Chunking s;
    T acc, hal, carry;
    auto dots = [&](int j0) {
      s = ggr::chunking(nc - j0 < gw ? nc - j0 : gw, a0, hi);
      const int col = c + 1 + j0 + s.jj;
      auto x = [=](int r) { return X[(r - lo) * ld + col]; };
      acc = ggr::chunk_dot<T, G>(s.lo, s.hi, v, x);
      hal = s.lo < s.hi && s.lo > p && s.lo > lo ? x(s.lo - 1) : T(0);
      carry = ggr::chunk_carry(s, acc, part);
    };
    T* ec = exC + (size_t)k * cs;
    for (int j0 = 0; j0 < nc; j0 += gw) {
      dots(j0);
      if (s.active && s.k == 0) ec[j0 + s.jj] = carry + acc;  // the slab's partial dot
    }
    for (int j = threadIdx.x; j < nc; j += blockDim.x)
      ec[b + j] = X[(rows - 1) * ld + c + 1 + j];
    if (threadIdx.x == 0) {
      ec[2 * b] = kk[rows];
      ec[2 * b + 1] = ll[rows];
    }
    grid_barrier(nblk);
    if (!do_any) continue;  // block-uniform: the panel stays as it is
    for (int j = threadIdx.x; j < nc; j += blockDim.x) {
      T P = T(0);
      for (int i = nblk - 1; i > k; --i) P += __ldcg(exC + (size_t)i * cs + j);
      pcar[j] = P;
      if (lo > p) halo[j] = __ldcg(exC + (size_t)(k - 1) * cs + b + j);
    }
    if (threadIdx.x == 0 && lo > p) {
      kk[0] = __ldcg(exC + (size_t)(k - 1) * cs + 2 * b);
      ll[0] = __ldcg(exC + (size_t)(k - 1) * cs + 2 * b + 1);
    }
    __syncthreads();
    for (int j0 = 0; j0 < nc; j0 += gw) {
      // a wide panel takes each group's dots again: its columns are unchanged
      if (nc > gw) dots(j0);
      const int j = j0 + s.jj, col = c + 1 + j;
      ggr::det2_walk<T, G>(
          s.lo, s.hi, p, pcar[j] + carry, s.lo == lo ? halo[j] : hal, tp,
          [=](int r) { return X[(r - lo) * ld + col]; },
          [=](int r, T val) { X[(r - lo) * ld + col] = ggr::round_to<S>(val); }, v,
          [=](int r) { return kk[r - lo + 1]; }, [=](int r) { return ll[r - lo + 1]; });
      __syncthreads();
    }
  }
  __syncthreads();

  // R: the slab, with the annihilated columns written exactly (sigma * t_p
  // at the pivot, 0 below; do_any only)
  for (int i = threadIdx.x; i < rows * b; i += blockDim.x) {
    const int rl = i / b, c = i - rl * b;
    const int r = lo + rl;
    T val = X[rl * ld + c];
    if (r >= pivot0 + c && tpv[c] > ggr::eps<T>())
      val = r == pivot0 + c ? ggr::round_to<S>(sig[c]) * ggr::round_to<S>(tpv[c]) : T(0);
    R[(size_t)lo * b + i] = ggr::narrow<S>(val);
  }
  // V and T: the column planes, zero / t_p above each pivot
  transpose_out(vplane, V, m, b, lo, hi, pivot0, part, [](int) { return T(0); });
  transpose_out(tplane, Tn, m, b, lo, hi, pivot0, part, [=](int c) { return tpv[c]; });
}

// The kernel may take up to kMaxSmem bytes of dynamic shared memory: set once
// per device, before the first launch or capacity query there.
constexpr int kMaxSmem = 232448;  // an H100 block's limit (_cuda.MAX_SMEM_BYTES)
constexpr int kMaxDevices = 64;

template <typename S, typename T>
cudaError_t allow_smem(int device) {
  static bool done[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      panel_factor_kernel<S, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done[device] = err == cudaSuccess;
  return err;
}

// `cap`: the blocks that can be co-resident at this launch's shared memory,
// from ggr_panel_factor_capacity (queried once per shape and cached by the
// caller); the launch refuses an nblk over it.
template <typename S, typename T>
int launch(const S* in, S* R, S* V, S* Tn, T* work, int B, int m, int b,
           int pivot0, int nblk, int resident, int ws, int cap, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nblk < 1 || nblk > m ||
      (size_t)ws < work_size(m, b, nblk, resident, !std::is_same_v<S, T>))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(m, b, nblk, resident);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = allow_smem<S, T>(device);
  if (err != cudaSuccess) return (int)err;
  if (nblk == 1) {
    panel_factor_kernel<S, T><<<dim3(B, 1), kThreads, smem, (cudaStream_t)stream>>>(
        in, R, V, Tn, work, m, b, pivot0, nblk, resident, ws);
    return (int)cudaGetLastError();
  }
  if (nblk > cap) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int per = cap / nblk;  // panels per cooperative launch
  const size_t panel = (size_t)m * b;
  for (int q0 = 0; q0 < B; q0 += per) {
    const int nb = B - q0 < per ? B - q0 : per;
    const S* a_in = in + q0 * panel;
    S* a_R = R + q0 * panel;
    S* a_V = V + q0 * panel;
    S* a_T = Tn + q0 * panel;
    T* a_work = work + (size_t)q0 * ws;
    void* args[] = {&a_in, &a_R, &a_V, &a_T, &a_work, &m, &b, &pivot0, &nblk, &resident, &ws};
    err = cudaLaunchCooperativeKernel((const void*)panel_factor_kernel<S, T>, dim3(nb, nblk),
                                      dim3(kThreads), args, smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Blocks of the kernel that can be co-resident on the card at `smem` bytes of
// shared memory each: occupancy x SMs, or -(CUDA error).
template <typename S, typename T>
int capacity(int smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = allow_smem<S, T>(device);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, panel_factor_kernel<S, T>,
                                                        kThreads, (size_t)smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

}  // namespace

extern "C" {

int ggr_panel_factor_f32(const float* in, float* R, float* V, float* Tn,
                         float* work, int B, int m, int b, int pivot0, int nblk,
                         int resident, int ws, int cap, int device, void* stream) {
  return launch<float, float>(in, R, V, Tn, work, B, m, b, pivot0, nblk, resident, ws,
                              cap, device, stream);
}

int ggr_panel_factor_f64(const double* in, double* R, double* V, double* Tn,
                         double* work, int B, int m, int b, int pivot0, int nblk,
                         int resident, int ws, int cap, int device, void* stream) {
  return launch<double, double>(in, R, V, Tn, work, B, m, b, pivot0, nblk, resident, ws,
                                cap, device, stream);
}

int ggr_panel_factor_bf16_f32(const __nv_bfloat16* in, __nv_bfloat16* R, __nv_bfloat16* V,
                              __nv_bfloat16* Tn, float* work, int B, int m, int b,
                              int pivot0, int nblk, int resident, int ws, int cap,
                              int device, void* stream) {
  return launch<__nv_bfloat16, float>(in, R, V, Tn, work, B, m, b, pivot0, nblk,
                                      resident, ws, cap, device, stream);
}

int ggr_panel_factor_f16_f32(const __half* in, __half* R, __half* V, __half* Tn,
                             float* work, int B, int m, int b, int pivot0, int nblk,
                             int resident, int ws, int cap, int device, void* stream) {
  return launch<__half, float>(in, R, V, Tn, work, B, m, b, pivot0, nblk, resident, ws,
                               cap, device, stream);
}

int ggr_panel_factor_f32_f64(const float* in, float* R, float* V, float* Tn,
                             double* work, int B, int m, int b, int pivot0, int nblk,
                             int resident, int ws, int cap, int device, void* stream) {
  return launch<float, double>(in, R, V, Tn, work, B, m, b, pivot0, nblk, resident, ws,
                               cap, device, stream);
}

int ggr_panel_factor_bf16_f64(const __nv_bfloat16* in, __nv_bfloat16* R, __nv_bfloat16* V,
                              __nv_bfloat16* Tn, double* work, int B, int m, int b,
                              int pivot0, int nblk, int resident, int ws, int cap,
                              int device, void* stream) {
  return launch<__nv_bfloat16, double>(in, R, V, Tn, work, B, m, b, pivot0, nblk,
                                       resident, ws, cap, device, stream);
}

int ggr_panel_factor_f16_f64(const __half* in, __half* R, __half* V, __half* Tn,
                             double* work, int B, int m, int b, int pivot0, int nblk,
                             int resident, int ws, int cap, int device, void* stream) {
  return launch<__half, double>(in, R, V, Tn, work, B, m, b, pivot0, nblk, resident, ws,
                                cap, device, stream);
}

int ggr_panel_factor_capacity_f32(int smem, int device) {
  return capacity<float, float>(smem, device);
}

int ggr_panel_factor_capacity_f64(int smem, int device) {
  return capacity<double, double>(smem, device);
}

int ggr_panel_factor_capacity_bf16_f32(int smem, int device) {
  return capacity<__nv_bfloat16, float>(smem, device);
}

int ggr_panel_factor_capacity_f16_f32(int smem, int device) {
  return capacity<__half, float>(smem, device);
}

int ggr_panel_factor_capacity_f32_f64(int smem, int device) {
  return capacity<float, double>(smem, device);
}

int ggr_panel_factor_capacity_bf16_f64(int smem, int device) {
  return capacity<__nv_bfloat16, double>(smem, device);
}

int ggr_panel_factor_capacity_f16_f64(int smem, int device) {
  return capacity<__half, double>(smem, device);
}

const char* ggr_panel_factor_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
