// Kernel A: one level of the depthwise tpu_hist grower on Hopper.
//
// Replaces the TPU kernel xgboost_tpu/tree/hist_kernel.py:_fused_level_pallas
// (body _level_kernel, helpers _partition_tile and _grad_channels). Same
// contract as fused_level_xla: route every row through level d-1's decision
// table (numerical [Kp, 4] or categorical [Kp, 5+B], route.cuh), then
// accumulate (g, h) per (feature, node, bin) for level d into
// hist [F, 2K, B] (g rows [0, K), h rows [K, 2K)), the missing bin excluded.
//
// Where the int8 one-hot of the bins fits the device-memory budget, the
// hoisted route takes the level instead (kernel D, hoisted_level.cu, fed by
// kernel C, onehot.cu); this kernel is the construct route, taken when the
// hoist plan is 0 (XGBTPU_HOIST_BUDGET_MB=0, or fewer than 4 features fit,
// as at 10M x 50 at max_bin 256). Both give the same int64 histogram bits.
//
// Determinism. The TPU kernel is deterministic by construction (an MXU
// matmul per tile, accumulated in grid order). f32 atomicAdd is not: its
// order changes from run to run. This kernel accumulates fixed-point
// integers instead, as the reference gpu_hist does
// (gpu_hist/histogram.cu:81-120): the caller quantises each gradient lane
// with a power-of-two scale (|q| <= 2^30, int32), the kernel adds the
// integers, and the caller dequantises once. Integer addition is
// associative, so any launch order gives the same bits, and the plain
// PyTorch version (index_add_ over int64) gives the same bits too.
//
// Shape of the work, two launches per level:
// 1. level_route_kernel routes every row once and writes its new position
//    and its local node at level d (or -1: not at this level).
// 2. level_hist_kernel reads the bins feature-major ([F, n_pad], a copy made
//    once per training matrix), so the 32 lanes of a warp read 128 adjacent
//    rows of one feature (4 rows each, one 4- or 8-byte load). Its grid is
//    (node slices, fastest) x (feature groups) x (row chunks). A block loads
//    its rows' local nodes and quantised (g, h) into registers once per 4
//    rows and adds them into the shared-memory tiles of every feature of
//    its group, then flushes the tiles to hist with 64-bit device-memory
//    atomics (order-free), one per non-zero cell.
//
// What bounds it on this card. The bytes a level must move are the bins
// (n*F at uint8, twice that at int16), the positions in and out and the
// quantised gradients: about 62 MB at 1M x 50, ~19 us at 3.35 TB/s. What
// held the first version of this kernel at 20-55x that (measured on an H100 80GB
// HBM3 at 700 W, chip_smoke.py): every feature tile of a row chunk routed
// its rows again (50 routings per row at bin 256), a warp's 32 lanes read
// 32 rows F bytes apart, the 64-bit shared-memory add compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN.64 in the SASS), and each of
// ~550 blocks flushed a whole [2K, B] tile. The design against that:
// - rows are routed once per level (launch 1), and the bins are read
//   coalesced from the feature-major copy;
// - each (g, h) value goes into the tile as two native 32-bit shared adds:
//   its low 16 bits (unsigned) and its high bits (signed), exact while a
//   block takes at most 2^16 rows (kHalvesMaxRows); the flush recombines
//   them into int64;
// - the tile is capped (kTileBudget) so that two blocks fit on an SM; a
//   feature group takes as many features as fit; one feature's whole
//   [2K, B] tile may exceed the cap where it fits shared memory (one block
//   per SM); beyond that a block takes a slice of the level's nodes and
//   skips rows of other nodes (their local node is already in a register,
//   so the skip costs no bin load);
// - the grid holds about kWaves x kBlocksPerSm blocks per SM, so each tile
//   is flushed few times.
// Where not even one node's [2, B] tile fits shared memory (B above ~14k),
// the kernel adds straight into hist (same integers, same bits).
//
// Bins are read in their storage type (uint8 up to max_bin 254, int16
// above, so the default max_bin 256 runs here); missing is bin id B.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "route.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kVec = 4;                     // rows per thread per pass
constexpr int kSub = kThreads * kVec;       // rows per block per pass
constexpr int kTileBudget = 96 * 1024;      // shared tile bytes per block
constexpr int kBlocksPerSm = 2;
constexpr int kWaves = 2;                   // grid size, in waves
constexpr long long kHalvesMaxRows = 1LL << 16;  // rows per block (tile)
constexpr int kRouteThreads = 256;

template <typename T>
struct RouteArgs {
  const T* __restrict__ bins;
  int n, F, B;
  const int32_t* __restrict__ pos_in;
  int32_t* __restrict__ pos_out;
  const float* __restrict__ ptab;  // [Kp, W] (route.cuh)
  int W, Kp, prev_offset, K, offset;
  int32_t* __restrict__ loc;  // [n]: local node at level d, or -1
};

template <typename T>
__global__ void __launch_bounds__(kRouteThreads)
    level_route_kernel(RouteArgs<T> a) {
  const long long r = (long long)blockIdx.x * kRouteThreads + threadIdx.x;
  if (r >= a.n) return;
  int p = a.pos_in[r];
  if (a.Kp > 0)
    p = route_row(a.bins, a.F, a.B, a.ptab, a.W, a.Kp, a.prev_offset, r, p);
  a.pos_out[r] = p;
  const int local = p - a.offset;
  a.loc[r] = (local >= 0 && local < a.K) ? local : -1;
}

template <typename T>
struct HistArgs {
  const T* __restrict__ bins_t;  // [F, n_pad] feature-major
  long long n_pad;
  int n, F, B, K;
  const int32_t* __restrict__ loc;  // [n] from level_route_kernel
  const int2* __restrict__ q;       // [n] quantised (g, h)
  unsigned long long* __restrict__ hist;  // [F, 2K, B] int64, zeroed
  int Ks, nf;  // nodes per slice, features per group
  long long rows_per_block;
};

// four consecutive bins of one feature, in one load
template <typename T>
struct Vec4;
template <>
struct Vec4<uint8_t> {
  using type = unsigned;
  static __device__ __forceinline__ int get(unsigned v, int j) {
    return (v >> (8 * j)) & 0xff;
  }
};
template <>
struct Vec4<int16_t> {
  using type = uint2;
  static __device__ __forceinline__ int get(uint2 v, int j) {
    const unsigned w = j < 2 ? v.x : v.y;
    return static_cast<int16_t>((w >> (16 * (j & 1))) & 0xffff);
  }
};

// kShared: the block's tiles in shared memory, as 32-bit halves; else the
// adds go straight to hist
template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    level_hist_kernel(HistArgs<T> a) {
  using V = typename Vec4<T>::type;
  extern __shared__ unsigned long long tile[];
  const int s0 = blockIdx.x * a.Ks;
  const int ks = min(a.Ks, a.K - s0);
  const int f0 = blockIdx.y * a.nf;
  const int nff = min(a.nf, a.F - f0);
  const int slab = a.Ks * a.B;             // one lane's rows of a feature
  const int cells = nff * 2 * slab;
  unsigned* lo = reinterpret_cast<unsigned*>(tile);  // low 16 bits, summed
  int* hi = reinterpret_cast<int*>(lo + cells);       // the rest, summed
  if (kShared) {
    for (int c = threadIdx.x; c < cells; c += kThreads) lo[c] = 0u, hi[c] = 0;
    __syncthreads();
  }
  const long long r0 = (long long)blockIdx.z * a.rows_per_block;
  const long long r1 = min((long long)a.n, r0 + a.rows_per_block);
  for (long long rb = r0 + kVec * threadIdx.x; rb < r1; rb += kSub) {
    int l[kVec];
    int2 q[kVec];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int lj = (rb + j < r1) ? a.loc[rb + j] - s0 : -1;
      l[j] = (lj >= 0 && lj < ks) ? lj : -1;
      q[j] = l[j] >= 0 ? a.q[rb + j] : make_int2(0, 0);
      any |= l[j] >= 0;
    }
    if (!any) continue;
    const T* col = a.bins_t + (long long)f0 * a.n_pad + rb;
    V v = *reinterpret_cast<const V*>(col);
    for (int fi = 0; fi < nff; ++fi) {
      V next = v;
      if (fi + 1 < nff)
        next = *reinterpret_cast<const V*>(col + (fi + 1) * a.n_pad);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int b = Vec4<T>::get(v, j);
        if (l[j] < 0 || b >= a.B) continue;  // missing: recovered by caller
        if (!kShared) {
          const long long c =
              ((long long)(f0 + fi) * 2 * a.K + l[j]) * a.B + b;
          atomicAdd(a.hist + c, (unsigned long long)(long long)q[j].x);
          atomicAdd(a.hist + c + (long long)a.K * a.B,
                    (unsigned long long)(long long)q[j].y);
        } else {
          // q = (q >> 16) * 2^16 + (q & 0xffff), each part summed exactly
          const int c = (fi * 2 * a.Ks + l[j]) * a.B + b;
          atomicAdd(lo + c, (unsigned)q[j].x & 0xffffu);
          atomicAdd(hi + c, q[j].x >> 16);
          atomicAdd(lo + c + slab, (unsigned)q[j].y & 0xffffu);
          atomicAdd(hi + c + slab, q[j].y >> 16);
        }
      }
      v = next;
    }
  }
  if (!kShared) return;
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    const long long v = (static_cast<long long>(hi[c]) << 16) + (long long)lo[c];
    if (v == 0) continue;
    const int fi = c / (2 * slab);
    const int row = (c - fi * 2 * slab) / a.B;  // lane * Ks + local
    const int b = c - fi * 2 * slab - row * a.B;
    const int lane = row >= a.Ks;
    const int local = row - lane * a.Ks;
    const long long dst =
        ((long long)(f0 + fi) * 2 * a.K + lane * a.K + s0 + local) * a.B + b;
    atomicAdd(a.hist + dst, static_cast<unsigned long long>(v));
  }
}

template <typename T>
int launch_route(const T* bins, int n, int F, int B, const int32_t* pos_in,
                 int32_t* pos_out, const float* ptab, int W, int Kp,
                 int prev_offset, int K, int offset, int32_t* loc,
                 cudaStream_t s) {
  if (n < 0 || F < 1 || B < 1 || K < 1 || !route_width_ok(W, B))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  RouteArgs<T> a{bins, n, F, B, pos_in, pos_out, ptab, W, Kp, prev_offset, K,
                 offset, loc};
  level_route_kernel<T><<<(unsigned)((n + kRouteThreads - 1) / kRouteThreads),
                          kRouteThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The shared-memory opt-in of level_hist_kernel<T, true>, once per device.
template <typename T>
cudaError_t allow_smem(int dev, int bytes) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ULL << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      level_hist_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T>
int launch_level(const T* bins, int n, int F, int B, const int32_t* pos_in,
                 int32_t* pos_out, const int32_t* qgh, const float* ptab,
                 int W, int Kp, int prev_offset, int K, int offset,
                 long long* hist, const T* bins_t, long long n_pad,
                 int32_t* loc, cudaStream_t s) {
  if (n_pad < n || n_pad % kVec != 0 || bins_t == nullptr)
    return (int)cudaErrorInvalidValue;
  int status = launch_route(bins, n, F, B, pos_in, pos_out, ptab, W, Kp,
                            prev_offset, K, offset, loc, s);
  if (status != 0 || n == 0) return status;

  int dev = 0, sms = 0, smem_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const long long node_bytes = 2LL * B * 8;  // g and h rows of one node
  const bool device_path = node_bytes > smem_optin;
  // the tile cap; raised to one feature's whole [2K, B] tile where that
  // fits shared memory, since node slices re-read every row (H100 80GB
  // HBM3 at 700 W, bin 256, K = 32, scripts/torch_level_variants.py: 0.353
  // ms in two slices, 0.296 in one, one block per SM)
  long long budget = kTileBudget;
  if (K * node_bytes > budget && K * node_bytes <= smem_optin)
    budget = K * node_bytes;
  if (node_bytes > budget) budget = smem_optin;
  int Ks = K, nf = F, slices = 1;
  if (!device_path) {
    const long long ks_max = budget / node_bytes;
    slices = (int)((K + ks_max - 1) / ks_max);
    Ks = (K + slices - 1) / slices;
    const long long fit = budget / (Ks * node_bytes);
    nf = (int)(fit < F ? fit : F);
  }
  const int groups = (F + nf - 1) / nf;
  // about kWaves x kBlocksPerSm blocks per SM in all, in whole passes, and
  // at most kHalvesMaxRows rows per block where the tile holds halves
  const long long per_chunk = (long long)slices * groups;
  long long chunks =
      ((long long)kWaves * kBlocksPerSm * sms + per_chunk - 1) / per_chunk;
  if (chunks < 1) chunks = 1;
  long long rpb = ((long long)n + chunks - 1) / chunks;
  rpb = ((rpb + kSub - 1) / kSub) * kSub;
  if (!device_path && rpb > kHalvesMaxRows) rpb = kHalvesMaxRows;
  chunks = ((long long)n + rpb - 1) / rpb;
  if (groups > 65535 || chunks > 65535) return (int)cudaErrorInvalidValue;

  HistArgs<T> a{bins_t, n_pad, n, F, B, K, loc,
                reinterpret_cast<const int2*>(qgh),
                reinterpret_cast<unsigned long long*>(hist), Ks, nf, rpb};
  dim3 grid((unsigned)slices, (unsigned)groups, (unsigned)chunks);
  if (device_path) {
    level_hist_kernel<T, false><<<grid, kThreads, 0, s>>>(a);
  } else {
    cudaError_t err = allow_smem<T>(dev, smem_optin);
    if (err != cudaSuccess) return (int)err;
    level_hist_kernel<T, true><<<grid, kThreads,
                                 (size_t)nf * Ks * node_bytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One level: pos_out gets the routed positions, hist [F, 2K, B] int64
// (zeroed by the caller) the level's sums. ptab is level d-1's decision
// table, [Kp, W] with W = 4 or 5 + B (route.cuh). bins_t is the
// feature-major copy of the bins, [F, n_pad] with n_pad >= n a multiple of
// 4; loc [n] int32 is scratch the caller allocates. bin_bytes: 1 for uint8
// bins, 2 for int16 bins; anything else is refused.
extern "C" int xgbt_fused_level(const void* bins, int bin_bytes, int n, int F,
                                int B, const int32_t* pos_in, int32_t* pos_out,
                                const int32_t* qgh, const float* ptab, int W,
                                int Kp, int prev_offset, int K, int offset,
                                long long* hist, const void* bins_t,
                                long long n_pad, int32_t* loc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch_level(static_cast<const uint8_t*>(bins), n, F, B, pos_in,
                        pos_out, qgh, ptab, W, Kp, prev_offset, K, offset,
                        hist, static_cast<const uint8_t*>(bins_t), n_pad, loc,
                        s);
  if (bin_bytes == 2)
    return launch_level(static_cast<const int16_t*>(bins), n, F, B, pos_in,
                        pos_out, qgh, ptab, W, Kp, prev_offset, K, offset,
                        hist, static_cast<const int16_t*>(bins_t), n_pad, loc,
                        s);
  return (int)cudaErrorInvalidValue;
}

// Launch 1 of the level alone: the routed positions and each row's local
// node at level d (or -1), as xgbt_fused_level writes them before its
// histogram launch.
extern "C" int xgbt_level_route(const void* bins, int bin_bytes, int n, int F,
                                int B, const int32_t* pos_in, int32_t* pos_out,
                                const float* ptab, int W, int Kp,
                                int prev_offset, int K, int offset,
                                int32_t* loc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch_route(static_cast<const uint8_t*>(bins), n, F, B, pos_in,
                        pos_out, ptab, W, Kp, prev_offset, K, offset, loc, s);
  if (bin_bytes == 2)
    return launch_route(static_cast<const int16_t*>(bins), n, F, B, pos_in,
                        pos_out, ptab, W, Kp, prev_offset, K, offset, loc, s);
  return (int)cudaErrorInvalidValue;
}
