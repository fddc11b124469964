// Kernel D: one level of the depthwise tpu_hist grower over the resident
// int8 one-hot (the hoisted route), on the tensor cores.
//
// Replaces the TPU kernel xgboost_tpu/tree/hist_kernel.py:_hoisted_level_pallas
// (body _hoisted_kernel, helpers _partition_tile and _grad_channels). Same
// contract as kernel A (hist_level.cu) and fused_level_xla: route every row
// through level d-1's decision table (numerical [Kp, 4] or categorical
// [Kp, 5+B], route.cuh), then accumulate (g, h) per
// (feature, node, bin) for level d into hist [F, 2K, B] (g rows [0, K), h
// rows [K, 2K)), the missing bin excluded. The first Fh features come from
// the one-hot that kernel C (onehot.cu) built once per training matrix,
// feature-major [Fh*B, n_pad]; features Fh..F-1 are built in the same launch
// from the bins, as the TPU kernel builds them in VMEM.
//
// Exact integer arithmetic, so the trees do not depend on the route. The
// caller quantises each gradient lane (|q| <= 2^30, int32; the scheme of
// kernel A). Each q splits into four signed base-256 digits
// (q = d0 + 2^8 d1 + 2^16 d2 + 2^24 d3, |d| <= 128), which are int8. A block
// multiplies a channel matrix A [rows (lane, digit, node), data rows] (the
// digit where the data row sits at that node, else 0) by the one-hot
// [data rows, columns] with mma.sync.m16n8k32.s32.s8.s8.s32, sums in s32
// (|sum| <= 128 * rows, so a block takes at most 2^23 rows), combines the
// four digit sums with shifts into int64 and adds them to hist with 64-bit
// integer atomics, which are order-free. Kernel A, this kernel and the plain
// versions all give the same int64 histogram.
//
// The TPU kernel's bf16 hi/lo split is exact only to about 2^-16 per term; it
// is not carried over.
//
// Shape of the work. Launch 1 (route_kernel) touches every row once: it
// routes the row and writes its new position, its 16-byte channel record
// {local node at level d or -1, the four digits of q_g, the four of q_h, 0}
// and, for a partial hoist, the row's unhoisted bins into a feature-major
// copy [F-Fh, n_pad]. Launch 2 (hoisted_kernel) has a grid of (column tiles,
// fastest) x (row chunks) x (slot blocks). A column tile is 64 one-hot
// columns: either 64 columns of the resident one-hot (the hoisted features)
// or 64 bins of one unhoisted feature, whose one-hot the block builds in
// shared memory (the construct tiles). A slot block is 64 (lane, node)
// slots, so K <= 32 takes one. Per stage of 128 data rows a block needs the
// one-hot tile [64 columns][128 rows] (or the stage's 128 bins of its
// construct feature) and the stage's 128 records; it builds the channel tile
// [256 rows][128 data rows] from the records. Tiles are K-major with a
// 16-byte pad per row, so each ldmatrix phase of 8 rows x 16 bytes hits 32
// distinct banks; eight warps each own 2 slot groups x 32 columns, 64 s32
// accumulators per thread. Channel and construct tiles are sparse (one node
// per data row), so a thread clears only the bytes it set in the previous
// stage.
//
// What bounds it on this card. Reading the one-hot, n_pad*Fh*B bytes (3.2 GB
// at 1M x 50 x 64: ~0.96 ms at 3.35 TB/s), against 2*8K*n*Fh*B int8
// operations (~0.83 ms at K = 32 at 1979 TOP/s). Neither is what holds
// this kernel (measured on an H100 80GB HBM3 at 700 W by
// scripts/torch_hoisted_variants.py):
// - the one-hot comes in 64 runs of 128 bytes per stage, one per column,
//   n_pad bytes apart; through the ring below that streams at about
//   2.6 TB/s, where one sequential read of it reaches about 3 TB/s;
// - mma.sync is not Hopper's full-rate tensor-core path (wgmma is): on
//   register operands alone this kernel's MMAs run at about 900 int8 TOP/s,
//   so at K = 32 the MMAs, not the stream, set the time.
// What the design does about it:
// - the stage's inputs come through a ring of kStages stages in shared
//   memory, filled by 16-byte cp.async.cg (zero-filled past n_pad and n)
//   that ask L2 for the whole 256-byte segment, so a column's next stage
//   is mostly in L2 already (H100, bin 64, level 0: 1.34 -> 1.21 ms);
//   a block keeps kStages - 1 stages (~30 KB) in flight while the tensor
//   cores run on the current one, and two blocks fit on an SM (~83 KB
//   each), so ~60 KB are in flight per SM;
// - the per-row inputs are one contiguous record, written once per level
//   by launch 1 and read by every column tile of a row chunk (the chunk's
//   tiles run together, so from L2), with no dependent chain of loads and
//   no digit split in the stage loop;
// - the construct tiles read their feature's bins contiguously (128 or 256
//   bytes a stage, through the same ring) instead of one 1-2 byte read at
//   an F-element stride per row;
// - at K <= 16 the level fills at most half of a block's slot groups; the
//   warps that would idle share the stage's k-steps, so the MMA phase that
//   sits between the stage's barriers is 2-4x shorter;
// - fragments come by ldmatrix.x4 (one instruction for four 8x8 tiles),
//   every k-step is unrolled, and the grid aims at 32 blocks per SM so the
//   last wave is short.
// wgmma and TMA (warp-specialised, persistent) are the next step: at K = 32
// the MMA issue rate is the limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "route.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;              // data rows per shared-memory stage
constexpr int kStride = kRows + 16;     // bytes per shared-memory tile row
constexpr int kSlots = 64;              // (lane, node) slots per block
constexpr int kARows = 4 * kSlots;      // channel rows: 4 digits per slot
constexpr int kCols = 64;               // columns per block
constexpr int kStages = 4;              // depth of the cp.async ring
constexpr int kTileBytes = kCols * kStride;  // a stage's one-hot tile
constexpr int kRecBytes = kRows * 16;        // a stage's channel records
constexpr int kBinBytes = kRows * 2;         // a stage's construct bins
constexpr int kSmem =
    kARows * kStride + kStages * (kTileBytes + kRecBytes + kBinBytes);
constexpr long long kMaxRowsPerBlock = 1LL << 23;  // s32 digit sums stay exact
constexpr int kBlocksPerSm = 32;  // target grid size, in blocks per SM

// q -> its balanced base-256 digits, one byte each, digit 0 lowest; each in
// [-128, 127] (the last <= 65)
__device__ __forceinline__ int pack_digits(int q) {
  unsigned w = 0;
#pragma unroll
  for (int dg = 0; dg < 4; ++dg) {
    const int d =
        (dg < 3) ? static_cast<int>(static_cast<int8_t>(q & 0xff)) : q;
    w |= static_cast<unsigned>(static_cast<uint8_t>(static_cast<int8_t>(d)))
         << (8 * dg);
    q = (q - d) >> 8;
  }
  return static_cast<int>(w);
}

template <typename T>
struct RouteArgs {
  const T* bins;
  int n, F, B, Fh;
  long long n_pad;
  const int32_t* pos_in;
  int32_t* pos_out;
  const int32_t* qgh;  // [n, 2]
  const float* ptab;   // [Kp, W] (route.cuh)
  int W, Kp, prev_offset, K, offset;
  int4* rec;   // [n] channel records
  T* bins_t;   // [F-Fh, n_pad], or null for a full hoist
};

template <typename T>
__global__ void __launch_bounds__(kThreads) route_kernel(RouteArgs<T> a) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.n) return;
  int p = a.pos_in[r];
  if (a.Kp > 0)
    p = route_row(a.bins, a.F, a.B, a.ptab, a.W, a.Kp, a.prev_offset, r, p);
  a.pos_out[r] = p;
  const int local = p - a.offset;
  const int2 q = reinterpret_cast<const int2*>(a.qgh)[r];
  a.rec[r] = make_int4((local >= 0 && local < a.K) ? local : -1,
                       pack_digits(q.x), pack_digits(q.y), 0);
  const T* row = a.bins + r * a.F;
  for (int f = a.Fh; f < a.F; ++f)
    a.bins_t[(long long)(f - a.Fh) * a.n_pad + r] = row[f];
}

template <typename T>
struct HoistArgs {
  const int8_t* onehot;  // [Fh*B, n_pad]
  const int4* rec;       // [n] channel records from route_kernel
  const T* bins_t;       // [F-Fh, n_pad] unhoisted bins, feature-major
  int n, B, Fh;
  long long n_pad;
  int hoisted_tiles, tiles_per_feature;
  int K;
  unsigned long long* hist;  // [F, 2K, B] int64, zeroed by the caller
  long long rows_per_block;
};

// channel-tile row of (slot within the block, digit): slot s = 8p + g puts
// digits 0, 1 in rows g, g + 8 of m-tile 2p and digits 2, 3 in rows g, g + 8
// of m-tile 2p + 1, so one thread's accumulators hold all four digits of a
// (slot, column) pair
__device__ __forceinline__ int channel_row(int s, int digit) {
  return 16 * (2 * (s >> 3) + (digit >> 1)) + (s & 7) + 8 * (digit & 1);
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 16-bit matrices from shared memory, lane i giving the address of
// row i % 8 of matrix i / 8; thread (g, tq) gets bytes 4tq..4tq+3 of row g
// of each
__device__ __forceinline__ void ldmatrix_x4(unsigned* r,
                                            const unsigned char* row) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sa));
}

// 16 bytes global -> shared, bypassing L1, with L2 fetching the 256-byte
// segment around them; bytes past src_bytes are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(d),
      "l"(src), "r"(src_bytes)
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
__global__ void __launch_bounds__(kThreads, 2)
    hoisted_kernel(HoistArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* As = smem;                           // [kARows][kStride]
  unsigned char* Bring = As + kARows * kStride;       // [kStages] one-hot tiles
  unsigned char* Rring = Bring + kStages * kTileBytes;  // [kStages] records
  unsigned char* Xring = Rring + kStages * kRecBytes;   // [kStages] bins
  unsigned char* Bbuilt = Bring;  // a construct tile's one-hot (no ring)
  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
  const int s0 = blockIdx.z * kSlots;
  const int K2 = 2 * a.K;
  // Warp w owns columns 32 * (w & 1).. and a pair of slot groups (8 slots
  // each). When the level fills at most half of the block's eight groups,
  // the warps that would own empty pairs share the stage's four k-steps of
  // the filled pairs instead: `reps` warps per pair, warp `rep` taking every
  // reps-th k-step, each adding its partial sums in the epilogue.
  const int groups = min(8, (K2 - s0 + 7) / 8);
  const int pairs = groups <= 2 ? 1 : (groups <= 4 ? 2 : 4);
  const int reps = 4 / pairs;
  const int wn = warp & 1;
  const int pair = (warp >> 1) % pairs, rep = (warp >> 1) / pairs;
  const bool hoisted = (int)blockIdx.x < a.hoisted_tiles;
  const int Q = a.Fh * a.B;
  int c0 = 0, fcon = 0, b0 = 0;
  if (hoisted) {
    c0 = blockIdx.x * kCols;
  } else {
    const int t = blockIdx.x - a.hoisted_tiles;
    fcon = a.Fh + t / a.tiles_per_feature;
    b0 = (t % a.tiles_per_feature) * kCols;
  }
  const long long r_begin = (long long)blockIdx.y * a.rows_per_block;
  const long long r_end = min((long long)a.n, r_begin + a.rows_per_block);
  const int stages = static_cast<int>((r_end - r_begin + kRows - 1) / kRows);

  for (int i = tid; i < kSmem / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();  // the ring's zeros land before its first copies

  // a stage's inputs into its ring slot: the one-hot tile (64 columns x 8
  // chunks of 16 rows, two per thread) or the construct feature's bins, and
  // the 128 records
  const T* xsrc = hoisted ? nullptr
                          : a.bins_t + (long long)(fcon - a.Fh) * a.n_pad;
  auto issue = [&](int st) {
    const int slot = st % kStages;
    const long long rs = r_begin + (long long)st * kRows;
    if (hoisted) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cid = tid + u * kThreads;
        const int col = cid >> 3, j = cid & 7;
        const long long r = rs + 16 * j;
        const bool ok = c0 + col < Q && r < a.n_pad;
        cp_async16(Bring + slot * kTileBytes + col * kStride + 16 * j,
                   ok ? a.onehot + (long long)(c0 + col) * a.n_pad + r
                      : a.onehot,
                   ok ? 16 : 0);
      }
    } else if (tid >= kRows && tid < kRows + kRows * (int)sizeof(T) / 16) {
      const int j = tid - kRows;
      const long long r = rs + j * (16 / (int)sizeof(T));
      const bool ok = r < a.n_pad;
      cp_async16(Xring + slot * kBinBytes + 16 * j, ok ? xsrc + r : xsrc,
                 ok ? 16 : 0);
    }
    if (tid < kRows) {
      const long long r = rs + tid;
      const bool ok = r < a.n;
      cp_async16(Rring + slot * kRecBytes + 16 * tid, ok ? a.rec + r : a.rec,
                 ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < stages) issue(st);
    cp_async_commit();
  }

  int acc[2][4][2][4];
#pragma unroll
  for (int pi = 0; pi < 2; ++pi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pi][ni][h][e] = 0;
  bool active[2];
#pragma unroll
  for (int pi = 0; pi < 2; ++pi) active[pi] = s0 + (2 * pair + pi) * 8 < K2;

  // what this thread set in the sparse tiles last stage (-1: nothing)
  const int i_row = tid & (kRows - 1), lane = tid >> 7;
  int a_slot = -1, b_off = -1;
  // this lane's row of the fragment matrices: A's m-tile rows 0-7 | 8-15
  // by k-half 0 | 1 (a0..a3); B's n-tiles 2j | 2j+1 by k-half (b0, b1 each)
  const int L = tid & 31;
  const int a_lane = ((L & 7) + 8 * ((L >> 3) & 1)) * kStride + 16 * (L >> 4);
  const int b_lane =
      ((L & 7) + 8 * (L >> 4)) * kStride + 16 * ((L >> 3) & 1) +
      wn * 32 * kStride;

  for (int st = 0; st < stages; ++st) {
    // stage st has landed; every thread is done with stage st - 1, whose
    // slot the copy issued next refills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (st + kStages - 1 < stages) issue(st + kStages - 1);
    cp_async_commit();
    const int slot = st % kStages;
    const long long rs = r_begin + (long long)st * kRows;
    const long long r = rs + i_row;
    if (!hoisted && lane == 0) {
      if (b_off >= 0) Bbuilt[b_off] = 0;
      b_off = -1;
      if (r < a.n) {
        const T* xs = reinterpret_cast<const T*>(Xring + slot * kBinBytes);
        const int v = static_cast<int>(xs[i_row]) - b0;
        if (v >= 0 && v < kCols && v + b0 < a.B) {
          b_off = v * kStride + i_row;
          Bbuilt[b_off] = 1;
        }
      }
    }
    if (a_slot >= 0) {
#pragma unroll
      for (int dg = 0; dg < 4; ++dg)
        As[channel_row(a_slot, dg) * kStride + i_row] = 0;
    }
    a_slot = -1;
    if (r < a.n) {
      const int4 rc = *reinterpret_cast<const int4*>(Rring + slot * kRecBytes +
                                                     16 * i_row);
      const int s = lane * a.K + rc.x - s0;
      if (rc.x >= 0 && s >= 0 && s < kSlots) {
        const unsigned w = static_cast<unsigned>(lane ? rc.z : rc.y);
#pragma unroll
        for (int dg = 0; dg < 4; ++dg)
          As[channel_row(s, dg) * kStride + i_row] =
              static_cast<unsigned char>(w >> (8 * dg));
        a_slot = s;
      }
    }
    __syncthreads();
    // every k-step, ragged stages too: rows past n are zero in both tiles
    const unsigned char* Bs = hoisted ? Bring + slot * kTileBytes : Bbuilt;
#pragma unroll
    for (int ks = 0; ks < kRows / 32; ++ks) {
      if ((ks & (reps - 1)) != rep) continue;
      unsigned bf[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned b4[4];
        ldmatrix_x4(b4, Bs + b_lane + nj * 16 * kStride + ks * 32);
        bf[2 * nj][0] = b4[0];
        bf[2 * nj][1] = b4[1];
        bf[2 * nj + 1][0] = b4[2];
        bf[2 * nj + 1][1] = b4[3];
      }
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        if (!active[pi]) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int base = 16 * (2 * (2 * pair + pi) + h);
          unsigned af[4];
          ldmatrix_x4(af, As + base * kStride + a_lane + ks * 32);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_s8(acc[pi][ni][h], af, bf[ni][0], bf[ni][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // combine the digit sums and add them to hist
#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const int s = s0 + (2 * pair + pi) * 8 + g;
    if (!active[pi] || s >= K2) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long v = (long long)acc[pi][ni][0][e] +
                            256LL * acc[pi][ni][0][2 + e] +
                            65536LL * acc[pi][ni][1][e] +
                            16777216LL * acc[pi][ni][1][2 + e];
        if (v == 0) continue;
        const int cl = wn * 32 + ni * 8 + 2 * tq + e;
        int f, b;
        if (hoisted) {
          const int c = c0 + cl;
          if (c >= Q) continue;
          f = c / a.B;
          b = c % a.B;
        } else {
          b = b0 + cl;
          if (b >= a.B) continue;
          f = fcon;
        }
        atomicAdd(a.hist + ((long long)f * K2 + s) * a.B + b,
                  static_cast<unsigned long long>(v));
      }
    }
  }
}

template <typename T>
int launch_route(const T* bins, int n, int F, int B, int Fh, long long n_pad,
                 const int32_t* pos_in, int32_t* pos_out, const int32_t* qgh,
                 const float* ptab, int W, int Kp, int prev_offset, int K,
                 int offset, int4* rec, T* bins_t, cudaStream_t s) {
  if (n_pad % 32 != 0 || n_pad < n || Fh < 1 || Fh > F || K < 1 || n < 1 ||
      (Fh < F && bins_t == nullptr) || !route_width_ok(W, B))
    return (int)cudaErrorInvalidValue;
  RouteArgs<T> args{bins, n, F, B, Fh, n_pad, pos_in, pos_out, qgh, ptab,
                    W, Kp, prev_offset, K, offset, rec, bins_t};
  route_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    s>>>(args);
  return (int)cudaGetLastError();
}

// The shared-memory opt-in of hoisted_kernel<T>, once per device.
template <typename T>
cudaError_t allow_smem(int dev) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ULL << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      hoisted_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hoisted_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T>
int launch(const T* bins, int n, int F, int B, const int8_t* onehot, int Fh,
           long long n_pad, const int32_t* pos_in, int32_t* pos_out,
           const int32_t* qgh, const float* ptab, int W, int Kp,
           int prev_offset, int K, int offset, long long* hist, int4* rec,
           T* bins_t, cudaStream_t s) {
  int status = launch_route(bins, n, F, B, Fh, n_pad, pos_in, pos_out, qgh,
                            ptab, W, Kp, prev_offset, K, offset, rec, bins_t,
                            s);
  if (status != 0) return status;

  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = allow_smem<T>(dev);
  if (err != cudaSuccess) return (int)err;
  const int hoisted_tiles = (Fh * B + kCols - 1) / kCols;
  const int tpf = (B + kCols - 1) / kCols;
  const int tiles = hoisted_tiles + (F - Fh) * tpf;
  const int slot_blocks = (2 * K + kSlots - 1) / kSlots;
  // about kBlocksPerSm blocks per SM in all, in whole stages, and few enough
  // rows per block that the s32 digit sums cannot overflow
  long long chunks = ((long long)kBlocksPerSm * sms +
                      (long long)tiles * slot_blocks - 1) /
                     ((long long)tiles * slot_blocks);
  const long long max_chunks = ((long long)n + kRows - 1) / kRows;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  long long rpb = ((long long)n + chunks - 1) / chunks;
  rpb = ((rpb + kRows - 1) / kRows) * kRows;
  if (rpb > kMaxRowsPerBlock) rpb = kMaxRowsPerBlock;
  chunks = ((long long)n + rpb - 1) / rpb;

  HoistArgs<T> args{onehot, rec, bins_t, n, B, Fh, n_pad, hoisted_tiles, tpf,
                    K, reinterpret_cast<unsigned long long*>(hist), rpb};
  dim3 grid((unsigned)tiles, (unsigned)chunks, (unsigned)slot_blocks);
  hoisted_kernel<T><<<grid, kThreads, kSmem, s>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// One level over the hoisted one-hot: pos_out gets the routed positions,
// hist [F, 2K, B] int64 (zeroed by the caller) the level's sums. ptab is
// level d-1's decision table, [Kp, W] with W = 4 or 5 + B (route.cuh).
// rec [n, 4]
// int32 and, for a partial hoist (Fh < F), bins_t [F-Fh, n_pad] in the bins'
// type are scratch the caller allocates (bins_t may be null when Fh == F).
// bin_bytes: 1 for uint8 bins, 2 for int16 bins; anything else is refused.
extern "C" int xgbt_hoisted_level(const void* bins, int bin_bytes, int n,
                                  int F, int B, const int8_t* onehot, int Fh,
                                  long long n_pad, const int32_t* pos_in,
                                  int32_t* pos_out, const int32_t* qgh,
                                  const float* ptab, int W, int Kp,
                                  int prev_offset, int K, int offset,
                                  long long* hist, void* rec, void* bins_t,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* r = static_cast<int4*>(rec);
  if (bin_bytes == 1)
    return launch(static_cast<const uint8_t*>(bins), n, F, B, onehot, Fh,
                  n_pad, pos_in, pos_out, qgh, ptab, W, Kp, prev_offset, K,
                  offset, hist, r, static_cast<uint8_t*>(bins_t), s);
  if (bin_bytes == 2)
    return launch(static_cast<const int16_t*>(bins), n, F, B, onehot, Fh,
                  n_pad, pos_in, pos_out, qgh, ptab, W, Kp, prev_offset, K,
                  offset, hist, r, static_cast<int16_t*>(bins_t), s);
  return (int)cudaErrorInvalidValue;
}

// Launch 1 of the level alone: the routed positions, the channel records
// and the feature-major unhoisted bins, as xgbt_hoisted_level writes them
// before its histogram launch.
extern "C" int xgbt_hoisted_route(const void* bins, int bin_bytes, int n,
                                  int F, int B, int Fh, long long n_pad,
                                  const int32_t* pos_in, int32_t* pos_out,
                                  const int32_t* qgh, const float* ptab,
                                  int W, int Kp, int prev_offset, int K,
                                  int offset, void* rec, void* bins_t,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* r = static_cast<int4*>(rec);
  if (bin_bytes == 1)
    return launch_route(static_cast<const uint8_t*>(bins), n, F, B, Fh, n_pad,
                        pos_in, pos_out, qgh, ptab, W, Kp, prev_offset, K,
                        offset, r, static_cast<uint8_t*>(bins_t), s);
  if (bin_bytes == 2)
    return launch_route(static_cast<const int16_t*>(bins), n, F, B, Fh, n_pad,
                        pos_in, pos_out, qgh, ptab, W, Kp, prev_offset, K,
                        offset, r, static_cast<int16_t*>(bins_t), s);
  return (int)cudaErrorInvalidValue;
}
