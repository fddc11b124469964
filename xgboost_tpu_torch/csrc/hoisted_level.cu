// Kernel D: one level of the depthwise tpu_hist grower over the resident
// int8 one-hot (the hoisted route), on the tensor cores.
//
// Replaces the TPU kernel xgboost_tpu/tree/hist_kernel.py:_hoisted_level_pallas
// (body _hoisted_kernel, helpers _partition_tile and _grad_channels). Same
// contract as kernel A (hist_level.cu) and fused_level_xla: route every row
// through level d-1's decision table, then accumulate (g, h) per
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
// Shape of the work. Launch 1 routes every row once and writes the new
// positions. Launch 2 has a grid of (column tiles) x (row chunks) x (slot
// blocks). A column tile is 64 one-hot columns: either 64 columns of the
// resident one-hot (the hoisted features) or 64 bins of one unhoisted
// feature, whose one-hot the block builds in shared memory from the bins
// (the construct tiles). A slot block is 64 (lane, node) slots, so K <= 32
// takes one. Per stage of 128 data rows a block holds in shared memory the
// one-hot tile [64 columns][128 rows] and the channel tile [256 rows][128
// data rows], both K-major with a 16-byte pad per row so the 32-bit
// fragment loads hit 32 distinct banks; eight warps each own 2 slot groups x
// 32 columns, 64 s32 accumulators per thread. The next stage's one-hot tile
// is loaded into registers while the tensor cores run on this one. Channel
// and construct tiles are sparse (one node per data row), so a thread
// clears only the bytes it set in the previous stage.
//
// What bounds it on this card. Reading the one-hot, n_pad*Fh*B bytes (3.2 GB
// at 1M x 50 x 64: ~0.96 ms at 3.35 TB/s), against 2*8K*n*Fh*B int8
// operations (~0.83 ms at K = 32 at 1979 TOP/s); the per-row inputs (8 bytes
// of q, 4 of position) are re-read by every column tile from L2. A plain
// mma.sync design; wgmma, TMA and a deeper pipeline are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "route.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;              // data rows per shared-memory stage
constexpr int kStride = kRows + 16;     // bytes per shared-memory tile row
constexpr int kSlots = 64;              // (lane, node) slots per block
constexpr int kARows = 4 * kSlots;      // channel rows: 4 digits per slot
constexpr int kCols = 64;               // columns per block
constexpr int kSmem = (kARows + kCols) * kStride;
constexpr long long kMaxRowsPerBlock = 1LL << 23;  // s32 digit sums stay exact

template <typename T>
__global__ void __launch_bounds__(kThreads)
    route_kernel(const T* __restrict__ bins, int n, int F, int B,
                 const int32_t* __restrict__ pos_in, int32_t* pos_out,
                 const float* __restrict__ ptab, int Kp, int prev_offset) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  int p = pos_in[r];
  if (Kp > 0) p = route_row(bins, F, B, ptab, Kp, prev_offset, r, p);
  pos_out[r] = p;
}

template <typename T>
struct HoistArgs {
  const T* bins;
  int n, F, B;
  const int8_t* onehot;  // [Fh*B, n_pad]
  int Fh;
  long long n_pad;
  int hoisted_tiles, tiles_per_feature;
  const int32_t* pos;  // routed positions
  const int32_t* qgh;  // [n, 2]
  int K, offset;
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    hoisted_kernel(HoistArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* As = smem;                      // [kARows][kStride]
  unsigned char* Bs = smem + kARows * kStride;   // [kCols][kStride]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
  const int wm = warp >> 1, wn = warp & 1;  // slot groups 2wm, 2wm+1; cols 32wn..
  const int s0 = blockIdx.z * kSlots;
  const int K2 = 2 * a.K;
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

  for (int i = tid; i < kSmem / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);

  // one-hot tile of a stage: 64 columns x 8 chunks of 16 rows, two per thread
  uint4 nxt[2];
  auto load_tile = [&](long long rs) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int cid = tid + u * kThreads;
      const int col = cid >> 3, j = cid & 7;
      const long long r = rs + 16 * j;
      nxt[u] = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + col < Q && r < a.n_pad)
        nxt[u] = __ldg(reinterpret_cast<const uint4*>(
            a.onehot + (long long)(c0 + col) * a.n_pad + r));
    }
  };
  if (hoisted && r_begin < r_end) load_tile(r_begin);

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
  for (int pi = 0; pi < 2; ++pi) active[pi] = s0 + (2 * wm + pi) * 8 < K2;

  // what this thread set in the sparse tiles last stage (-1: nothing)
  const int i_row = tid & (kRows - 1), lane = tid >> 7;
  int a_slot = -1, b_off = -1;

  for (long long rs = r_begin; rs < r_end; rs += kRows) {
    __syncthreads();  // the previous stage's fragments are read
    if (hoisted) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cid = tid + u * kThreads;
        *reinterpret_cast<uint4*>(Bs + (cid >> 3) * kStride + 16 * (cid & 7)) =
            nxt[u];
      }
    } else if (lane == 0) {
      if (b_off >= 0) Bs[b_off] = 0;
      b_off = -1;
      const long long r = rs + i_row;
      if (r < a.n) {
        const int v = static_cast<int>(a.bins[r * a.F + fcon]) - b0;
        if (v >= 0 && v < kCols && v + b0 < a.B) {
          b_off = v * kStride + i_row;
          Bs[b_off] = 1;
        }
      }
    }
    if (a_slot >= 0) {
#pragma unroll
      for (int dg = 0; dg < 4; ++dg)
        As[channel_row(a_slot, dg) * kStride + i_row] = 0;
    }
    a_slot = -1;
    {
      const long long r = rs + i_row;
      if (r < a.n) {
        const int local = a.pos[r] - a.offset;
        const int s = lane * a.K + local - s0;
        if (local >= 0 && local < a.K && s >= 0 && s < kSlots) {
          int q = a.qgh[2 * r + lane];
          // balanced base-256 digits, each in [-128, 127] (the last <= 65)
#pragma unroll
          for (int dg = 0; dg < 4; ++dg) {
            const int d = (dg < 3) ? static_cast<int>(static_cast<int8_t>(q & 0xff))
                                   : q;
            As[channel_row(s, dg) * kStride + i_row] =
                static_cast<unsigned char>(static_cast<int8_t>(d));
            q = (q - d) >> 8;
          }
          a_slot = s;
        }
      }
    }
    __syncthreads();
    if (hoisted && rs + kRows < r_end) load_tile(rs + kRows);
    const int ksteps = static_cast<int>(min((long long)kRows / 32,
                                            (r_end - rs + 31) / 32));
    for (int ks = 0; ks < ksteps; ++ks) {
      const int kk = ks * 32 + 4 * tq;
      unsigned bf[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const unsigned char* bp = Bs + (wn * 32 + ni * 8 + g) * kStride + kk;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(bp);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(bp + 16);
      }
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        if (!active[pi]) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int base = 16 * (2 * (2 * wm + pi) + h);
          const unsigned char* ap = As + (base + g) * kStride + kk;
          unsigned af[4];
          af[0] = *reinterpret_cast<const unsigned*>(ap);
          af[1] = *reinterpret_cast<const unsigned*>(ap + 8 * kStride);
          af[2] = *reinterpret_cast<const unsigned*>(ap + 16);
          af[3] = *reinterpret_cast<const unsigned*>(ap + 8 * kStride + 16);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_s8(acc[pi][ni][h], af, bf[ni][0], bf[ni][1]);
        }
      }
    }
  }

  // combine the digit sums and add them to hist
#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const int s = s0 + (2 * wm + pi) * 8 + g;
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
int launch(const T* bins, int n, int F, int B, const int8_t* onehot, int Fh,
           long long n_pad, const int32_t* pos_in, int32_t* pos_out,
           const int32_t* qgh, const float* ptab, int Kp, int prev_offset,
           int K, int offset, long long* hist, cudaStream_t s) {
  if (n_pad % 32 != 0 || n_pad < n || Fh < 1 || Fh > F || K < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  route_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    s>>>(bins, n, F, B, pos_in, pos_out, ptab, Kp,
                         prev_offset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int hoisted_tiles = (Fh * B + kCols - 1) / kCols;
  const int tpf = (B + kCols - 1) / kCols;
  const int tiles = hoisted_tiles + (F - Fh) * tpf;
  const int slot_blocks = (2 * K + kSlots - 1) / kSlots;
  // about eight blocks per SM in all, in whole stages, and few enough rows
  // per block that the s32 digit sums cannot overflow
  long long chunks = (8LL * sms + (long long)tiles * slot_blocks - 1) /
                     ((long long)tiles * slot_blocks);
  const long long max_chunks = ((long long)n + kRows - 1) / kRows;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  long long rpb = ((long long)n + chunks - 1) / chunks;
  rpb = ((rpb + kRows - 1) / kRows) * kRows;
  if (rpb > kMaxRowsPerBlock) rpb = kMaxRowsPerBlock;
  chunks = ((long long)n + rpb - 1) / rpb;

  HoistArgs<T> args{bins, n, F, B, onehot, Fh, n_pad, hoisted_tiles, tpf,
                    pos_out, qgh, K, offset,
                    reinterpret_cast<unsigned long long*>(hist), rpb};
  dim3 grid((unsigned)tiles, (unsigned)chunks, (unsigned)slot_blocks);
  hoisted_kernel<T><<<grid, kThreads, kSmem, s>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// One level over the hoisted one-hot: pos_out gets the routed positions,
// hist [F, 2K, B] int64 (zeroed by the caller) the level's sums.
// bin_bytes: 1 for uint8 bins, 2 for int16 bins; anything else is refused.
extern "C" int xgbt_hoisted_level(const void* bins, int bin_bytes, int n,
                                  int F, int B, const int8_t* onehot, int Fh,
                                  long long n_pad, const int32_t* pos_in,
                                  int32_t* pos_out, const int32_t* qgh,
                                  const float* ptab, int Kp, int prev_offset,
                                  int K, int offset, long long* hist,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch(static_cast<const uint8_t*>(bins), n, F, B, onehot, Fh,
                  n_pad, pos_in, pos_out, qgh, ptab, Kp, prev_offset, K,
                  offset, hist, s);
  if (bin_bytes == 2)
    return launch(static_cast<const int16_t*>(bins), n, F, B, onehot, Fh,
                  n_pad, pos_in, pos_out, qgh, ptab, Kp, prev_offset, K,
                  offset, hist, s);
  return (int)cudaErrorInvalidValue;
}
