// Kernel A: one level of the depthwise tpu_hist grower on Hopper.
//
// Replaces the TPU kernel xgboost_tpu/tree/hist_kernel.py:_fused_level_pallas
// (body _level_kernel, helpers _partition_tile and _grad_channels). Same
// contract as fused_level_xla: route every row through level d-1's decision
// table, then accumulate (g, h) per (feature, node, bin) for level d into
// hist [F, 2K, B] (g rows [0, K), h rows [K, 2K)), the missing bin excluded.
//
// It replaces the TPU's hoisted route to the same contract too. Where the
// int8 one-hot of the bins fits (max_bin 64 at 1M x 50, the main path),
// the TPU builds it once per run with _build_onehot_pallas (body
// _build_onehot_body) and runs every level through _hoisted_level_pallas
// (body _hoisted_kernel): the same partition, and the histogram as one
// [4K, rows] x [rows, F*B] matmul over the one-hot. The one-hot exists only
// to feed the MXU and does no arithmetic of its own; this kernel reads the
// uint8 bins and forms each row's one-hot bin index in registers.
// tests/test_torch_hist_kernel.py holds the plain version of this kernel
// against both TPU routes (Pallas interpret mode).
//
// Partition and histogram are ONE kernel, as on the TPU. The grid is
// (row chunks) x (feature tiles); every block re-routes its rows (one table
// lookup and one bin read per row), and only the blocks of feature tile 0
// write the new positions.
//
// Determinism. The TPU kernel is deterministic by construction (an MXU
// matmul per tile, accumulated in grid order). f32 atomicAdd is not: its
// order changes from run to run. This kernel accumulates fixed-point
// integers instead, as the reference gpu_hist does
// (gpu_hist/histogram.cu:81-120): the caller quantises each gradient lane
// with a power-of-two scale (|q| <= 2^30, int32), the kernel adds the
// integers with 64-bit atomics, and the caller dequantises once. Integer
// addition is associative, so any launch order gives the same bits, and the
// plain PyTorch version (index_add_ over int64) gives the same bits too.
//
// What bounds it on this card. The bytes a level must move are the uint8
// bins (n*F), the positions in and out (8n) and the quantised gradients
// (8n): about 62 MB at 1M x 50, ~19 us at 3.35 TB/s. The real limit is the
// 2*n*F 64-bit shared-memory atomics, plus the flush of each block's tile to
// device memory. Design against that: a block keeps a [features-in-tile,
// 2K, B] int64 tile in shared memory (up to the 227 KB opt-in limit), so
// device-memory atomics happen once per non-zero cell per block, not once
// per (row, feature). Where one feature's [2K, B] tile does not fit, the
// kernel adds straight into device memory (same integers, same bits).
//
// Bins are read in their uint8 storage type; missing is bin id B.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;  // target grid size, in blocks per SM

struct LevelArgs {
  const uint8_t* bins;
  int n, F, B;
  const int32_t* pos_in;
  int32_t* pos_out;
  const int32_t* qgh;  // [n, 2] quantised (g, h)
  const float* ptab;   // [Kp, 4]: is_split, feature, bin, default_left
  int Kp, prev_offset, K, offset;
  unsigned long long* hist;  // [F, 2K, B] int64, zeroed by the caller
  long long rows_per_block;
  int feats_per_tile;
};

// One row through level d-1's decision: the same rule as
// hist_kernel.py:_partition_tile / partition_apply_xla.
__device__ __forceinline__ int route(const LevelArgs& a, long long r, int p) {
  const int lp = p - a.prev_offset;
  if (lp < 0 || lp >= a.Kp) return p;
  const float* row = a.ptab + 4 * lp;
  if (!(row[0] > 0.5f)) return p;
  const int f = static_cast<int>(row[1]);
  const int split_bin = static_cast<int>(row[2]);
  const bool default_left = row[3] > 0.5f;
  const int bv = a.bins[r * a.F + f];
  const bool goleft = (bv >= a.B) ? default_left : (bv <= split_bin);
  return 2 * p + (goleft ? 1 : 2);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) level_kernel(LevelArgs a) {
  extern __shared__ unsigned long long tile[];
  const int f0 = blockIdx.y * a.feats_per_tile;
  const int f1 = min(a.F, f0 + a.feats_per_tile);
  const long long K2B = 2LL * a.K * a.B;
  const long long cells = (long long)(f1 - f0) * K2B;
  unsigned long long* acc = kShared ? tile : a.hist + f0 * K2B;
  if (kShared) {
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) tile[c] = 0ull;
    __syncthreads();
  }
  const long long r0 = (long long)blockIdx.x * a.rows_per_block;
  const long long r1 = min((long long)a.n, r0 + a.rows_per_block);
  const long long hoff = (long long)a.K * a.B;  // g rows -> h rows
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    int p = a.pos_in[r];
    if (a.Kp > 0) p = route(a, r, p);
    if (blockIdx.y == 0) a.pos_out[r] = p;
    const int local = p - a.offset;
    if (local < 0 || local >= a.K) continue;
    // two's-complement: adding the unsigned image adds the signed value
    const unsigned long long qg =
        static_cast<unsigned long long>(static_cast<long long>(a.qgh[2 * r]));
    const unsigned long long qh = static_cast<unsigned long long>(
        static_cast<long long>(a.qgh[2 * r + 1]));
    const uint8_t* brow = a.bins + r * a.F;
    for (int f = f0; f < f1; ++f) {
      const int b = brow[f];
      if (b >= a.B) continue;  // missing: recovered by the caller
      const long long cg = ((long long)(f - f0) * 2 * a.K + local) * a.B + b;
      atomicAdd(acc + cg, qg);
      atomicAdd(acc + cg + hoff, qh);
    }
  }
  if (kShared) {
    __syncthreads();
    unsigned long long* dst = a.hist + f0 * K2B;
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) {
      const unsigned long long v = tile[c];
      if (v != 0ull) atomicAdd(dst + c, v);
    }
  }
}

}  // namespace

extern "C" int xgbt_fused_level(const uint8_t* bins, int n, int F, int B,
                                const int32_t* pos_in, int32_t* pos_out,
                                const int32_t* qgh, const float* ptab, int Kp,
                                int prev_offset, int K, int offset,
                                long long* hist, void* stream) {
  int dev = 0, sms = 0, smem_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const long long feat_bytes = 2LL * K * B * (long long)sizeof(long long);
  int fpt = (int)(smem_optin / feat_bytes);
  const bool shared = fpt > 0;
  if (!shared || fpt > F) fpt = F;
  const int ftiles = (F + fpt - 1) / fpt;
  long long row_blocks = ((long long)sms * kBlocksPerSm + ftiles - 1) / ftiles;
  const long long max_row_blocks = ((long long)n + kThreads - 1) / kThreads;
  if (row_blocks > max_row_blocks) row_blocks = max_row_blocks;
  if (row_blocks < 1) row_blocks = 1;
  long long rpb = ((long long)n + row_blocks - 1) / row_blocks;
  rpb = ((rpb + kThreads - 1) / kThreads) * kThreads;
  if (rpb < kThreads) rpb = kThreads;

  LevelArgs a{bins, n, F, B, pos_in, pos_out, qgh, ptab, Kp, prev_offset, K,
              offset, reinterpret_cast<unsigned long long*>(hist), rpb, fpt};
  dim3 grid((unsigned)row_blocks, (unsigned)ftiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    const size_t smem = (size_t)fpt * (size_t)feat_bytes;
    cudaError_t err = cudaFuncSetAttribute(
        level_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    level_kernel<true><<<grid, kThreads, smem, s>>>(a);
  } else {
    level_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
