// Kernel S: the strict-order prefix sum of seq_cumsum
// (xgboost_tpu_torch/tree/grow.py), one launch a call.
//
// Replaces no TPU kernel. The JAX package's seq_cumsum
// (xgboost_tpu/tree/grow.py) is a lax.scan, which XLA runs as one loop on
// the device; the port ran it as a Python loop of one add and one strided
// copy a bin, 2B launches a scan and two scans a level (512 launches a scan
// at B = 256), and that host dispatch paced the depthwise grower's
// _level_update. This kernel does the same arithmetic in one launch.
//
// Contract: x and out are contiguous float32 [R, B] (R the product of the
// leading axes). Each output row is ((0.0f + x0) + x1) + ...: the
// accumulator starts at +0.0f (so a leading -0.0 comes out +0.0, as in the
// loop), one round-to-nearest add a bin (__fadd_rn: never contracted,
// never reassociated), left to right. Only the rows run in parallel: the
// order within a row is the contract, so every result keeps the loop's bits.
//
// What bounds it on this card: not bytes. A level's scans read and write
// R x B x 4 bytes each way (6.6 MB at depth 5, F = 50, two lanes, ~2 us at
// 3.35 TB/s); the time is the launch and one serial chain of B dependent
// adds a row. Design: a block is one warp of 32 rows, a row a lane. The rows
// go through shared memory in chunks of 32 bins: a chunk is loaded with
// one 128-byte row segment an instruction (neighbouring lanes on
// neighbouring addresses), each lane scans its own row in the tile (padded
// to 33 columns, so the 32 lanes hit 32 banks), and the chunk is stored back
// the way it came. The next chunk's loads are issued into registers before
// the current chunk is scanned, so they are in flight during the chain.
// Any B >= 1 works: the ragged last chunk reads zeros past the row's end,
// which are added only after the row's last stored sum and never stored.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;  // rows a block: one warp, one row a lane
constexpr int kBins = 32;  // bins a staged chunk

__global__ void __launch_bounds__(kRows)
    seq_scan_kernel(const float* __restrict__ x, float* __restrict__ out,
                    long long R, int B) {
  __shared__ float tile[kRows][kBins + 1];
  const int lane = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, R - r0);
  const float* src = x + r0 * B;
  float* dst = out + r0 * B;
  float next[kRows];  // row i's bin c0 + lane of the chunk being fetched
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    next[i] = (i < rows && lane < B) ? __ldg(src + (long long)i * B + lane)
                                     : 0.0f;
  float acc = 0.0f;
  for (int c0 = 0; c0 < B; c0 += kBins) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) tile[i][lane] = next[i];
    __syncwarp();
    const int c1 = c0 + kBins;
    if (c1 < B) {
      const bool in = c1 + lane < B;
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        next[i] = (i < rows && in) ? __ldg(src + (long long)i * B + c1 + lane)
                                   : 0.0f;
    }
    // Past the row's end the tile holds zeros; they come only in the last
    // chunk, whose sums there are never stored, and acc is not read again.
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      acc = __fadd_rn(acc, tile[lane][j]);
      tile[lane][j] = acc;
    }
    __syncwarp();
    if (c0 + lane < B) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (i < rows) dst[(long long)i * B + c0 + lane] = tile[i][lane];
    }
    __syncwarp();
  }
}

}  // namespace

// x [R, B] float32 -> out [R, B] float32, each row's strict prefix sums.
extern "C" int xgbt_seq_scan(const void* x, void* out, long long R, int B,
                             void* stream) {
  if (R < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (R + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  seq_scan_kernel<<<(unsigned)blocks, kRows, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), R, B);
  return (int)cudaGetLastError();
}
