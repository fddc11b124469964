// Kernel C: the resident int8 one-hot of the bin matrix, built once per
// training matrix for the hoisted level route (kernel D, hoisted_level.cu).
//
// Replaces the TPU kernel xgboost_tpu/tree/hist_kernel.py:_build_onehot_pallas
// (body _build_onehot_body; oracle _build_onehot_xla). Its content is the
// TPU's: cell (row, f*B + b) is 1 exactly where bins[row, f] == b, for the
// first Fh features; the missing bin B gives an all-zero row.
//
// Layout. The TPU keeps it [n, Fh*B], the MXU's preferred operand. Here it
// feeds int8 mma.sync, whose B operand is K-major, and K is the row axis; the
// card's transposing loads (ldmatrix.trans, wgmma's transpose) handle only
// 16-bit types. So the one-hot is stored feature-major, out[f*B + b][r]
// with rows contiguous, [Fh*B, n_pad], and n is padded with zero columns to
// n_pad, a multiple of the MMA's K step (32), so the ragged edge is inert.
//
// What bounds it on this card: bytes. It reads n*Fh bins and writes
// n_pad*Fh*B bytes (3.2 GB at 1M x 50 x 64, ~0.97 ms at 3.35 TB/s). Design:
// a block stages a [features, 128 rows] tile of bins in shared memory,
// feature-major, and every thread writes 16 consecutive rows of one column
// with one 16-byte store, neighbouring threads on neighbouring addresses.
// The compare runs two bins per instruction (__vcmpeq2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;      // rows per block
constexpr int kFeats = 64;      // features staged per block
constexpr unsigned short kNone = 0xFFFFu;  // never a bin id below B

template <typename T>
__global__ void __launch_bounds__(kThreads)
    onehot_kernel(const T* __restrict__ bins, int n, int F, int Fh, int B,
                  long long n_pad, int8_t* __restrict__ out) {
  __shared__ __align__(16) unsigned short sb[kFeats * kRows];
  const long long r0 = (long long)blockIdx.x * kRows;
  const int f0 = blockIdx.y * kFeats;
  const int nf = min(kFeats, Fh - f0);
  for (int i = threadIdx.x; i < nf * kRows; i += kThreads) {
    const int ff = i / kRows, rr = i % kRows;
    const long long r = r0 + rr;
    unsigned short v = kNone;
    if (r < n) {
      const int b = static_cast<int>(__ldg(bins + r * F + f0 + ff));
      if (b >= 0 && b < B) v = static_cast<unsigned short>(b);
    }
    sb[ff * kRows + rr] = v;
  }
  __syncthreads();
  const int chunks = kRows / 16;
  const int work = nf * B * chunks;  // < 2^24: B <= 32767 for int16 bins
  for (int w = threadIdx.x; w < work; w += kThreads) {
    const int j = w % chunks;
    const int col = w / chunks;  // (ff, b) within the block
    const int ff = col / B, b = col % B;
    const long long r = r0 + 16LL * j;
    if (r >= n_pad) continue;  // n_pad is a multiple of 32: whole chunks
    const uint4* src = reinterpret_cast<const uint4*>(sb + ff * kRows + 16 * j);
    const uint4 lo = src[0], hi = src[1];
    const unsigned bb = static_cast<unsigned>(b) * 0x10001u;
    const unsigned w8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    unsigned o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned m0 = __vcmpeq2(w8[2 * k], bb);      // 0xffff per equal half
      const unsigned m1 = __vcmpeq2(w8[2 * k + 1], bb);
      o[k] = (m0 & 1u) | ((m0 >> 8) & 0x100u) | ((m1 & 1u) << 16) |
             ((m1 << 8) & 0x1000000u);
    }
    int8_t* dst = out + ((long long)(f0 + ff) * B + b) * n_pad + r;
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <typename T>
int launch(const T* bins, int n, int F, int Fh, int B, long long n_pad,
           int8_t* out, cudaStream_t s) {
  if (n_pad % 32 != 0 || n_pad < n || Fh > F || Fh < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n_pad + kRows - 1) / kRows),
            (unsigned)((Fh + kFeats - 1) / kFeats));
  onehot_kernel<T><<<grid, kThreads, 0, s>>>(bins, n, F, Fh, B, n_pad, out);
  return (int)cudaGetLastError();
}

}  // namespace

// bins [n, F] (bin_bytes 1: uint8, 2: int16) -> out [Fh*B, n_pad] int8.
extern "C" int xgbt_build_onehot(const void* bins, int bin_bytes, int n, int F,
                                 int Fh, int B, long long n_pad, int8_t* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch(static_cast<const uint8_t*>(bins), n, F, Fh, B, n_pad, out,
                  s);
  if (bin_bytes == 2)
    return launch(static_cast<const int16_t*>(bins), n, F, Fh, B, n_pad, out,
                  s);
  return (int)cudaErrorInvalidValue;
}
