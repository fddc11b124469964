// Kernel B: forest walk -> per-group margins on Hopper.
//
// Replaces the TPU kernel xgboost_tpu/predictor/__init__.py:
// _predict_margin_pallas (body _pred_kernel, tables from
// _build_pred_tables). Same function as the JAX XLA walk
// (_predict_margin_impl): for every row and every tree, walk at most
// max_depth steps (go left iff x < cond, NaN -> default_left), then add
// leaf value x tree weight into the tree's output group; out = base + sum.
//
// One thread owns one row, in the manner of the reference's
// gpu_predictor.cu:286, so the per-group sum needs no atomics and runs in
// tree order: deterministic, and the same association as the plain PyTorch
// version (a product rounded, then a sum rounded: __fmul_rn/__fadd_rn keep
// nvcc from contracting them into an FMA). The walk reads the forest's own
// left/right/feature/cond/default_left arrays in f32 (the TPU's three-term
// bf16 table exists only for its matrix unit), so the same kernel serves
// device-grown heap forests and forests loaded from JSON.
//
// What bounds it on this card. X is n*F*4 bytes (20 MB at 100k x 50, 200 MB
// at 1M x 50, ~60 us at 3.35 TB/s); the walk is T*depth dependent loads per
// row. Design against that: a block first copies its 128 rows of X into
// shared memory with coalesced loads, so each row is read from device memory
// once whatever the number of trees; the node arrays are small and shared
// by every thread, so they stay in L1/L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;               // rows (threads) per block
constexpr int kStageBytes = 96 * 1024;   // largest staged X tile

struct WalkArgs {
  const float* X;
  int n, F;
  const int32_t* left;
  const int32_t* right;
  const int32_t* feature;
  const float* cond;
  const uint8_t* default_left;
  const int32_t* tree_group;
  const float* tree_weight;
  int T, N, max_depth, G;
  const float* base;  // [n, G]
  float* out;         // [n, G]
};

template <bool kStage>
__global__ void __launch_bounds__(kRows) walk_kernel(WalkArgs a) {
  extern __shared__ float xs[];  // [kRows, F + 1] (padded against conflicts)
  const long long row0 = (long long)blockIdx.x * kRows;
  const int stride = a.F + 1;
  if (kStage) {
    const long long rows = min((long long)kRows, (long long)a.n - row0);
    const long long total = rows * a.F;
    const float* src = a.X + row0 * a.F;
    for (long long i = threadIdx.x; i < total; i += blockDim.x) {
      xs[(i / a.F) * stride + (i % a.F)] = src[i];
    }
    __syncthreads();
  }
  const long long r = row0 + threadIdx.x;
  if (r >= a.n) return;
  const float* x = kStage ? xs + threadIdx.x * stride : a.X + r * a.F;
  float* o = a.out + r * a.G;
  for (int g = 0; g < a.G; ++g) o[g] = 0.0f;
  for (int t = 0; t < a.T; ++t) {
    const long long tb = (long long)t * a.N;
    int node = 0;
    for (int s = 0; s < a.max_depth; ++s) {
      const int l = a.left[tb + node];
      if (l < 0) break;  // leaf
      const float v = x[a.feature[tb + node]];
      const bool goleft =
          isnan(v) ? (a.default_left[tb + node] != 0) : (v < a.cond[tb + node]);
      node = goleft ? l : a.right[tb + node];
    }
    const int g = a.tree_group[t];
    o[g] = __fadd_rn(o[g], __fmul_rn(a.cond[tb + node], a.tree_weight[t]));
  }
  const float* b = a.base + r * a.G;
  for (int g = 0; g < a.G; ++g) o[g] = __fadd_rn(b[g], o[g]);
}

}  // namespace

extern "C" int xgbt_predict_margin(
    const float* X, int n, int F, const int32_t* left, const int32_t* right,
    const int32_t* feature, const float* cond, const uint8_t* default_left,
    const int32_t* tree_group, const float* tree_weight, int T, int N,
    int max_depth, int G, const float* base, float* out, void* stream) {
  WalkArgs a{X, n, F, left, right, feature, cond, default_left, tree_group,
             tree_weight, T, N, max_depth, G, base, out};
  const unsigned blocks = (unsigned)(((long long)n + kRows - 1) / kRows);
  if (blocks == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)kRows * (size_t)(F + 1) * sizeof(float);
  if (smem <= (size_t)kStageBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    walk_kernel<true><<<blocks, kRows, smem, s>>>(a);
  } else {
    walk_kernel<false><<<blocks, kRows, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
