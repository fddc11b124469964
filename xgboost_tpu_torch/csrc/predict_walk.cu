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
// nvcc from contracting them into an FMA).
//
// The forest comes as one 16-byte record per node, built once when the
// forest is stacked (predictor/__init__.py:_pack_nodes, the counterpart of
// the TPU's _build_pred_tables): {cond (f32 bits; the leaf value at a
// leaf), feature | default_left << 30 | leaf << 31, left, right}. One
// vector load per step replaces five dependent loads, and the same records
// serve device-grown heap forests and forests loaded from JSON.
//
// What bounds it on this card. X is n*F*4 bytes (20 MB at 100k x 50, ~6 us
// at 3.35 TB/s) and the walk is n*T*depth steps of a compare and a select
// (at T = 500, depth 6, 100k rows: 3e8 steps, ~9 us at the 67 TFLOP/s f32
// rate). What held the first version far above that: five dependent
// device-memory loads per step, one read-modify-write of out per tree (no
// pointer was restrict, so each store reloaded the next tree's nodes), and
// a single chain of T*depth dependent loads per thread. The design:
// - the forest passes through shared memory in chunks of trees, staged by
//   cp.async into two buffers, so the next chunk arrives while the block
//   walks the current one; a node is one ld.shared.v4;
// - each thread walks kWalks trees at once (independent chains, so their
//   loads overlap) and adds their leaves in tree order; with one output
//   group the margin stays in a register;
// - X goes to shared memory when more than one tree reads it (T >=
//   kStageTrees), with 16-byte loads and 32-bit index arithmetic (at
//   T = 10, 100k x 50, on an H100 80GB HBM3 at 700 W: 0.047 ms reading X
//   from device memory, 0.022 staged; scripts/torch_walk_variants.py); a
//   single tree (each round's eval walk) reads its row's few features from
//   device memory directly;
// - the shared-memory opt-in is set once per device.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kRows = 256;                // rows (threads) per block
constexpr int kWalks = 4;                 // trees walked at once per thread
constexpr int kChunkBytes = 24 * 1024;    // one forest-chunk buffer
constexpr int kStageBytes = 64 * 1024;    // largest staged X tile
constexpr int kStageTrees = 2;            // stage X from this many trees on
constexpr int kMaxSmem = 2 * kChunkBytes + kStageBytes;
constexpr int kDefaultLeftBit = 30;  // bit 31: leaf (the record's sign)
constexpr int kFeatureMask = (1 << kDefaultLeftBit) - 1;

struct WalkArgs {
  const float* __restrict__ X;
  int n, F;
  const int4* __restrict__ nodes;  // [T, N] records
  const int32_t* __restrict__ tree_group;
  const float* __restrict__ tree_weight;
  int T, N, max_depth, G;
  int chunk_trees;  // trees per shared-memory chunk (0: walk from global)
  const float* __restrict__ base;  // [n, G]
  float* __restrict__ out;         // [n, G]
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One step of a walk: the child of `node` for the row x, or `node` itself
// at a leaf.
__device__ __forceinline__ int step(const int4 rec, const float* x, int node) {
  const float v = x[rec.y & kFeatureMask];
  const bool goleft =
      isnan(v) ? ((rec.y >> kDefaultLeftBit) & 1) : (v < __int_as_float(rec.x));
  const int next = goleft ? rec.z : rec.w;
  return rec.y < 0 ? node : next;
}

// Walk trees t .. t + W - 1, whose records start at nodes (tree-major, N
// per tree), and add each leaf x weight to its group in tree order.
template <int W, bool kOneGroup>
__device__ __forceinline__ void walk(const WalkArgs& a, const int4* nodes,
                                     int t, const float* x, float& acc,
                                     float* o) {
  int node[W];
#pragma unroll
  for (int w = 0; w < W; ++w) node[w] = 0;
  for (int s = 0; s < a.max_depth; ++s) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      node[w] = step(nodes[w * a.N + node[w]], x, node[w]);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const float leaf = __int_as_float(nodes[w * a.N + node[w]].x);
    const float v = __fmul_rn(leaf, __ldg(a.tree_weight + t + w));
    if (kOneGroup) {
      acc = __fadd_rn(acc, v);
    } else {
      const int g = __ldg(a.tree_group + t + w);
      o[g] = __fadd_rn(o[g], v);
    }
  }
}

template <bool kOneGroup>
__device__ __forceinline__ void walk_range(const WalkArgs& a,
                                           const int4* nodes, int t0, int t1,
                                           const float* x, float& acc,
                                           float* o) {
  int t = t0;
  for (; t + kWalks <= t1; t += kWalks)
    walk<kWalks, kOneGroup>(a, nodes + (t - t0) * a.N, t, x, acc, o);
  for (; t < t1; ++t)
    walk<1, kOneGroup>(a, nodes + (t - t0) * a.N, t, x, acc, o);
}

// chunk c of the forest -> buf, 16 bytes per cp.async
__device__ __forceinline__ void load_chunk(const WalkArgs& a, int4* buf,
                                           int c) {
  const int t0 = c * a.chunk_trees;
  const int trees = min(a.chunk_trees, a.T - t0);
  const int recs = trees * a.N;
  const int4* src = a.nodes + (size_t)t0 * a.N;
  for (int i = threadIdx.x; i < recs; i += kRows) cp_async16(buf + i, src + i);
  cp_async_commit();
}

template <bool kStageX, bool kOneGroup>
__global__ void __launch_bounds__(kRows, 2) walk_kernel(WalkArgs a) {
  extern __shared__ int4 smem[];
  const int chunk_recs = a.chunk_trees * a.N;  // records per buffer
  float* xs = reinterpret_cast<float*>(smem + 2 * chunk_recs);
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, a.n - row0);
  const int stride = a.F + 1;  // odd: rows of the tile start in other banks
  if (a.chunk_trees > 0) load_chunk(a, smem, 0);
  if (kStageX) {
    // rows*F floats from a 16-byte aligned start (row0*F*4 is a multiple
    // of kRows*4); 16-byte loads, then the last < 4 one by one
    const int total = rows * a.F;
    const float* src = a.X + (size_t)row0 * a.F;
    const int vecs = total >> 2;
    for (int i = threadIdx.x; i < vecs; i += kRows) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src) + i);
      const int e = 4 * i;
      int r = e / a.F, c = e - r * a.F;
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        xs[r * stride + c] = vs[k];
        if (++c == a.F) c = 0, ++r;
      }
    }
    for (int e = 4 * vecs + threadIdx.x; e < total; e += kRows) {
      const int r = e / a.F;
      xs[r * stride + (e - r * a.F)] = __ldg(src + e);
    }
  }
  const int r = row0 + threadIdx.x;
  const bool live = threadIdx.x < rows;
  const float* x = kStageX ? xs + threadIdx.x * stride
                           : a.X + (size_t)(live ? r : row0) * a.F;
  float acc = 0.0f;
  float* o = a.out + (size_t)(live ? r : row0) * a.G;
  if (!kOneGroup && live)
    for (int g = 0; g < a.G; ++g) o[g] = 0.0f;
  if (a.chunk_trees == 0) {
    if (kStageX) __syncthreads();
    if (live) walk_range<kOneGroup>(a, a.nodes, 0, a.T, x, acc, o);
  } else {
    const int chunks = (a.T + a.chunk_trees - 1) / a.chunk_trees;
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        load_chunk(a, smem + ((c + 1) & 1) * chunk_recs, c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int t0 = c * a.chunk_trees;
      if (live)
        walk_range<kOneGroup>(a, smem + (c & 1) * chunk_recs, t0,
                              min(a.T, t0 + a.chunk_trees), x, acc, o);
      __syncthreads();  // before the next iteration refills this buffer
    }
  }
  if (!live) return;
  const float* b = a.base + (size_t)r * a.G;
  if (kOneGroup) {
    o[0] = __fadd_rn(__ldg(b), acc);
  } else {
    for (int g = 0; g < a.G; ++g) o[g] = __fadd_rn(__ldg(b + g), o[g]);
  }
}

template <bool kStageX, bool kOneGroup>
cudaError_t allow_smem(int dev) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ULL << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<kStageX, kOneGroup>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <bool kStageX, bool kOneGroup>
int launch(const WalkArgs& a, unsigned blocks, size_t smem, cudaStream_t s) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaError_t err = allow_smem<kStageX, kOneGroup>(dev);
  if (err != cudaSuccess) return (int)err;
  walk_kernel<kStageX, kOneGroup><<<blocks, kRows, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// nodes: [T, N] 16-byte records (int32 [T, N, 4]); tree_group [T] int32;
// tree_weight [T] f32; base and out [n, G] f32. n < 2^31 / F.
extern "C" int xgbt_predict_margin(const float* X, int n, int F,
                                   const void* nodes,
                                   const int32_t* tree_group,
                                   const float* tree_weight, int T, int N,
                                   int max_depth, int G, const float* base,
                                   float* out, void* stream) {
  if (n < 0 || F < 1 || T < 1 || N < 1 || G < 1 ||
      (long long)n * F >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int tree_bytes = N * 16;
  int chunk_trees = kChunkBytes / tree_bytes;
  if (chunk_trees > T) chunk_trees = T;
  const bool stage = T >= kStageTrees &&
                     (size_t)kRows * (F + 1) * sizeof(float) <= kStageBytes;
  WalkArgs a{X, n, F, static_cast<const int4*>(nodes), tree_group,
             tree_weight, T, N, max_depth, G, chunk_trees, base, out};
  const size_t smem = 2 * (size_t)chunk_trees * tree_bytes +
                      (stage ? (size_t)kRows * (F + 1) * sizeof(float) : 0);
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage)
    return G == 1 ? launch<true, true>(a, blocks, smem, s)
                  : launch<true, false>(a, blocks, smem, s);
  return G == 1 ? launch<false, true>(a, blocks, smem, s)
                : launch<false, false>(a, blocks, smem, s);
}
