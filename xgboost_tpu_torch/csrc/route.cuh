// Row routing shared by the level kernels (kernel A, hist_level.cu, and
// kernel D, hoisted_level.cu): one row through level d-1's decision table,
// the rule of xgboost_tpu/tree/hist_kernel.py:_partition_tile and
// partition_apply_xla. Bins are read in their storage type T (uint8_t or
// int16_t); the missing bin is B.
//
// The table has W columns per node: W = 4 (is_split, feature, bin,
// default_left) for numerical trees, W = 5 + B with categorical features,
// where column 4 flags a categorical node and columns 5 .. 5+B-1 hold its
// right-going category set (1.0 = in the set). A missing bin follows
// default_left; a present bin goes left iff bin <= split bin at a
// numerical node, iff its column of the set is not set at a categorical
// node. The table is read through the read-only data cache: at depth 6 and
// B = 256 it is at most 32 x 261 floats, and each node's row is one
// contiguous run.

#pragma once

#include <stdint.h>

// Whether a table of width W fits the router: 4, or 5 + B.
inline bool route_width_ok(int W, int B) { return W == 4 || W == 5 + B; }

template <typename T>
__device__ __forceinline__ int route_row(const T* bins, int F, int B,
                                         const float* ptab, int W, int Kp,
                                         int prev_offset, long long r, int p) {
  const int lp = p - prev_offset;
  if (lp < 0 || lp >= Kp) return p;
  const float* row = ptab + (long long)W * lp;
  if (!(__ldg(row) > 0.5f)) return p;
  const int f = static_cast<int>(__ldg(row + 1));
  const int bv = static_cast<int>(bins[r * F + f]);
  bool goleft;
  if (bv >= B)
    goleft = __ldg(row + 3) > 0.5f;  // missing: default_left
  else if (W > 4 && __ldg(row + 4) > 0.5f)
    goleft = !(__ldg(row + 5 + bv) > 0.5f);  // in the set: right
  else
    goleft = bv <= static_cast<int>(__ldg(row + 2));
  return 2 * p + (goleft ? 1 : 2);
}
