// Row routing shared by the level kernels (kernel A, hist_level.cu, and
// kernel D, hoisted_level.cu): one row through level d-1's decision table,
// the rule of xgboost_tpu/tree/hist_kernel.py:_partition_tile and
// partition_apply_xla. Bins are read in their storage type T (uint8_t or
// int16_t); the missing bin is B.

#pragma once

#include <stdint.h>

template <typename T>
__device__ __forceinline__ int route_row(const T* bins, int F, int B,
                                         const float* ptab, int Kp,
                                         int prev_offset, long long r, int p) {
  const int lp = p - prev_offset;
  if (lp < 0 || lp >= Kp) return p;
  const float* row = ptab + 4 * lp;
  if (!(row[0] > 0.5f)) return p;
  const int f = static_cast<int>(row[1]);
  const int split_bin = static_cast<int>(row[2]);
  const bool default_left = row[3] > 0.5f;
  const int bv = static_cast<int>(bins[r * F + f]);
  const bool goleft = (bv >= B) ? default_left : (bv <= split_bin);
  return 2 * p + (goleft ? 1 : 2);
}
