"""Port parity: quantile cuts and bins against the JAX package, bit for bit.

The same numpy inputs (made from a seed) go through ``xgboost_tpu``'s
``compute_cuts`` / ``bin_matrix`` and ``xgboost_tpu_torch``'s on the CPU;
cuts and bins must be identical, with NaNs, at B = 16 and 64, with and
without row weights (weighted rows make the CDF non-integer, so only a
left-to-right f32 accumulation matches).
"""

import numpy as np
import pytest
import torch

from xgboost_tpu.data import quantile as jq
from xgboost_tpu_torch.data import quantile as tq

torch.set_num_threads(1)


def _data(seed, n=3000, F=7, nan_frac=0.05):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[:, 1] = np.round(X[:, 1] * 3)  # heavy ties
    X[:, 2] = rng.exponential(size=n).astype(np.float32)
    X[rng.rand(n, F) < nan_frac] = np.nan
    X[:, 3] = np.nan  # an all-missing feature
    return X, rng


@pytest.mark.parametrize("B", [16, 64])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuts_and_bins_bit_identical(B, weighted):
    X, rng = _data(B + weighted)
    w = rng.uniform(0.1, 3.0, size=X.shape[0]).astype(np.float32) \
        if weighted else None
    want = jq.compute_cuts(X, max_bin=B, weights=w)
    got = tq.compute_cuts(torch.from_numpy(X), max_bin=B,
                          weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    np.testing.assert_array_equal(got.min_vals, np.asarray(want.min_vals))

    jb = np.asarray(jq.bin_matrix(X, want))
    tb = tq.bin_matrix(torch.from_numpy(X), got).numpy()
    assert tb.dtype == np.uint8 and jb.dtype == np.uint8
    np.testing.assert_array_equal(tb, jb)
    assert (tb[np.isnan(X)] == B).all()


def test_values_on_a_cut_bin_like_the_predictor_routes():
    """bin <= b  <=>  x < cut[b]: a value sitting exactly on a cut lands in
    the bin above it, in both packages."""
    X, _ = _data(3, n=1000)
    cuts = tq.compute_cuts(torch.from_numpy(X), max_bin=16)
    on = np.tile(cuts.values[:, 4][None, :], (5, 1)).astype(np.float32)
    tb = tq.bin_matrix(torch.from_numpy(on), cuts).numpy()
    jb = np.asarray(jq.bin_matrix(on, jq.HistogramCuts(cuts.values,
                                                       cuts.min_vals)))
    np.testing.assert_array_equal(tb, jb)
    finite = ~np.isnan(on[0])
    dup = cuts.values[:, 4] == cuts.values[:, 5]
    # a value on cut 4 is not < cut 4, so it is past bin 4
    assert (tb[0][finite & ~dup] >= 5).all()


def test_storage_dtype_matches():
    for B in (16, 64, 254, 255, 300):
        assert np.dtype(jq.storage_dtype(B)).itemsize == \
            torch.empty(0, dtype=tq.storage_dtype(B)).element_size()
