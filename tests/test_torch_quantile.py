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


# ---------------------------------------------------------------------------
# the quantile levels at a max_bin that is not a power of two
# ---------------------------------------------------------------------------

def _level_data(s, weighted):
    """2500 + 37 s rows of 5 features (5% NaN in three of them, heavy ties
    in one, and a column with 37 * 60 present values, so a level lands
    exactly on a unit-weight prefix sum) and hessian-like weights
    ``p (1 - p)``."""
    n = 2500 + 37 * s
    rng = np.random.RandomState(s)
    X = rng.randn(n, 5).astype(np.float32)
    X[:, 1] = np.round(X[:, 1] * 20)
    X[:, :3][rng.rand(n, 3) < 0.05] = np.nan
    X[37 * 60:, 4] = np.nan
    p = 1.0 / (1.0 + np.exp(-rng.randn(n)))
    w = (p * (1.0 - p)).astype(np.float32) if weighted else None
    return X, w


@pytest.mark.parametrize("B", [37, 100, 200, 1000])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuts_bitwise_at_max_bins_not_a_power_of_two(B, weighted):
    """The witness of the levels' rounding: the JAX package computes
    ``k / B * total`` as XLA folds it, ``(k * f32(1/B)) * total``; an exact
    division moves interior cuts by one sorted value wherever a level
    falls on (or a rounding away from) a prefix sum."""
    for s in range(6):
        X, w = _level_data(s, weighted)
        want = jq.compute_cuts(X, max_bin=B, weights=w)
        got = tq.compute_cuts(
            torch.from_numpy(X), max_bin=B,
            weights=None if w is None else torch.from_numpy(w))
        np.testing.assert_array_equal(got.values, np.asarray(want.values),
                                      f"rows {X.shape[0]}")
        np.testing.assert_array_equal(got.min_vals,
                                      np.asarray(want.min_vals))


def test_dmatrix_binned_at_100_bitwise():
    import xgboost_tpu as xgb
    import xgboost_tpu_torch as xgbt

    for s in range(6):
        X, _ = _level_data(s, False)
        want = xgb.DMatrix(X).get_binned(100)
        got = xgbt.DMatrix(X, device="cpu").get_binned(100)
        np.testing.assert_array_equal(got.cuts.values,
                                      np.asarray(want.cuts.values))
        np.testing.assert_array_equal(got.bins.numpy(),
                                      np.asarray(want.bins))


@pytest.mark.parametrize("B", [64, 256])
def test_main_path_levels_keep_their_bits(B):
    """At the main path's power-of-two ``max_bin`` the reciprocal is exact,
    so the levels are the exact quotient's bits and the cuts did not move
    with the rounding fix."""
    from xgboost_tpu_torch.data.sketch import _levels

    rng = np.random.RandomState(B)
    totals = np.concatenate([np.arange(1, 4097), rng.rand(4096) * 1e6,
                             rng.rand(4096)]).astype(np.float32)
    t = torch.from_numpy(totals)[:, None]
    exact = (torch.arange(1, B, dtype=torch.float32) / B) * t
    assert torch.equal(_levels(B - 1, B, t), exact)
