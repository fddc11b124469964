"""Port parity: ``updater="grow_local_histmaker"`` against the JAX package.

The per-node sketch. ``segmented_weighted_cuts`` on one column (8%
missing, rows outside every segment, an empty segment) and
``_level_cuts_and_bins`` on a whole level (2048 x 6 rows, nodes of a real
tree) against the JAX functions, with hessians on a 1/64 grid: every
prefix sum of them is exact in float32. Cuts and bins equal exactly.
With continuous (``binary:logistic``) hessians, every level of 2 rounds on
six seeds at ``max_bin`` 37, 64, 100 and 256: the cuts and bins are the
JAX package's bit for bit (float32 sums rounded as XLA:CPU rounds them),
and the trees equal its trees but for one tie in gain.

The grower. ``grow_tree_local`` of both packages on the same raw rows, the
same 1/64-grid gradients (so the JAX package's float histograms and the
port's fixed-point ones hold the same sums) and the same key: the heap
arrays (split or not after gamma pruning, features, split bins and
conditions, default directions, node sums) equal exactly; weights, loss
changes and the rows' leaf values within rtol 1e-6. Cases: depth 4 and 6,
row and column sampling, monotone and interaction constraints, gamma
pruning.

Training. 3 rounds of ``train`` (``reg:squarederror``, whose hessians are
the row weights, here on a 1/64 grid, so the per-node sketches are exact in
both packages; the gradients are continuous) with the held-out rows
evaluated: the same trees with ``tests/test_torch_lossguide.py``'s
tolerances (structure and split conditions exact, ``default_left`` where a
training row with a missing value reaches the node, leaf values within
rtol 1e-5 and atol 5e-5), margins within the same, the eval history within
1e-6. The JAX package's refusals, with its exception types and messages:
categorical features and ``grow_policy="lossguide"``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from test_torch_lossguide import TOL, _assert_same_trees, _margins, _trees
from xgboost_tpu.tree import grow as jgrow
from xgboost_tpu.tree import grow_local as jgl
from xgboost_tpu.tree.param import SplitParams as JSplitParams
from xgboost_tpu_torch import threefry as tf
from xgboost_tpu_torch.tree import grow as tgrow
from xgboost_tpu_torch.tree import grow_local as tgl
from xgboost_tpu_torch.tree.param import SplitParams as TSplitParams

torch.set_num_threads(1)

N, F = 2048, 6


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(seed, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    return X


def _grads(seed, n=N):
    """g in [-2, 2] and h in [0.1, 1], on a 1/64 grid."""
    rng = np.random.RandomState(seed)
    return (rng.randint(-128, 129, n).astype(np.float32) / 64,
            rng.randint(6, 65, n).astype(np.float32) / 64)


def test_segmented_weighted_cuts_matches_jax():
    rng = np.random.RandomState(4)
    col = rng.randn(N).astype(np.float32)
    col[rng.rand(N) < 0.08] = np.nan
    _, h = _grads(5)
    seg = rng.randint(-1, 6, N).astype(np.int32)  # -1 and 5: outside K = 5
    seg[seg == 3] = 2  # segment 3 empty
    for K, B in ((5, 8), (5, 33)):
        want = jgl.segmented_weighted_cuts(jnp.asarray(col), jnp.asarray(h),
                                           jnp.asarray(seg), K, B)
        got = tgl.segmented_weighted_cuts(_t(col), _t(h), _t(seg), K, B)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tuple(got.shape) == (K, B)


def test_level_cuts_and_bins_match_jax():
    X = _rows(6)
    _, h = _grads(7)
    # level 2 of a tree: rows at nodes 3..6 (local 0..3) or at leaves above
    pos = np.random.RandomState(8).randint(1, 7, N)
    seg = np.where(pos >= 3, pos - 3, -1).astype(np.int32)
    jc, jb = jgl._level_cuts_and_bins(jnp.asarray(X), jnp.asarray(h),
                                      jnp.asarray(seg), 4, 16)
    tc, tb = tgl._level_cuts_and_bins(_t(X), _t(h), _t(seg), 4, 16)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tb.dtype == torch.int32 and tuple(tc.shape) == (4, F, 16)


GROW_CASES = {
    "depth4": dict(max_depth=4),
    "depth6": dict(max_depth=6),
    "sampled": dict(max_depth=4, subsample=0.8, colsample_bytree=0.8,
                    colsample_bylevel=0.8, colsample_bynode=0.7),
    "monotone": dict(max_depth=4, monotone=(1, -1, 0, 0, 1, 0)),
    "interaction": dict(max_depth=4, interaction=((0, 1), (2, 3, 4), (5,))),
    "gamma": dict(max_depth=5),
}


@pytest.mark.parametrize("case", sorted(GROW_CASES))
def test_grow_tree_local_matches_jax(case):
    X = _rows(0)
    g, h = _grads(1)
    gamma, eta, max_bin = (2.0 if case == "gamma" else 0.0), 0.3, 16
    split = dict(reg_lambda=1.0, min_child_weight=0.5, min_split_loss=gamma)
    kw = GROW_CASES[case]
    jcfg = jgrow.GrowParams(split=JSplitParams(**split), **kw)
    tcfg = tgrow.GrowParams(split=TSplitParams(**split), **kw)
    jt = jgl.grow_tree_local(jnp.asarray(X), jnp.asarray(g), jnp.asarray(h),
                             jax.random.PRNGKey(3), jcfg, max_bin)
    tt = tgl.grow_tree_local(_t(X), _t(g), _t(h), tcfg, max_bin, eta, gamma,
                             key=tf.prng_key(3))
    pruned = jgrow.prune_heap(np.asarray(jt.is_split), np.asarray(jt.loss_chg),
                              gamma)
    np.testing.assert_array_equal(tt.keep.numpy(), pruned)
    assert pruned.any() and (gamma == 0.0
                             or (pruned != np.asarray(jt.is_split)).any())
    for name in ("feature", "split_bin", "split_cond", "default_left",
                 "node_g", "node_h"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    for mine, theirs in (("node_weight", "node_weight"),
                         ("loss_chg", "loss_chg")):
        np.testing.assert_allclose(getattr(tt, mine).numpy(),
                                   np.asarray(getattr(jt, theirs)),
                                   rtol=1e-6, err_msg=mine)
    lmap = jgrow.leaf_value_map(pruned, np.asarray(jt.node_weight), eta)
    np.testing.assert_allclose(tt.delta.numpy(),
                               lmap[np.asarray(jt.positions)], rtol=1e-6)


BASE = {"objective": "reg:squarederror", "max_depth": 4, "max_bin": 16,
        "eta": 0.3, "updater": "grow_local_histmaker",
        "eval_metric": ["rmse", "mae"]}


@pytest.fixture(scope="module")
def trained():
    X = _rows(9, 2560)
    rng = np.random.RandomState(10)
    y = (np.nan_to_num(X) @ rng.randn(F) + 0.3 * rng.randn(len(X))
         ).astype(np.float32)
    w = rng.randint(16, 129, len(X)).astype(np.float32) / 64
    Xt, yt, wt, Xv, yv = X[:N], y[:N], w[:N], np.nan_to_num(X[N:]), y[N:]
    jres, tres = {}, {}
    jb = xgb.train(BASE, xgb.DMatrix(Xt, label=yt, weight=wt), 3,
                   evals=[(xgb.DMatrix(Xv, label=yv), "val")],
                   evals_result=jres, verbose_eval=False)
    tb = xgbt.train(BASE, xgbt.DMatrix(Xt, yt, weight=wt, device="cpu"), 3,
                    evals=[(xgbt.DMatrix(Xv, yv, device="cpu"), "val")],
                    evals_result=tres, verbose_eval=False)
    return Xt, Xv, jb, tb, jres, tres


def test_train_matches_jax(trained):
    X, Xv, jb, tb, jres, tres = trained
    _assert_same_trees(_trees(json.loads(jb.save_raw())),
                       _trees(tb.save_json()), X)
    for rows in (X, Xv):
        np.testing.assert_allclose(_margins(tb, rows), _margins(jb, rows),
                                   rtol=1e-5, atol=TOL)
    for m in ("rmse", "mae"):
        np.testing.assert_allclose(np.rint(np.asarray(tres["val"][m]) * 1e6),
                                   np.rint(np.asarray(jres["val"][m]) * 1e6),
                                   rtol=0, atol=1.0)
    assert tres["val"]["rmse"][-1] < tres["val"]["rmse"][0]
    assert tb.num_boosted_rounds() == 3


@pytest.mark.parametrize("extra,types", [
    ({}, ["q", "c", "q", "q", "q", "q"]),
    ({"grow_policy": "lossguide", "max_leaves": 8}, None)])
def test_refusals_match_jax(extra, types):
    X = np.nan_to_num(_rows(11, 256))
    X[:, 1] = np.arange(256) % 4
    y = X[:, 0].copy()
    p = {**BASE, **extra}
    with pytest.raises(NotImplementedError) as je:
        xgb.train(p, xgb.DMatrix(X, label=y, feature_types=types), 1,
                  verbose_eval=False)
    with pytest.raises(NotImplementedError) as te:
        xgbt.train(p, xgbt.DMatrix(X, y, feature_types=types, device="cpu"),
                   1, verbose_eval=False)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# continuous hessians: the per-node sketch's float32 sums
# ---------------------------------------------------------------------------

LOCAL_N = 2574
LOCAL_BINS = [37, 64, 100, 256]
LOCAL_P = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3,
           "updater": "grow_local_histmaker"}


def _local_set(seed):
    X = _rows(seed, LOCAL_N)
    rng = np.random.RandomState(100 + seed)
    y = ((np.nan_to_num(X) @ rng.randn(F) + 0.5 * rng.randn(LOCAL_N)) > 0
         ).astype(np.float32)
    return X, y


@pytest.mark.parametrize("max_bin", LOCAL_BINS)
def test_level_cuts_bitwise_jax_along_training(max_bin, monkeypatch):
    """The witness of the per-node sketch's rounding. ``binary:logistic``'s
    hessians are continuous, so the prefix sums, the node totals and the
    quantile targets are inexact in float32; the cuts are the JAX
    package's only where each rounds as XLA:CPU rounds it (the ``_cdf``
    association, node totals in row order, reciprocal levels, the target's
    fused multiply-add). Every level of 2 rounds at depth 4 on 2574 rows,
    seeds 0-5: the port's cuts and bins equal the JAX package's
    ``_level_cuts_and_bins`` (jitted, at its fixed level width) on the
    same inputs."""
    seen = []
    orig = tgl._level_cuts_and_bins

    def spy(X, hess, seg, K, B):
        out = orig(X, hess, seg, K, B)
        seen.append((X.numpy(), hess.numpy(), seg.numpy(), K, B) + tuple(
            o.numpy() for o in out))
        return out

    monkeypatch.setattr(tgl, "_level_cuts_and_bins", spy)
    p = {**LOCAL_P, "max_bin": max_bin}
    for seed in range(6):
        X, y = _local_set(seed)
        xgbt.train(p, xgbt.DMatrix(X, y, device="cpu"), 2,
                   verbose_eval=False)
    assert len(seen) == 6 * 2 * 4
    width = 1 << (LOCAL_P["max_depth"] - 1)
    jlevel = jax.jit(jgl._level_cuts_and_bins, static_argnums=(3, 4))
    for X, h, seg, K, B, cuts, bins in seen:
        jc, jb = jlevel(jnp.asarray(X), jnp.asarray(h),
                        jnp.asarray(seg.astype(np.int32)), width, B)
        np.testing.assert_array_equal(cuts, np.asarray(jc)[:K])
        inside = (seg >= 0) & (seg < K)
        np.testing.assert_array_equal(bins[inside], np.asarray(jb)[inside])


@pytest.mark.parametrize("max_bin", LOCAL_BINS)
def test_train_matches_jax_with_continuous_hessians(max_bin):
    """The same training end to end: trees and margins with the lossguide
    tests' tolerances. The histograms differ in their float rounding (the
    JAX package's float32 ``segment_sum``, the port's exact fixed-point
    sums), so two candidates of equal gain can split either way: seed 5
    at ``max_bin`` 256 picks another condition on the same feature at
    node 14 of tree 1 (loss changes 4.348700 and 4.348671) on cuts that
    are equal bit for bit. Where a split differs, the two packages' loss
    changes must agree within rtol 1e-5 (a tie), and that tree and the
    seed's later trees are not compared further."""
    p = {**LOCAL_P, "max_bin": max_bin}
    for seed in range(6):
        X, y = _local_set(seed)
        jb = xgb.train(p, xgb.DMatrix(X, label=y), 2, verbose_eval=False)
        tb = xgbt.train(p, xgbt.DMatrix(X, y, device="cpu"), 2,
                        verbose_eval=False)
        jt, tt = _trees(json.loads(jb.save_raw())), _trees(tb.save_json())
        tie = None
        for k, (a, b) in enumerate(zip(jt, tt)):
            ca = np.asarray(a["split_conditions"], np.float32)
            cb = np.asarray(b["split_conditions"], np.float32)
            inner = np.asarray(a["left_children"]) >= 0
            moved = np.nonzero(inner & ((ca != cb) | (
                np.asarray(a["split_indices"]) !=
                np.asarray(b["split_indices"]))))[0]
            if len(moved):
                i = moved[0]
                np.testing.assert_allclose(b["loss_changes"][i],
                                           a["loss_changes"][i], rtol=1e-5)
                tie = k
                break
        if tie is None:
            _assert_same_trees(jt, tt, X)
            np.testing.assert_allclose(_margins(tb, X), _margins(jb, X),
                                       rtol=1e-5, atol=TOL)
        else:
            assert (seed, max_bin) == (5, 256), (seed, max_bin, tie)
            _assert_same_trees(jt[:tie], tt[:tie], X)


def test_segmented_weighted_cuts_match_jax_with_continuous_weights():
    """One column, hessian-like weights, 8 segments (rows outside every
    segment, 8% missing), against the JAX function jitted as the grower
    compiles it."""
    rng = np.random.RandomState(12)
    col = rng.randn(LOCAL_N).astype(np.float32)
    col[rng.rand(LOCAL_N) < 0.08] = np.nan
    p = 1.0 / (1.0 + np.exp(-rng.randn(LOCAL_N)))
    h = (p * (1.0 - p)).astype(np.float32)
    seg = rng.randint(-1, 9, LOCAL_N).astype(np.int32)
    jsw = jax.jit(jgl.segmented_weighted_cuts, static_argnums=(3, 4))
    for K, B in ((8, 37), (8, 100), (8, 256)):
        want = jsw(jnp.asarray(col), jnp.asarray(h), jnp.asarray(seg), K, B)
        got = tgl.segmented_weighted_cuts(_t(col), _t(h), _t(seg), K, B)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
