"""Port parity for categorical splits against the JAX package, on the CPU.

Each test feeds the same numpy inputs to ``xgboost_tpu`` and to the port:

- identity cuts, bins and ``cat_counts`` of categorical features equal
  (``BinnedMatrix.from_dense``), at ``max_bin`` 16 (uint8 bins) and 256
  (int16); invalid codes (negative, fractional, ``>= max_bin``) raise the
  same errors;
- ``eval_splits`` with one-hot, partition and mixed categorical features:
  on dyadic histograms (every sum exact in f32 in any order) every field of
  the decision and the winner's category set are bitwise equal; on
  random-valued ones (the JAX partition branch sums with ``jnp.cumsum``,
  the port with the strict order of ``seq_cumsum``) the winner is the same
  wherever the two scores differ by more than 1e-5 relative, its category
  set is then equal and ``loss``/``GL``/``HL`` agree to rtol 1e-5;
- ``partition_apply`` on ``[Kp, 5+B]`` tables against
  ``partition_apply_xla``: positions equal;
- the categorical walk against the JAX XLA walk (``_walk_leaves``,
  ``_predict_margin_impl``) on inputs with NaN, unseen codes, codes at and
  past 32 x the bitset's words, negative and fractional codes: leaves equal,
  margins within 1e-5;
- the slice: both packages train ``binary:logistic`` for 3 rounds at depth
  3 on 4096 x 6 with one one-hot-regime column (3 categories) and one
  partition-regime column (12), 5% NaN (the JAX package pinned as in
  ``test_torch_slice.py``): the same trees, split types and category sets,
  margins within 1e-5, AUC within 1e-6, and the JSON models carried across
  in both directions. ``default_left`` is compared under the tie rule of
  ``test_torch_slice.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
from xgboost_tpu.data import quantile as jq
from xgboost_tpu.predictor import _predict_margin_impl
from xgboost_tpu.predictor import _walk_leaves as j_walk
from xgboost_tpu.tree import grow as jgrow
from xgboost_tpu.tree import hist_kernel as jhk
from xgboost_tpu.tree.param import SplitParams as JSplitParams
import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch.data import quantile as tq
from xgboost_tpu_torch.predictor import (forest_from_numpy, predict_leaf,
                                         predict_margin)
from xgboost_tpu_torch.tree import grow as tgrow
from xgboost_tpu_torch.tree import hist_kernel as thk
from xgboost_tpu_torch.tree.param import SplitParams

torch.set_num_threads(1)

FT = ["q", "c", "q", "q", "c", "q"]  # column 1: one-hot regime, 4: partition
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16,
          "eta": 0.3, "eval_metric": ["auc", "logloss"]}


def _cat_data(seed, n):
    """Columns 1 (3 categories) and 4 (12) carry codes whose effects are
    not monotone in the code; 5% NaN everywhere."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    X[:, 1] = rng.randint(0, 3, n)
    X[:, 4] = rng.randint(0, 12, n)
    eff1 = np.array([2.0, -1.5, 0.5])
    eff4 = rng.randn(12) * 1.5
    logit = (X[:, 0] + eff1[X[:, 1].astype(int)] + eff4[X[:, 4].astype(int)]
             + 0.5 * rng.randn(n))
    X[rng.rand(n, 6) < 0.05] = np.nan
    return X, (logit > 0).astype(np.float32)


# ---------------------------------------------------------------------------
# cuts, bins, counts, validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_bin", [16, 256])
def test_identity_cuts_bins_and_counts_match_jax(max_bin):
    X, _ = _cat_data(0, 1500)
    X[:, 4] = np.where(np.isnan(X[:, 4]), np.nan, X[:, 4] * (max_bin // 16))
    cat = [1, 4]
    want = jq.BinnedMatrix.from_dense(X, max_bin=max_bin, categorical=cat)
    got = tq.BinnedMatrix.from_dense(torch.from_numpy(X), max_bin=max_bin,
                                     categorical=cat)
    np.testing.assert_array_equal(got.cuts.values, want.cuts.values)
    np.testing.assert_array_equal(got.cuts.min_vals, want.cuts.min_vals)
    np.testing.assert_array_equal(got.bins.numpy().astype(np.int32),
                                  np.asarray(want.bins).astype(np.int32))
    assert got.categorical == want.categorical == (1, 4)
    assert got.cat_counts == want.cat_counts
    # category code c lands in bin c, missing in bin B
    col = X[:, 4]
    present = ~np.isnan(col)
    np.testing.assert_array_equal(got.bins[:, 4].numpy()[present],
                                  col[present].astype(int))
    assert (got.bins[:, 4].numpy()[~present] == max_bin).all()


def test_cat_counts_of_an_all_missing_column_match_jax():
    X = np.full((64, 2), np.nan, np.float32)
    X[:, 0] = np.arange(64) % 5
    want = jq.BinnedMatrix.from_dense(X, max_bin=16, categorical=[0, 1])
    got = tq.BinnedMatrix.from_dense(torch.from_numpy(X), max_bin=16,
                                     categorical=[0, 1])
    assert got.cat_counts == want.cat_counts == (5, 1)


@pytest.mark.parametrize("bad", ["negative", "fractional", "too_many"])
def test_invalid_codes_raise_the_jax_errors(bad):
    X, y = _cat_data(1, 200)
    X[7, 4] = {"negative": -1.0, "fractional": 2.5, "too_many": 16.0}[bad]
    with pytest.raises(ValueError) as jerr:
        xgb.DMatrix(X, label=y, feature_types=FT).get_binned(16)
    with pytest.raises(ValueError) as terr:
        xgbt.DMatrix(X, y, feature_types=FT, device="cpu").get_binned(16)
    assert str(terr.value) == str(jerr.value)


def test_feature_types_are_accepted():
    X, y = _cat_data(2, 100)
    for ft in (FT, ["categorical" if t == "c" else "float" for t in FT]):
        d = xgbt.DMatrix(X, y, feature_types=ft, device="cpu")
        assert d.categorical_features() == [1, 4]
        assert d.get_binned(16).categorical == (1, 4)
    assert xgbt.DMatrix(X, y, device="cpu").categorical_features() == []


# ---------------------------------------------------------------------------
# split evaluation
# ---------------------------------------------------------------------------

K, F, B = 8, 5, 16
REGIMES = {"onehot": ((1, 3), ()), "partition": ((), (1, 3)),
           "mixed": ((1,), (3,))}


def _hist(rng, dyadic):
    """[K, F, B+1, 2] with the missing bin last, plus node totals that every
    feature shares. Dyadic: g in multiples of 1/8, h in multiples of 1/4,
    so every sum is exact in f32 in any order. A fifth of the bins are
    empty (absent categories); every missing bin's h is non-negative."""
    if dyadic:
        g = rng.randint(-40, 41, size=(K, F, B)) / 8.0
        h = rng.randint(0, 21, size=(K, F, B)) / 4.0
    else:
        g = rng.randn(K, F, B)
        h = rng.uniform(0.0, 5.0, size=(K, F, B))
    empty = rng.rand(K, F, B) < 0.2
    g[empty], h[empty] = 0.0, 0.0
    g, h = g.astype(np.float32), h.astype(np.float32)
    G = (g[:, 0].sum(-1) + 1.5).astype(np.float32)
    H = (h.sum(-1).max(-1) + 2.0).astype(np.float32)
    hist = np.zeros((K, F, B + 1, 2), np.float32)
    hist[:, :, :B, 0], hist[:, :, :B, 1] = g, h
    hist[:, :, B, 0] = G[:, None] - g.sum(-1, dtype=np.float32)
    hist[:, :, B, 1] = H[:, None] - h.sum(-1, dtype=np.float32)
    return hist, G, H


def _masks(onehot, part):
    m1, m2 = np.zeros(F, bool), np.zeros(F, bool)
    m1[list(onehot)] = True
    m2[list(part)] = True
    return (m1 if onehot else None), (m2 if part else None)


def _both_eval(hist, G, H, onehot, part, reg_lambda=1.0):
    m1, m2 = _masks(onehot, part)
    fmask = np.ones((K, F), bool)
    fmask[2, 1] = False  # a node that may not use a categorical feature
    j = jgrow.eval_splits(
        jnp.asarray(hist), jnp.asarray(G), jnp.asarray(H),
        JSplitParams(reg_lambda=reg_lambda), jnp.asarray(fmask), B,
        cat_feats=None if m1 is None else jnp.asarray(m1),
        cat_part=None if m2 is None else jnp.asarray(m2))
    t = tgrow.eval_splits(
        torch.from_numpy(hist), torch.from_numpy(G), torch.from_numpy(H),
        SplitParams(reg_lambda=reg_lambda), torch.from_numpy(fmask), B,
        None if m1 is None else torch.from_numpy(m1),
        None if m2 is None else torch.from_numpy(m2))
    return j, t


FIELDS = ("loss", "dir", "f", "b", "GL", "HL", "w_node", "cat_set")


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_splits_categorical_bitwise_on_dyadic_histograms(regime, seed):
    rng = np.random.RandomState(seed)
    hist, G, H = _hist(rng, dyadic=True)
    j, t = _both_eval(hist, G, H, *REGIMES[regime])
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    # categorical winners exist, and their sets are non-empty
    cat_f = list(REGIMES[regime][0]) + list(REGIMES[regime][1])
    won = np.isin(t.f.numpy(), cat_f) & np.isfinite(t.loss.numpy())
    assert won.any()
    assert t.cat_set.numpy()[won].any(axis=1).all()


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("seed", [3, 4])
def test_eval_splits_categorical_random_histograms_within_tolerance(regime,
                                                                    seed):
    """Winners differ only where two candidates score within 1e-5 of each
    other; where they agree, the sets are equal and the sums agree to rtol
    1e-5."""
    rng = np.random.RandomState(seed)
    hist, G, H = _hist(rng, dyadic=False)
    j, t = _both_eval(hist, G, H, *REGIMES[regime])
    jl, tl = np.asarray(j.loss), t.loss.numpy()
    same = ((np.asarray(j.f) == t.f.numpy()) & (np.asarray(j.b) == t.b.numpy())
            & (np.asarray(j.dir) == t.dir.numpy()))
    assert same.sum() >= K - 1
    for k in np.flatnonzero(~same):
        assert abs(tl[k] - jl[k]) <= 1e-5 * max(1.0, abs(jl[k])), k
    for name in ("loss", "GL", "HL", "w_node"):
        np.testing.assert_allclose(getattr(t, name).numpy()[same],
                                   np.asarray(getattr(j, name))[same],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(t.cat_set.numpy()[same],
                                  np.asarray(j.cat_set)[same])


def test_eval_splits_partition_orders_absent_categories_last():
    """A partition winner's set is a prefix of the categories sorted by
    g / (h + lambda); absent categories (no g, no h) sort last, in bin
    order, and so never join a set before a present one."""
    hist = np.zeros((K, F, B + 1, 2), np.float32)
    ratios = np.array([3.0, -2.0, 0.5, -4.0, 1.0])
    for c, r in zip((2, 5, 7, 9, 11), ratios):
        hist[:, 1, c] = (r * 2.0, 1.0)
    G = hist[:, 1, :, 0].sum(-1)
    H = hist[:, 1, :, 1].sum(-1)
    hist[:, :, B, 0] = G[:, None] - hist[:, :, :B, 0].sum(-1)
    hist[:, :, B, 1] = H[:, None] - hist[:, :, :B, 1].sum(-1)
    j, t = _both_eval(hist, G, H, (), (1,), reg_lambda=1.0)
    np.testing.assert_array_equal(t.cat_set.numpy(), np.asarray(j.cat_set))
    allowed = np.arange(K) != 2  # node 2 may not use feature 1
    assert (t.f.numpy()[allowed] == 1).all()
    # the two most negative ratios (codes 9, 5) go right
    np.testing.assert_array_equal(np.flatnonzero(t.cat_set.numpy()[0]), [5, 9])


# ---------------------------------------------------------------------------
# partition_apply on the wide table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Bw,d", [(16, 1), (16, 3), (256, 4)])
def test_partition_apply_categorical_table_matches_xla(Bw, d):
    rng = np.random.RandomState(Bw + d)
    n, nf = 3000, 5
    Kp = 1 << (d - 1)
    dt = np.uint8 if Bw < 255 else np.int16
    bins = rng.randint(0, Bw + 1, size=(n, nf)).astype(dt)
    pos = rng.randint(Kp - 2 if Kp > 1 else 0, 2 * Kp, size=(n, 1)).astype(
        np.int32)
    ptab = np.concatenate([
        np.stack([rng.rand(Kp) < 0.8, rng.randint(0, nf, Kp),
                  rng.randint(0, Bw, Kp), rng.rand(Kp) < 0.5], 1),
        rng.rand(Kp, 1) < 0.6, rng.rand(Kp, Bw) < 0.4], 1).astype(np.float32)
    got = thk.partition_apply(torch.from_numpy(bins), torch.from_numpy(pos),
                              torch.from_numpy(ptab), Kp=Kp, B=Bw, d=d)
    want = jhk.partition_apply_xla(jnp.asarray(bins.astype(np.int32)),
                                   jnp.asarray(pos), jnp.asarray(ptab),
                                   Kp=Kp, B=Bw, d=d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the categorical columns decide: read as numerical, rows go elsewhere
    num = thk.partition_apply(torch.from_numpy(bins), torch.from_numpy(pos),
                              torch.from_numpy(ptab[:, :4].copy()), Kp=Kp,
                              B=Bw, d=d)
    assert not torch.equal(got, num)


# ---------------------------------------------------------------------------
# the slice: train, walk, model IO
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    X, y = _cat_data(5, 5120)
    return (X[:4096], y[:4096]), (X[4096:], y[4096:])


@pytest.fixture(scope="module")
def trained(data):
    (X, y), (Xv, yv) = data
    jres, tres = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        jb = xgb.train(PARAMS, xgb.DMatrix(X, label=y, feature_types=FT), 3,
                       evals=[(xgb.DMatrix(Xv, label=yv, feature_types=FT),
                               "val")], evals_result=jres, verbose_eval=False)
    tb = xgbt.train(PARAMS, xgbt.DMatrix(X, y, feature_types=FT, device="cpu"),
                    3, evals=[(xgbt.DMatrix(Xv, yv, feature_types=FT,
                                            device="cpu"), "val")],
                    evals_result=tres, verbose_eval=False)
    heap = tb._gbm.model.stacked()  # the device-grown trees' heap stack
    return jb, tb, jres, tres, heap


def _trees(model_json):
    return model_json["learner"]["gradient_booster"]["model"]["trees"]


def _walk_json(tree, x):
    """Nodes visited by row ``x`` and whether its split value was missing
    at each."""
    lc, rc = tree["left_children"], tree["right_children"]
    cats = {n: set(tree["categories"][s:s + z]) for n, s, z in zip(
        tree["categories_nodes"], tree["categories_segments"],
        tree["categories_sizes"])}
    i, out = 0, []
    while lc[i] != -1:
        v = x[tree["split_indices"][i]]
        out.append((i, np.isnan(v)))
        if np.isnan(v):
            left = tree["default_left"][i]
        elif tree["split_type"][i] == 1:
            left = int(v) not in cats[i]
        else:
            left = v < np.float32(tree["split_conditions"][i])
        i = lc[i] if left else rc[i]
    return out


def _nodes_with_missing(tree, X):
    return {i for x in X for i, miss in _walk_json(tree, x) if miss}


def test_slice_same_trees_split_types_and_category_sets(data, trained):
    jb, tb, jres, tres, _ = trained
    (X, _), (Xv, _) = data
    jt, tt = _trees(json.loads(jb.save_raw())), _trees(tb.save_json())
    assert len(jt) == len(tt) == 3
    kinds = set()
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices",
                    "split_type", "categories", "categories_nodes",
                    "categories_segments", "categories_sizes"):
            assert a[key] == b[key], key
        internal = np.asarray(a["left_children"]) >= 0
        np.testing.assert_allclose(b["split_conditions"], a["split_conditions"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[internal],
            np.asarray(b["split_conditions"], np.float32)[internal])
        seen = _nodes_with_missing(a, X)
        any_missing = (seen | _nodes_with_missing(b, X)
                       | _nodes_with_missing(a, Xv) | _nodes_with_missing(b, Xv))
        for i in np.flatnonzero(internal):
            if i in seen:
                assert a["default_left"][i] == b["default_left"][i], i
            elif a["default_left"][i] != b["default_left"][i]:
                assert i not in any_missing, i
                np.testing.assert_allclose(b["loss_changes"][i],
                                           a["loss_changes"][i], rtol=1e-5)
        kinds |= {a["split_indices"][i] for i in a["categories_nodes"]}
    assert kinds == {1, 4}, "one-hot and partition nodes both grown"
    np.testing.assert_allclose(tres["val"]["auc"], jres["val"]["auc"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tres["val"]["logloss"], jres["val"]["logloss"],
                               rtol=1e-5)
    assert tres["val"]["auc"][-1] > tres["val"]["auc"][0]


def test_slice_margins_and_predictions_match(data, trained):
    jb, tb, _, _, heap = trained
    (_, _), (Xv, _) = data
    assert heap.has_cats and heap.split_type.any()
    jm = jb.predict(xgb.DMatrix(Xv, feature_types=FT), output_margin=True)
    dv = xgbt.DMatrix(Xv, feature_types=FT, device="cpu")
    tm = tb.predict(dv, output_margin=True)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.predict(dv), jb.predict(xgb.DMatrix(Xv)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tb.inplace_predict(Xv, predict_type="margin"),
                                  tm)
    # the heap stack and the BFS-compacted trees of the saved model agree
    loaded = xgbt.Booster(model_file=tb.save_raw(), device="cpu")
    m_heap = predict_margin(heap, dv.data, torch.zeros((Xv.shape[0], 1)))
    np.testing.assert_array_equal(loaded.predict(dv, output_margin=True),
                                  m_heap.numpy()[:, 0])


def test_slice_models_carry_across(data, trained):
    jb, tb, _, _, _ = trained
    (_, _), (Xv, _) = data
    port = xgbt.Booster(model_file=jb.save_raw(), device="cpu")
    np.testing.assert_allclose(
        port.predict(xgbt.DMatrix(Xv, device="cpu"), output_margin=True),
        jb.predict(xgb.DMatrix(Xv), output_margin=True), rtol=1e-5, atol=1e-5)
    raw = tb.save_raw()
    back = xgb.Booster(model_file=bytearray(raw))
    np.testing.assert_allclose(
        back.predict(xgb.DMatrix(Xv), output_margin=True),
        tb.predict(xgbt.DMatrix(Xv, device="cpu"), output_margin=True),
        rtol=1e-5, atol=1e-5)
    again = xgbt.Booster(model_file=raw, device="cpu")
    assert json.loads(again.save_raw()) == json.loads(raw)


def _awkward_rows(X, rng):
    """Rows whose categorical columns hold NaN, unseen codes (12-40),
    codes at and past 32 x the bitset's words (32, 64, 1e9), negative
    codes (-1, -0.5) and fractional ones (2.7, 4.5)."""
    Xa = X.copy()
    odd = np.array([np.nan, 12.0, 13.0, 31.0, 32.0, 40.0, 64.0, 1e9, -1.0,
                    -0.5, 2.7, 4.5, 0.0, 1.0, 2.0, 11.0], np.float32)
    for c in (1, 4):
        Xa[:, c] = odd[rng.randint(0, len(odd), size=len(Xa))]
    return Xa


@pytest.mark.parametrize("source", ["heap", "json"])
def test_categorical_walk_matches_jax_walk(data, trained, source):
    """The JAX package's forest (device heap stack, or stacked from its
    model JSON) walked by the port's categorical walk and by the JAX XLA
    walk: the same leaves, margins within 1e-5."""
    jb, _, _, _, _ = trained
    (_, _), (Xv, _) = data
    if source == "heap":
        f = jb._gbm.model.stacked()
    else:
        from xgboost_tpu.predictor import stack_forest
        f = stack_forest(jb._gbm.model.trees, jb._gbm.model.tree_info, 1)
    assert f.has_cats
    Xa = _awkward_rows(Xv[:600], np.random.RandomState(6))
    forest = forest_from_numpy(
        np.asarray(f.left), np.asarray(f.right), np.asarray(f.feature),
        np.asarray(f.cond), np.asarray(f.default_left),
        np.asarray(f.tree_group), f.max_depth, f.n_groups,
        split_type=np.asarray(f.split_type), cat_bits=np.asarray(f.cat_bits))
    assert forest.has_cats
    T = f.left.shape[0]
    want_leaf = np.asarray(j_walk(
        jnp.asarray(Xa), f.left, f.right, f.feature, f.cond, f.default_left,
        f.split_type, f.cat_bits, f.max_depth, True))
    got_leaf = predict_leaf(forest, torch.from_numpy(Xa)).numpy().T
    np.testing.assert_array_equal(got_leaf, want_leaf)
    want = np.asarray(_predict_margin_impl(
        jnp.asarray(Xa), f.left, f.right, f.feature, f.cond, f.default_left,
        f.split_type, f.cat_bits, f.tree_group, jnp.ones((T,), jnp.float32),
        jnp.zeros((Xa.shape[0], f.n_groups), jnp.float32), f.n_groups,
        f.max_depth, True))
    got = predict_margin(forest, torch.from_numpy(Xa),
                         torch.zeros((Xa.shape[0], 1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_port_model_walks_awkward_codes_like_jax(data, trained):
    """The port's own model, predicted by both packages on the awkward
    rows: margins within 1e-5."""
    _, tb, _, _, _ = trained
    (_, _), (Xv, _) = data
    Xa = _awkward_rows(Xv[:600], np.random.RandomState(7))
    back = xgb.Booster(model_file=bytearray(tb.save_raw()))
    np.testing.assert_allclose(
        tb.inplace_predict(Xa, predict_type="margin"),
        back.inplace_predict(Xa, predict_type="margin"), rtol=1e-5, atol=1e-5)
