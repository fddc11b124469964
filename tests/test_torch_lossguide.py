"""Port parity: loss-guide (best-first) growth against the JAX package.

The grower. ``grow_tree_lossguide`` of both packages on the same bins
(2048 x 6 rows quantised by the port at ``max_bin`` 16, 5% missing) and
the same gradients, with the same key. The gradients lie on a 1/64 grid,
so every sum of them is exact in float32: the JAX package's float
``segment_sum`` histograms and the port's fixed-point ones (kernel A's
contract) hold the same values, and the comparison is of the growers'
logic, not of summation orders (continuous gradients are the training
tests' below). The allocation arrays (children, features, split bins and
conditions, depths, node sums, node count), every row's position and the
category sets are equal exactly, ``default_left`` wherever a row with a
missing split value reaches the node (elsewhere a tie); weights and loss
changes within rtol 1e-6. Cases: 8, 31 and 100 leaves (the last the
batched top-8 queue), ``max_depth`` 0 (unbounded), 3 and 5, row and column
sampling, monotone and interaction constraints, one-hot and partition
categorical features, gamma pruning. ``finalize_alloc`` on the grown
trees: ``keep`` exact, leaf values and the cache delta within rtol 1e-6,
its leaf values equal to ``RegTree.from_alloc``'s map of the same tree;
``RegTree.from_alloc`` of both packages on the same arrays: the same
compact tree and map, exactly.

Ties. Rows whose second half mirrors the first with negated gradients
give two leaves equal gains: both packages pop the lower id first; the
pop itself (``top_candidates``) is ``jax.lax.top_k`` on gains with ties
and -inf. ``finalize_alloc``'s pointer-doubling passes equal the JAX
package's sequential ones on a chain and on a bushy tree with gamma
pruning: ``keep`` exact, values within rtol 1e-6.

Training. 3 rounds of ``train`` (``binary:logistic``, the held-out rows
evaluated) for 8 leaves at ``max_depth`` 0, 31 at depth 3 and 100 at depth
0: the same trees (structure and split conditions exact, ``default_left``
where a training row with a missing value reaches the node, leaf values
within rtol 1e-5 and atol 5e-5: a leaf's sums are its ancestors' less
their siblings', so their float32 rounding in the JAX package grows with
the depth, 2e-5 seen at 100 leaves), margins of the training and the
held-out rows (no missing values) within the same, the eval history within
1e-6; ``iteration_range`` and ``__getitem__`` slices within the same; the
model JSON loads in the other package in both directions and predicts
within the same;
pickling and continuation (3 + 2 rounds against 5) against the port
itself, bitwise.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu.tree import grow as jgrow
from xgboost_tpu.tree import grow_lossguide as jlg
from xgboost_tpu.tree.model import RegTree as JRegTree
from xgboost_tpu.tree.param import SplitParams as JSplitParams
from xgboost_tpu_torch import threefry as tf
from xgboost_tpu_torch.tree import grow as tgrow
from xgboost_tpu_torch.tree import grow_lossguide as tlg
from xgboost_tpu_torch.tree.model import RegTree as TRegTree
from xgboost_tpu_torch.tree.param import SplitParams as TSplitParams

torch.set_num_threads(1)

N, F, B = 2048, 6, 16
MONO = (1, -1, 0, 0, 1, 0)
GROUPS = ((0, 1), (2, 3, 4), (5,))
EXACT = ("left", "right", "feature", "split_bin", "split_cond", "depth",
         "node_g", "node_h")
CLOSE = ("node_weight", "loss_chg")
# leaf values and margins of trained models: a leaf's sums are its
# ancestors' less their siblings', so their rounding grows with the depth
# (2e-5 seen at 100 leaves)
TOL = 5e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(seed, n):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rng.randn(F) + 0.5 * rng.randn(n)) > 0
         ).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def binned():
    """(bins [N, F] uint8, cut values [F, B]) with columns 0 and 1 also as
    category codes (3 and 12 categories, 5% missing) for the categorical
    cases."""
    X, _ = _data(0, N)
    bm = xgbt.DMatrix(X, device="cpu").get_binned(B)
    bins = bm.bins.numpy().copy()
    rng = np.random.RandomState(1)
    cat_bins = bins.copy()
    for c, k in ((0, 3), (1, 12)):
        codes = rng.randint(0, k, N).astype(np.uint8)
        codes[rng.rand(N) < 0.05] = B
        cat_bins[:, c] = codes
    return bins, cat_bins, bm.cut_values.numpy()


def _grads(seed):
    """Gradients on a 1/64 grid (g in [-2, 2], h in [0.1, 1]): every sum of
    them is exact in float32, so the JAX package's float histograms and
    the port's fixed-point ones hold the same values and near-equal gains
    cannot swap places between the packages."""
    rng = np.random.RandomState(seed)
    return (rng.randint(-128, 129, N).astype(np.float32) / 64,
            rng.randint(6, 65, N).astype(np.float32) / 64)


GROW_CASES = {
    "leaves8": (8, dict(max_depth=0)),
    "leaves31_depth3": (31, dict(max_depth=3)),
    "leaves100": (100, dict(max_depth=0)),
    "sampled": (31, dict(max_depth=0, subsample=0.8, colsample_bytree=0.8,
                         colsample_bylevel=0.8, colsample_bynode=0.7)),
    "sampled_batched": (100, dict(max_depth=0, subsample=0.5,
                                  colsample_bynode=0.5)),
    "monotone": (20, dict(max_depth=0, monotone=MONO)),
    "interaction": (100, dict(max_depth=0, interaction=GROUPS)),
    "categorical": (31, dict(max_depth=0, categorical=(0,),
                             cat_partition=(1,))),
    "categorical_batched": (100, dict(max_depth=5, categorical=(0,),
                                      cat_partition=(1,))),
}


def _grow_both(bins, cuts, g, h, max_leaves, kw, seed=3, gamma=0.0, eta=0.3):
    split = dict(reg_lambda=1.0, min_child_weight=0.5, min_split_loss=gamma)
    jcfg = jgrow.GrowParams(split=JSplitParams(**split), **kw)
    tcfg = tgrow.GrowParams(split=TSplitParams(**split), **kw)
    ja = jlg.grow_tree_lossguide(jnp.asarray(bins), jnp.asarray(g),
                                 jnp.asarray(h), jnp.asarray(cuts),
                                 jax.random.PRNGKey(seed), jcfg, max_leaves)
    ta = tlg.grow_tree_lossguide(_t(bins), _t(g), _t(h), _t(cuts), tcfg,
                                 max_leaves, key=tf.prng_key(seed))
    jfin = jlg.finalize_alloc(ja, jnp.float32(eta), jnp.float32(gamma))
    tfin = tlg.finalize_alloc(ta, eta, gamma)
    return ja, ta, jfin, tfin


def _saw_missing(a, bins):
    """[M] bool: split nodes that a row with a missing split value reached
    (the rows' leaves and the parent links give each row's path)."""
    left, right = np.asarray(a.left), np.asarray(a.right)
    feature = np.asarray(a.feature)
    parent = np.full(left.shape[0], -1)
    for i in np.flatnonzero(left >= 0):
        parent[left[i]] = parent[right[i]] = i
    seen = np.zeros(left.shape[0], bool)
    for r, leaf in enumerate(np.asarray(a.positions)):
        i = parent[leaf]
        while i >= 0:
            seen[i] |= bins[r, feature[i]] == B
            i = parent[i]
    return seen


def _assert_same_alloc(ja, ta, bins):
    """The same allocation arrays; ``default_left`` where a row with a
    missing value reached the node (elsewhere both directions score the
    same and float rounding breaks the tie either way, as in
    ``tests/test_torch_training.py``)."""
    for name in EXACT:
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)), name)
    seen = _saw_missing(ja, bins)
    assert seen.any()
    np.testing.assert_array_equal(ta.default_left.numpy()[seen],
                                  np.asarray(ja.default_left)[seen])
    for name in CLOSE:
        np.testing.assert_allclose(getattr(ta, name).numpy(),
                                   np.asarray(getattr(ja, name)),
                                   rtol=1e-6, err_msg=name)
    assert int(ta.n_nodes) == int(ja.n_nodes)
    np.testing.assert_array_equal(ta.positions.numpy(),
                                  np.asarray(ja.positions))
    np.testing.assert_array_equal(ta.cat_set.numpy(), np.asarray(ja.cat_set))


def _compact(cls, a, eta, gamma, cat_mask):
    h = {k: np.asarray(getattr(a, k)) for k in a._fields}
    return cls.from_alloc(
        h["left"], h["right"], h["feature"], h["split_cond"],
        h["default_left"], h["node_weight"], h["loss_chg"], h["node_h"],
        int(h["n_nodes"]), eta=eta, min_split_loss=gamma,
        split_bin=h["split_bin"], cat_features=cat_mask,
        cat_set=h["cat_set"] if cat_mask is not None else None)


@pytest.mark.parametrize("case", sorted(GROW_CASES))
def test_grow_tree_lossguide_matches_jax(binned, case):
    bins, cat_bins, cuts = binned
    max_leaves, kw = GROW_CASES[case]
    cat = "categorical" in case
    g, h = _grads(7)
    gamma = 0.5 if case == "leaves31_depth3" else 0.0
    bins = cat_bins if cat else bins
    ja, ta, jfin, tfin = _grow_both(bins, cuts, g, h, max_leaves, kw,
                                    gamma=gamma)
    _assert_same_alloc(ja, ta, bins)
    n_leaves = (int(ta.n_nodes) + 1) // 2
    assert 1 < n_leaves <= max_leaves
    if kw["max_depth"]:
        assert int(ta.depth.max()) <= kw["max_depth"]
    np.testing.assert_array_equal(tfin[0].numpy(), np.asarray(jfin[0]))
    for got, want in zip(tfin[1:], jfin[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # from_alloc of both packages on the same (the JAX package's) arrays:
    # the same compact tree and leaf map, exactly
    cat_mask = np.isin(np.arange(F), (0, 1)) if cat else None
    jt, jmap = _compact(JRegTree, ja, 0.3, gamma, cat_mask)
    tt, tmap = _compact(TRegTree, ja, 0.3, gamma, cat_mask)
    assert tt.to_json() == jt.to_json()
    np.testing.assert_array_equal(tmap, jmap)
    # the device's leaf values are the host map of the same tree, NaN (no
    # governing leaf: a kept split) as 0
    _, own_map = _compact(TRegTree, ta, 0.3, gamma, cat_mask)
    np.testing.assert_array_equal(tfin[1].numpy(), np.nan_to_num(own_map))
    if cat:
        assert (tt.split_type == 1).any()


def test_batched_queue_uses_the_whole_budget(binned):
    bins, _, cuts = binned
    g, h = _grads(11)
    _, ta, _, _ = _grow_both(bins, cuts, g, h, 100, dict(max_depth=0))
    assert (int(ta.n_nodes) + 1) // 2 == 100
    assert tlg.expansions_per_step(100) == 8
    assert tlg.lossguide_steps(100) == 13 + 3
    assert tlg.lossguide_steps(255) == 32 + 3
    assert tlg.lossguide_steps(31) == 30


# ---------------------------------------------------------------------------
# ties: the top-k pop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 8])
def test_top_candidates_order_is_top_k(k):
    rng = np.random.RandomState(k)
    for _ in range(5):
        gain = rng.choice([-np.inf, 0.5, 1.25, 2.0, 3.5], size=40
                          ).astype(np.float32)
        jv, ji = jax.lax.top_k(jnp.asarray(gain), k)
        tv, ti = tlg.top_candidates(_t(gain), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("max_leaves", [3, 7, 70])
def test_equal_gains_pop_the_lower_id_first(binned, max_leaves):
    """The second half of the rows mirrors the first (the same bins but for
    column 0, which separates the halves) with negated gradients: the
    root's two children hold mirrored sums, so their best gains are equal
    (both packages' sums negate exactly), as are their descendants'."""
    bins, _, cuts = binned
    half = N // 2
    mirrored = np.concatenate([bins[:half], bins[:half]])
    mirrored[:half, 0] = 0
    mirrored[half:, 0] = B - 1
    g, h = _grads(5)
    g = np.concatenate([g[:half], -g[:half]])
    h = np.concatenate([h[:half], h[:half]])
    ja, ta, _, _ = _grow_both(mirrored, cuts, g, h, max_leaves,
                              dict(max_depth=0))
    _assert_same_alloc(ja, ta, mirrored)
    assert int(ta.feature[0]) == 0
    assert float(ta.node_g[1]) == -float(ta.node_g[2])
    assert float(ta.node_h[1]) == float(ta.node_h[2])
    assert int(ta.left[1]) == 3  # node 1 popped before node 2
    if max_leaves == 3:
        assert int(ta.left[2]) == -1


# ---------------------------------------------------------------------------
# finalize_alloc: pointer doubling against the sequential passes
# ---------------------------------------------------------------------------

def _alloc_tree(kind, max_leaves, rng):
    """An allocation-ordered tree of ``max_leaves`` leaves: a chain (each
    split's right child splits next) or bushy (splits in id order)."""
    M = 2 * max_leaves - 1
    left = np.full(M, -1, np.int32)
    right = np.full(M, -1, np.int32)
    depth = np.zeros(M, np.int32)
    nxt, node = 1, 0
    for _ in range(max_leaves - 1):
        left[node], right[node] = nxt, nxt + 1
        depth[nxt] = depth[nxt + 1] = depth[node] + 1
        node = nxt + 1 if kind == "chain" else node + 1
        nxt += 2
    leaves = np.flatnonzero(left == -1)
    loss = np.where(left >= 0, rng.uniform(0, 1, M), 0).astype(np.float32)
    loss[np.flatnonzero(left >= 0)[-5:]] = 0.05  # prunable at gamma 0.3
    f = dict(left=left, right=right,
             feature=rng.randint(0, F, M).astype(np.int32),
             split_bin=rng.randint(0, B, M).astype(np.int32),
             split_cond=rng.randn(M).astype(np.float32),
             default_left=rng.rand(M) < 0.5,
             node_g=rng.randn(M).astype(np.float32),
             node_h=rng.uniform(1, 2, M).astype(np.float32),
             node_weight=rng.randn(M).astype(np.float32),
             loss_chg=loss,
             n_nodes=np.int32(M),
             positions=leaves[rng.randint(0, len(leaves), 300)].astype(
                 np.int32),
             cat_set=np.zeros((1, 1), bool), depth=depth)
    return (jlg.AllocTree(**{k: jnp.asarray(v) for k, v in f.items()}),
            tlg.AllocTree(**{k: _t(v) for k, v in f.items()}))


@pytest.mark.parametrize("kind", ["chain", "bushy"])
@pytest.mark.parametrize("gamma", [0.0, 0.3, 0.7])
def test_finalize_alloc_matches_sequential_passes(kind, gamma):
    ja, ta = _alloc_tree(kind, 60, np.random.RandomState(len(kind)))
    jk, jl, jd = jlg.finalize_alloc(ja, jnp.float32(0.3),
                                    jnp.float32(gamma))
    tk, tl, td = tlg.finalize_alloc(ta, 0.3, gamma)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    if gamma > 0:
        pruned = np.asarray(ja.left) >= 0
        assert (pruned & ~tk.numpy()).any()  # something was pruned


# ---------------------------------------------------------------------------
# training through the entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _pin_jax_route():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        yield
    jax.clear_caches()


BASE = {"objective": "binary:logistic", "max_bin": 16, "eta": 0.3,
        "grow_policy": "lossguide", "eval_metric": ["auc", "logloss"]}
TRAIN_CASES = {
    "leaves8": dict(max_leaves=8, max_depth=0),
    "leaves31_depth3": dict(max_leaves=31, max_depth=3),
    "leaves100": dict(max_leaves=100, max_depth=0),
}


@pytest.fixture(scope="module")
def sets():
    """Training rows with 5% missing values; held-out rows without: where
    no training row with a missing value reaches a node, its default
    direction is a tie either package may break either way."""
    X, y = _data(0, 2560)
    return (X[:2048], y[:2048]), (np.nan_to_num(X[2048:]), y[2048:])


@pytest.fixture(scope="module")
def trained(sets):
    (X, y), (Xv, yv) = sets
    out = {}
    for name, extra in TRAIN_CASES.items():
        p = {**BASE, **extra}
        jres, tres = {}, {}
        jb = xgb.train(p, xgb.DMatrix(X, label=y), 3,
                       evals=[(xgb.DMatrix(Xv, label=yv), "val")],
                       evals_result=jres, verbose_eval=False)
        tb = xgbt.train(p, xgbt.DMatrix(X, y, device="cpu"), 3,
                        evals=[(xgbt.DMatrix(Xv, yv, device="cpu"), "val")],
                        evals_result=tres, verbose_eval=False)
        out[name] = (p, jb, tb, jres, tres)
    return out


def _trees(model_json):
    return model_json["learner"]["gradient_booster"]["model"]["trees"]


def _missing_nodes(tree, X):
    """Nodes that a row of ``X`` with a missing split value reaches."""
    lc = np.asarray(tree["left_children"])
    rc = np.asarray(tree["right_children"])
    feat = np.asarray(tree["split_indices"])
    cond = np.asarray(tree["split_conditions"], np.float32)
    dl = np.asarray(tree["default_left"], bool)
    seen = set()
    for x in X:
        i = 0
        while lc[i] != -1:
            v = x[feat[i]]
            if np.isnan(v):
                seen.add(i)
            i = lc[i] if (dl[i] if np.isnan(v) else v < cond[i]) else rc[i]
    return seen


def _assert_same_trees(jt, tt, X):
    """Structure and split conditions exact, ``default_left`` where a
    training row with a missing value reaches the node, values within
    rtol 1e-5 (atol ``TOL``)."""
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        inner = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[inner],
            np.asarray(b["split_conditions"], np.float32)[inner])
        for i in _missing_nodes(a, X):
            assert a["default_left"][i] == b["default_left"][i], i
        for key in ("split_conditions", "base_weights"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-5, atol=TOL)


def _margins(bst, X, **kw):
    if isinstance(bst, xgb.Booster):
        return bst.predict(xgb.DMatrix(X), output_margin=True, **kw)
    return bst.predict(xgbt.DMatrix(X, device="cpu"), output_margin=True,
                       **kw)


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_matches_jax(sets, trained, case):
    p, jb, tb, jres, tres = trained[case]
    (X, _), (Xv, _) = sets
    _assert_same_trees(_trees(json.loads(jb.save_raw())),
                       _trees(tb.save_json()), X)
    for rows in (X, Xv):
        np.testing.assert_allclose(_margins(tb, rows), _margins(jb, rows),
                                   rtol=1e-5, atol=TOL)
    for m in ("auc", "logloss"):
        np.testing.assert_allclose(np.rint(np.asarray(tres["val"][m]) * 1e6),
                                   np.rint(np.asarray(jres["val"][m]) * 1e6),
                                   rtol=0, atol=1.0)
    assert tres["val"]["auc"][-1] > tres["val"]["auc"][0]
    leaves = [(len(t["left_children"]) + 1) // 2
              for t in _trees(tb.save_json())]
    assert max(leaves) <= p["max_leaves"]
    assert tb.num_boosted_rounds() == 3


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_ranges_and_slices_match_jax(sets, trained, case):
    _, jb, tb, _, _ = trained[case]
    (_, _), (Xv, _) = sets
    for rng in [(0, 1), (1, 3), (2, 0)]:
        np.testing.assert_allclose(_margins(tb, Xv, iteration_range=rng),
                                   _margins(jb, Xv, iteration_range=rng),
                                   rtol=1e-5, atol=TOL)
        np.testing.assert_allclose(
            tb.inplace_predict(Xv, iteration_range=rng,
                               predict_type="margin"),
            _margins(jb, Xv, iteration_range=rng), rtol=1e-5, atol=TOL)
    for sl in (slice(1, 3), slice(0, 3, 2), 2):
        js, ts = jb[sl], tb[sl]
        assert ts.num_boosted_rounds() == js.num_boosted_rounds()
        np.testing.assert_allclose(_margins(ts, Xv), _margins(js, Xv),
                                   rtol=1e-5, atol=TOL)


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_json_loads_in_both_directions(sets, trained, case):
    _, jb, tb, _, _ = trained[case]
    (_, _), (Xv, _) = sets
    in_port = xgbt.Booster(model_file=jb.save_raw(), device="cpu")
    np.testing.assert_allclose(_margins(in_port, Xv), _margins(jb, Xv),
                               rtol=1e-5, atol=TOL)
    in_jax = xgb.Booster(model_file=bytearray(tb.save_raw()))
    np.testing.assert_allclose(_margins(in_jax, Xv), _margins(tb, Xv),
                               rtol=1e-5, atol=TOL)
    assert json.loads(in_jax.save_raw())["learner"]["gradient_booster"] \
        == tb.save_json()["learner"]["gradient_booster"]


def test_pickle_and_continuation(sets):
    (X, y), (Xv, _) = sets
    p = {**BASE, **TRAIN_CASES["leaves31_depth3"]}
    d = xgbt.DMatrix(X, y, device="cpu")
    straight = xgbt.train(p, d, 5, verbose_eval=False)
    first = xgbt.train(p, d, 3, verbose_eval=False)
    again = pickle.loads(pickle.dumps(first))
    assert again.save_raw() == first.save_raw()
    np.testing.assert_array_equal(_margins(again, Xv), _margins(first, Xv))
    cont = xgbt.train(p, d, 2, xgb_model=again, verbose_eval=False)
    assert cont.num_boosted_rounds() == 5
    assert _trees(cont.save_json())[:3] == _trees(straight.save_json())[:3]
    np.testing.assert_allclose(_margins(cont, Xv), _margins(straight, Xv),
                               rtol=1e-6, atol=1e-6)


def test_max_leaves_changes_nothing_under_depthwise(sets):
    (X, y), _ = sets
    d = xgbt.DMatrix(X, y, device="cpu")
    p = {"objective": "binary:logistic", "max_bin": 16, "max_depth": 3}
    a = xgbt.train(p, d, 2, verbose_eval=False)
    b = xgbt.train({**p, "max_leaves": 3}, d, 2, verbose_eval=False)
    assert a.save_raw() == b.save_raw()
