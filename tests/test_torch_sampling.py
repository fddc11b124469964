"""Port parity: row and column sampling and monotone and interaction
constraints against the JAX package.

Transforms. Each sampler of the port is a threefry draw followed by a
deterministic transform; the transforms get the JAX package's own draws
(``jax.random`` values made into tensors) and must give its masks exactly:
``select_features`` (a permutation, or Gumbel top-k with feature weights),
``exact_k_from_uniform`` and ``bernoulli_rows``. The port's own draws are
bitwise ``jax.random``'s (``tests/test_torch_random.py``), so the whole
samplers agree too, but for weighted column sampling, whose Gumbel noise
is within 4 ulps: the chosen features are equal for the seeds here.

MVS (``gradient_based``). The JAX package takes its suffix sums in float32
in XLA's association, the port in float64 rounded once, so ``tau`` may move
by ulps: the kept rows must be equal except rows whose uniform lies within
1e-6 relative of their keep probability, and the scaled gradients agree
within rtol 1e-5. Also at ``reg_lambda=0`` (the hessian lane unbounded).

Constraints. ``child_bounds_and_weights`` and ``interaction_allowed`` are
elementwise and set logic: equal within rtol 1e-6 and exactly. The
monotone branch of ``eval_splits`` picks the same feature, bin and
direction, loss and child sums within rtol 1e-6. ``_level_update`` of both
packages on the same histogram and parent state with per-level and
per-node column samples, monotone bounds and interaction sets, at d = 0 and
2, writes the same heap (bounds and used sets included; floats within
rtol 1e-6).

Whole training. 3 rounds at depth 3, max_bin 16, on 2048 x 6 rows with 5%
NaN (512 held out, one labelling rule), for (a) subsample 0.7 uniform and
all three colsample at 0.7 with seed 3, (b) gradient_based at 0.5 with
weighted colsample_bytree 0.5, (c) monotone (1,-1,0,0,1,0), (d)
interaction [[0,1],[2,3,4],[5]]. The JAX package pinned to its per-level
float route (``XGBTPU_DISPATCH=tree_grow=level,sibling_sub=off,
hist_acc=float``). Same tree structure, split features and conditions, and
default_left at the nodes that saw missing values (elsewhere a tie, as in
``tests/test_torch_slice.py``); margins within 1e-5; held-out AUC within
1e-6. Both learners keep ``seed`` to themselves (their trees never see it
through ``train``'s parameters: a seed there grows both packages' seed-0
trees); each side gets the seed by ``set_param`` on the configured
booster, before the first round. A custom objective's ``update(d, i,
fobj)`` samples as round ``num_boosted_rounds()`` in both, whatever ``i``.

The port's own checks: predictions monotone along each constrained feature
on a grid (exactly: every tree is monotone and float addition is); every
root-to-leaf path inside one interaction group; two runs bitwise equal;
another seed grows other trees; ``set_param("subsample", ...)`` reaches
the next tree; the unknown ``sampling_method`` message is the JAX
package's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu.tree import grow as jgrow
from xgboost_tpu.tree import grow_fused as jgf
from xgboost_tpu.tree.param import SplitParams as JSplitParams
from xgboost_tpu_torch import threefry as tf
from xgboost_tpu_torch.tree import grow as tgrow
from xgboost_tpu_torch.tree import grow_fused as tgf
from xgboost_tpu_torch.tree.param import SplitParams as TSplitParams

torch.set_num_threads(1)

F = 6
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16,
          "eta": 0.3, "eval_metric": ["auc", "logloss"]}
FEATURE_WEIGHTS = np.array([1.0, 2.0, 3.0, 0.5, 4.0, 1.0], np.float32)
MONO = (1, -1, 0, 0, 1, 0)
GROUPS = [[0, 1], [2, 3, 4], [5]]
CONFIGS = {
    "a": dict(subsample=0.7, colsample_bytree=0.7, colsample_bylevel=0.7,
              colsample_bynode=0.7, seed=3),
    "b": dict(subsample=0.5, sampling_method="gradient_based",
              colsample_bytree=0.5),
    "c": dict(monotone_constraints="(1,-1,0,0,1,0)"),
    "d": dict(interaction_constraints="[[0,1],[2,3,4],[5]]"),
}


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# transforms on the JAX package's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_features,frac", [(6, 0.5), (6, 0.7), (50, 0.3),
                                              (50, 0.02)])
@pytest.mark.parametrize("weighted", [False, True])
def test_sample_features_exact(n_features, frac, weighted):
    rng = np.random.RandomState(n_features)
    w = (rng.uniform(0.0, 3.0, n_features).astype(np.float32)
         if weighted else None)
    if weighted:
        w[1] = 0.0  # a feature that is never chosen while others remain
    k = max(1, int(round(frac * n_features)))
    for seed in range(4):
        jk = jax.random.PRNGKey(seed)
        want = np.asarray(jgrow._sample_features_exact(
            jk, n_features, frac, None if w is None else jnp.asarray(w)))
        draw = (jax.random.gumbel(jk, (n_features,)) if weighted
                else jax.random.permutation(jk, n_features))
        got = tgrow.select_features(_t(draw), k,
                                    None if w is None else _t(w))
        np.testing.assert_array_equal(got.numpy(), want)
        full = tgrow._sample_features_exact(tf.prng_key(seed), n_features,
                                            frac,
                                            None if w is None else _t(w))
        np.testing.assert_array_equal(full.numpy(), want)
        assert full.sum() == k


@pytest.mark.parametrize("shape,k", [((6,), 3), ((4, 6), 2), ((8, 50), 7)])
def test_exact_k_subset(shape, k):
    rng = np.random.RandomState(k)
    parent = rng.rand(*shape) < 0.8
    parent[..., :k] = True  # at least k features to choose from
    for seed in range(3):
        jk = jax.random.PRNGKey(seed)
        want = np.asarray(jgrow.exact_k_subset(jk, jnp.asarray(parent), k))
        u = np.asarray(jax.random.uniform(jk, shape))
        got = tgrow.exact_k_from_uniform(_t(u), _t(parent), k)
        np.testing.assert_array_equal(got.numpy(), want)
        full = tgrow.exact_k_subset(tf.prng_key(seed), _t(parent), k)
        np.testing.assert_array_equal(full.numpy(), want)
        assert (full.numpy().sum(axis=-1) == k).all()
        assert not (full.numpy() & ~parent).any()


def test_exact_k_subset_keeps_ties():
    """Uniforms that tie at the k-th value keep more than k features, as
    ``score >= kth`` does in the JAX package."""
    u = torch.tensor([0.5, 0.25, 0.5, 0.75])
    parent = torch.ones(4, dtype=torch.bool)
    got = tgrow.exact_k_from_uniform(u, parent, 2)
    assert got.tolist() == [True, False, True, True]


def _grad_hess(n, seed, zero_g=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    g[:zero_g] = 0.0
    return g, h


@pytest.mark.parametrize("subsample", [0.5, 0.8])
def test_uniform_row_sampling(subsample):
    g, h = _grad_hess(3000, 1)
    jcfg = jgrow.GrowParams(subsample=subsample)
    tcfg = tgrow.GrowParams(subsample=subsample)
    for seed in range(3):
        jk = jax.random.PRNGKey(seed)
        jg, jh = jgrow.apply_row_sampling(jcfg, jk, jnp.asarray(g),
                                          jnp.asarray(h))
        u = np.asarray(jax.random.uniform(jk, (3000,)))
        tg, th = tgrow.bernoulli_rows(_t(u), _t(g), _t(h), subsample)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        fg, fh = tgrow.apply_row_sampling(tcfg, tf.prng_key(seed), _t(g),
                                          _t(h))
        np.testing.assert_array_equal(fg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(fh.numpy(), np.asarray(jh))
    # the JAX package draws over padded rows: the port's [n] draw is the
    # prefix of its [n_pad] one
    jg, _ = jgrow.apply_row_sampling(
        jcfg, jax.random.PRNGKey(0), jnp.asarray(np.pad(g, (0, 1096))),
        jnp.asarray(np.pad(h, (0, 1096))))
    fg, _ = tgrow.apply_row_sampling(tcfg, tf.prng_key(0), _t(g), _t(h))
    np.testing.assert_array_equal(fg.numpy(), np.asarray(jg)[:3000])


def _check_mvs(jg, jh, tg, th, u, h):
    """Kept rows equal but for rows whose uniform lies within 1e-6
    relative of their keep probability; scaled g and h within rtol 1e-5."""
    jkeep, tkeep = jh != 0.0, th != 0.0
    for i in np.flatnonzero(jkeep != tkeep):
        hs = jh[i] if jkeep[i] else th[i]
        p = h[i] / hs
        assert abs(u[i] - p) <= 1e-6 * p, (i, u[i], p)
    both = jkeep & tkeep
    np.testing.assert_allclose(tg[both], jg[both], rtol=1e-5)
    np.testing.assert_allclose(th[both], jh[both], rtol=1e-5)
    return (jkeep != tkeep).sum()


@pytest.mark.parametrize("reg_lambda", [1.0, 0.0])
@pytest.mark.parametrize("subsample", [0.3, 0.5, 0.9])
def test_mvs_sample(reg_lambda, subsample):
    n = 4000
    g, h = _grad_hess(n, 2, zero_g=40)
    g[40:50] = np.where(g[40:50] >= 0, 30.0, -30.0)  # p = 1: always kept
    for seed in range(3):
        jk = jax.random.PRNGKey(seed)
        jg, jh = (np.asarray(a) for a in jgrow.mvs_sample(
            jk, jnp.asarray(g), jnp.asarray(h), subsample, reg_lambda))
        u = np.asarray(jax.random.uniform(jk, (n,)))
        tg, th = (a.numpy() for a in tgrow.mvs_from_uniform(
            _t(u), _t(g), _t(h), subsample, reg_lambda))
        _check_mvs(jg, jh, tg, th, u, h)
        fg, fh = (a.numpy() for a in tgrow.mvs_sample(
            tf.prng_key(seed), _t(g), _t(h), subsample, reg_lambda))
        np.testing.assert_array_equal(fg, tg)
        np.testing.assert_array_equal(fh, th)
        assert np.isfinite(fg).all() and np.isfinite(fh).all()
        # the expected kept count is subsample x the live rows
        live = (np.sqrt(g * g + reg_lambda * h * h) > 0).sum()
        assert abs((th != 0).sum() - subsample * live) < 4 * np.sqrt(live)
        if reg_lambda == 0.0:
            # u = |g|: rows with no gradient are never kept
            assert (th[:40] == 0).all()
        assert (th[40:50] == h[40:50]).all()  # p = 1: kept, unscaled


def test_child_bounds_and_weights():
    rng = np.random.RandomState(3)
    K = 16
    GL, GR = rng.randn(K).astype(np.float32), rng.randn(K).astype(np.float32)
    HL = rng.uniform(0.5, 3, K).astype(np.float32)
    HR = rng.uniform(0.5, 3, K).astype(np.float32)
    lo = np.where(rng.rand(K) < 0.5, -np.inf, rng.uniform(-1, 0, K)
                  ).astype(np.float32)
    up = np.where(rng.rand(K) < 0.5, np.inf, rng.uniform(0, 1, K)
                  ).astype(np.float32)
    mono_f = rng.randint(-1, 2, K).astype(np.int32)
    for kw in (dict(), dict(reg_lambda=0.5, max_delta_step=0.3)):
        want = jgrow.child_bounds_and_weights(
            JSplitParams(**kw), jnp.asarray(mono_f), *(jnp.asarray(a) for a in
                                                       (GL, HL, GR, HR, lo,
                                                        up)))
        got = tgrow.child_bounds_and_weights(
            TSplitParams(**kw), _t(mono_f), *(_t(a) for a in
                                              (GL, HL, GR, HR, lo, up)))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_interaction_allowed():
    rng = np.random.RandomState(4)
    Fw, K = 9, 32
    gmask = np.zeros((3, Fw), bool)
    for gi, grp in enumerate([[0, 1, 2], [2, 3, 4, 5], [6, 7, 8, 0]]):
        gmask[gi, grp] = True
    used = rng.rand(K, Fw) < 0.15
    used[0] = False  # the root: everything allowed
    want = np.asarray(jgrow.interaction_allowed(jnp.asarray(used),
                                                jnp.asarray(gmask)))
    got = tgrow.interaction_allowed(_t(used), _t(gmask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].all()


# ---------------------------------------------------------------------------
# split evaluation and the level update with constraints and samples
# ---------------------------------------------------------------------------

K, B = 4, 16


def _hist(seed):
    rng = np.random.RandomState(seed)
    g = rng.randn(K, F, B + 1).astype(np.float32)
    h = rng.uniform(0.0, 3.0, size=(K, F, B + 1)).astype(np.float32)
    return np.stack([g, h], axis=-1)


@pytest.mark.parametrize("seed", range(3))
def test_eval_splits_monotone(seed):
    hist = _hist(seed)
    G = hist[..., 0].sum(axis=2)[:, 0]
    H = hist[..., 1].sum(axis=2)[:, 0]
    rng = np.random.RandomState(10 + seed)
    mono = np.array(MONO, np.int32)
    lo = np.array([-np.inf, -0.3, -np.inf, -0.1], np.float32)
    up = np.array([np.inf, np.inf, 0.2, 0.4], np.float32)
    fmask = rng.rand(K, F) < 0.8
    fmask[:, 0] = True
    p = dict(reg_lambda=0.7)
    jd = jgrow.eval_splits(jnp.asarray(hist), jnp.asarray(G), jnp.asarray(H),
                           JSplitParams(**p), jnp.asarray(fmask), B,
                           mono=jnp.asarray(mono), node_lo=jnp.asarray(lo),
                           node_up=jnp.asarray(up))
    td = tgrow.eval_splits(_t(hist), _t(G), _t(H), TSplitParams(**p),
                           _t(fmask), B, mono=_t(mono), node_lo=_t(lo),
                           node_up=_t(up))
    for name in ("f", "b", "dir"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)), name)
    for name in ("loss", "GL", "HL", "w_node"):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)), rtol=1e-6,
                                   err_msg=name)
    # the clamped node weights lie inside their bounds
    w = td.w_node.numpy()
    assert ((w >= lo) & (w <= up)).all()


LEVEL_CASES = {
    "sampled": dict(colsample_bytree=0.7, colsample_bylevel=0.7,
                    colsample_bynode=0.7),
    "monotone": dict(monotone=MONO),
    "interaction": dict(interaction=tuple(tuple(g) for g in GROUPS)),
    "all": dict(colsample_bylevel=0.8, colsample_bynode=0.6, monotone=MONO,
                interaction=tuple(tuple(g) for g in GROUPS)),
}


@pytest.mark.parametrize("case", sorted(LEVEL_CASES))
@pytest.mark.parametrize("d", [0, 2])
def test_level_update_same_heap(d, case):
    """Both packages' _level_update on the same [F, 2K, B] histogram and
    the same parent state (totals, monotone bounds, used sets), with the
    tree's column sample and a level key: the same heap, bounds, used
    sets and decision table."""
    rng = np.random.RandomState(d + 7)
    Kd = 1 << d
    max_depth = 3
    g = rng.randn(F, Kd, B).astype(np.float32)
    h = rng.uniform(0.0, 2.0, size=(F, Kd, B)).astype(np.float32)
    histC = np.concatenate([g, h], axis=1)
    Gtot = g[0].sum(axis=1) + rng.uniform(-0.5, 0.5, Kd).astype(np.float32)
    Htot = h[0].sum(axis=1) + rng.uniform(0.0, 0.5, Kd).astype(np.float32)
    cuts = np.sort(rng.randn(F, B).astype(np.float32), axis=1)
    off = Kd - 1
    kw = LEVEL_CASES[case]
    max_nodes = (1 << (max_depth + 1)) - 1
    lo = np.full(max_nodes, -np.inf, np.float32)
    up = np.full(max_nodes, np.inf, np.float32)
    used = np.zeros((max_nodes, F), bool)
    if d > 0:
        lo[off:off + Kd] = [-0.2, -np.inf, -0.4, -0.05]
        up[off:off + Kd] = [np.inf, 0.1, 0.3, np.inf]
        used[off:off + Kd] = [[1, 0, 0, 0, 0, 0], [0, 0, 1, 1, 0, 0],
                              [0, 0, 0, 0, 0, 1], [1, 1, 0, 0, 0, 0]]
    tree_mask = np.array([1, 1, 0, 1, 1, 1], bool) \
        if kw.get("colsample_bytree", 1.0) < 1.0 else np.ones(F, bool)

    jcfg = jgrow.GrowParams(max_depth=max_depth, split=JSplitParams(), **kw)
    jst = jgf._init_state(jcfg, F, jnp.float32(0.0), jnp.float32(1.0))
    jst = jst._replace(node_g=jst.node_g.at[off:off + Kd].set(Gtot),
                       node_h=jst.node_h.at[off:off + Kd].set(Htot))
    if jcfg.has_monotone:
        jst = jst._replace(lo_b=jnp.asarray(lo), up_b=jnp.asarray(up))
    if jcfg.has_interaction:
        jst = jst._replace(used=jnp.asarray(used))
    jk = jax.random.split(jax.random.PRNGKey(5), 3)[2]
    jout = jgf._level_update(jst, jnp.asarray(histC), jnp.asarray(cuts),
                             jnp.asarray(tree_mask), jk, jcfg, d)

    tcfg = tgrow.GrowParams(max_depth=max_depth, split=TSplitParams(), **kw)
    tst = tgf._init_state(tcfg, torch.tensor([0.0, 1.0]), F=F)
    tst.node_g[off:off + Kd] = _t(Gtot)
    tst.node_h[off:off + Kd] = _t(Htot)
    if tcfg.has_monotone:
        tst = tst._replace(lo_b=_t(lo), up_b=_t(up))
    if tcfg.has_interaction:
        tst = tst._replace(used=_t(used))
    tk = tf.split(tf.prng_key(5), 3)[2]
    tout = tgf._level_update(tst, _t(histC), _t(cuts), tcfg, d,
                             _t(tree_mask), tk)

    exact = ["is_split", "feature", "split_bin", "split_cond", "default_left",
             "ptab"]
    if tcfg.has_interaction:
        exact.append("used")
    for name in exact:
        np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                      np.asarray(getattr(jout, name)), name)
    close = ["node_g", "node_h", "node_w", "loss_chg"]
    if tcfg.has_monotone:
        close += ["lo_b", "up_b"]
    for name in close:
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert tout.is_split.any()


# ---------------------------------------------------------------------------
# whole training against the JAX package
# ---------------------------------------------------------------------------

def _data(seed, n):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rng.randn(F) + 0.5 * rng.randn(n)) > 0
         ).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def data():
    X, y = _data(0, 2560)  # one labelling rule for both sets
    return (X[:2048], y[:2048]), (X[2048:], y[2048:])


class _SeedToTrees(xgb.callback.TrainingCallback):
    """Gives a booster's tree parameters the seed (both packages' learners
    keep ``seed`` out of them) before the first round."""

    def __init__(self, seed):
        self.seed = seed

    def before_training(self, model):
        model.num_boosted_rounds()  # configures the booster
        model.set_param("seed", self.seed)
        return model


def _train_both(params, X, y, Xv, yv, fw=None):
    jres, tres = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        jd = xgb.DMatrix(X, label=y)
        if fw is not None:
            jd.set_float_info("feature_weights", fw)
        jb = xgb.train(params, jd, 3,
                       evals=[(xgb.DMatrix(Xv, label=yv), "val")],
                       evals_result=jres, verbose_eval=False,
                       callbacks=[_SeedToTrees(params.get("seed", 0))])
    tb = xgbt.train(params, xgbt.DMatrix(X, y, feature_weights=fw,
                                         device="cpu"), 3,
                    evals=[(xgbt.DMatrix(Xv, yv, device="cpu"), "val")],
                    evals_result=tres, verbose_eval=False,
                    callbacks=[_SeedToTrees(params.get("seed", 0))])
    return jb, tb, jres, tres


@pytest.fixture(scope="module")
def trained(data):
    (X, y), (Xv, yv) = data
    out = {}
    for name, extra in CONFIGS.items():
        fw = FEATURE_WEIGHTS if name == "b" else None
        out[name] = _train_both({**PARAMS, **extra}, X, y, Xv, yv, fw)
    return out


def _trees(model_json):
    return model_json["learner"]["gradient_booster"]["model"]["trees"]


def _nodes_with_missing(tree, X):
    lc, rc = np.asarray(tree["left_children"]), np.asarray(tree["right_children"])
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
            left = dl[i] if np.isnan(v) else v < cond[i]
            i = lc[i] if left else rc[i]
    return seen


def _micro(values):
    return np.rint(np.asarray(values, np.float64) * 1e6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_same_trees_as_jax(data, trained, name):
    jb, tb, jres, tres = trained[name]
    (X, _), (Xv, _) = data
    jt, tt = _trees(json.loads(jb.save_raw())), _trees(tb.save_json())
    assert len(jt) == len(tt) == 3
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        inner = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[inner],
            np.asarray(b["split_conditions"], np.float32)[inner])
        trained_missing = _nodes_with_missing(a, X)
        any_missing = (trained_missing | _nodes_with_missing(b, X)
                       | _nodes_with_missing(a, Xv)
                       | _nodes_with_missing(b, Xv))
        for i in np.flatnonzero(inner):
            if i in trained_missing:
                assert a["default_left"][i] == b["default_left"][i], i
            elif a["default_left"][i] != b["default_left"][i]:
                assert i not in any_missing, i
    jm = jb.predict(xgb.DMatrix(Xv), output_margin=True)
    tm = tb.predict(xgbt.DMatrix(Xv, device="cpu"), output_margin=True)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_micro(tres["val"]["auc"]),
                               _micro(jres["val"]["auc"]), rtol=0, atol=1.0)
    assert tres["val"]["auc"][-1] > 0.7


def test_the_jax_seed_reached_its_trees(data, trained):
    """Config (a)'s JAX model used seed 3: the same training at seed 0
    grows other trees (so the comparison above is not at seed 0)."""
    (X, y), _ = data
    jb = trained["a"][0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        j0 = xgb.train({**PARAMS, **CONFIGS["a"], "seed": 0},
                       xgb.DMatrix(X, label=y), 3, verbose_eval=False)
    assert _trees(json.loads(j0.save_raw())) != _trees(
        json.loads(jb.save_raw()))


def test_a_seed_among_train_params_stays_at_the_learner(data):
    """The same parameters, seed 3 among them and no ``set_param``: both
    packages grow the seed-0 trees, and the same ones."""
    (X, y), _ = data
    p = {**PARAMS, **CONFIGS["a"], "seed": 3}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        jb = xgb.train(p, xgb.DMatrix(X, label=y), 2, verbose_eval=False)
    d = xgbt.DMatrix(X, y, device="cpu")
    tb = xgbt.train(p, d, 2, verbose_eval=False)
    t0 = xgbt.train({**p, "seed": 0}, d, 2, verbose_eval=False)
    jt, tt = _trees(json.loads(jb.save_raw())), _trees(tb.save_json())
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
    assert tt == _trees(t0.save_json())


def _logistic(pred, dtrain):
    p = 1.0 / (1.0 + np.exp(-np.asarray(pred, np.float64)))
    y = dtrain.get_label()
    return (p - y).astype(np.float32), (p * (1.0 - p)).astype(np.float32)


def test_custom_objective_update_samples_as_the_next_round(data):
    """``update(d, i, fobj)`` on a model continued from 2 rounds, with ``i``
    counting from 0: both packages sample as rounds 2 and 3
    (``num_boosted_rounds()``), not as rounds 0 and 1. Same trees, margins
    within 1e-5."""
    (X, y), (Xv, _) = data
    p = {**PARAMS, "subsample": 0.7, "colsample_bynode": 0.7}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        jd = xgb.DMatrix(X, label=y)
        jb = xgb.train(p, jd, 2, verbose_eval=False)
        for i in range(2):
            jb.update(jd, i, _logistic)
        jm = jb.predict(xgb.DMatrix(Xv), output_margin=True)
    td = xgbt.DMatrix(X, y, device="cpu")
    tb = xgbt.train(p, td, 2, verbose_eval=False)
    for i in range(2):
        tb.update(td, i, _logistic)
    jt, tt = _trees(json.loads(jb.save_raw())), _trees(tb.save_json())
    assert len(jt) == len(tt) == 4
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
    tm = tb.predict(xgbt.DMatrix(Xv, device="cpu"), output_margin=True)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the port's own checks
# ---------------------------------------------------------------------------

def test_monotone_along_each_constrained_feature(data, trained):
    tb = trained["c"][1]
    (_, _), (Xv, _) = data
    rows = Xv[:200]
    for f, sign in enumerate(MONO):
        if sign == 0:
            continue
        grid = np.linspace(-3.0, 3.0, 21, dtype=np.float32)
        Xg = np.repeat(rows, grid.size, axis=0)
        Xg[:, f] = np.tile(grid, rows.shape[0])
        m = tb.predict(xgbt.DMatrix(Xg, device="cpu"), output_margin=True)
        steps = np.diff(m.reshape(rows.shape[0], grid.size), axis=1) * sign
        assert (steps >= 0).all(), f
        assert (steps > 0).any(), f  # the feature is used


def _paths(tree):
    lc, rc = tree["left_children"], tree["right_children"]
    feat = tree["split_indices"]
    out = []

    def walk(i, used):
        if lc[i] == -1:
            out.append(used)
            return
        walk(lc[i], used | {feat[i]})
        walk(rc[i], used | {feat[i]})
    walk(0, frozenset())
    return out


def test_interaction_paths_inside_one_group(trained):
    tb = trained["d"][1]
    n_split = 0
    for tree in _trees(tb.save_json()):
        for used in _paths(tree):
            n_split += len(used) > 1
            assert any(used <= set(g) for g in GROUPS), used
    assert n_split > 0


def _port_model(params, X, y, rounds=3, **kw):
    return xgbt.train(params, xgbt.DMatrix(X, y, device="cpu", **kw), rounds,
                      verbose_eval=False,
                      callbacks=[_SeedToTrees(params.get("seed", 0))]
                      ).save_raw()


def test_runs_repeat_bitwise_and_the_seed_matters(data):
    (X, y), _ = data
    p = {**PARAMS, **CONFIGS["a"]}
    first = _port_model(p, X, y)
    assert _port_model(p, X, y) == first
    assert _port_model({**p, "seed": 4}, X, y) != first
    pb = {**PARAMS, **CONFIGS["b"]}
    fb = _port_model(pb, X, y, feature_weights=FEATURE_WEIGHTS)
    assert _port_model(pb, X, y, feature_weights=FEATURE_WEIGHTS) == fb
    assert _port_model({**pb, "seed": 1}, X, y,
                       feature_weights=FEATURE_WEIGHTS) != fb


def test_set_param_reaches_the_next_tree(data):
    """A subsample set between rounds grows the next tree as a run
    continued at that subsample does, and not as the unsampled run."""
    (X, y), _ = data
    d = xgbt.DMatrix(X, y, device="cpu")
    bst = xgbt.Booster(PARAMS, [d], device="cpu")
    bst.update(d, 0)
    first = bst.copy()
    bst.set_param("subsample", 0.5)
    bst.update(d, 1)
    straight = xgbt.train(PARAMS, d, 2, verbose_eval=False)
    cont = xgbt.train({**PARAMS, "subsample": 0.5}, d, 1, xgb_model=first,
                      verbose_eval=False)
    t, t_straight, t_cont = (_trees(b.save_json())
                             for b in (bst, straight, cont))
    assert t[0] == t_straight[0] == t_cont[0]
    assert t[1] != t_straight[1]
    assert t[1] == t_cont[1]


def test_tree_seeds_are_the_jax_packages():
    from xgboost_tpu.gbm import gbtree as jgbt
    from xgboost_tpu_torch.gbm import gbtree as tgbt

    for args in [(0, 0, 0), (3, 7, 0), (2 ** 31 - 1, 499, 1), (42, 12, 2)]:
        assert tgbt.round_seed_py(*args) == jgbt.round_seed_py(*args)


def test_unknown_sampling_method_message(data):
    (X, y), _ = data
    p = {**PARAMS, "sampling_method": "bogus"}
    with pytest.raises(ValueError) as je:
        xgb.train(p, xgb.DMatrix(X, label=y), 1, verbose_eval=False)
    with pytest.raises(ValueError) as te:
        xgbt.train(p, xgbt.DMatrix(X, y, device="cpu"), 1, verbose_eval=False)
    assert str(te.value) == str(je.value) == "Unknown sampling_method: bogus"


def test_feature_weights_travel_with_the_matrix(data):
    (X, y), _ = data
    d = xgbt.DMatrix(X, y, device="cpu", feature_weights=FEATURE_WEIGHTS)
    np.testing.assert_array_equal(d.get_feature_weights(), FEATURE_WEIGHTS)
    np.testing.assert_array_equal(d.slice([0, 5, 9]).get_feature_weights(),
                                  FEATURE_WEIGHTS)
    d.set_feature_weights(np.ones(F))
    assert d.feature_weights.dtype == torch.float32
    assert xgbt.DMatrix(X, device="cpu").get_feature_weights().size == 0
