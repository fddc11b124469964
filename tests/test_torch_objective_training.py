"""Port parity for training with the regression family and the survival
objectives: both packages train 3 rounds at depth 3, ``max_bin`` 16, on
the same 2048 x 6 rows with 5% NaNs and labels that suit each objective
(counts, amounts, compound Poisson-Gamma with zeros, heavy-tailed noise,
soft and binary labels, censored times), the JAX package pinned to its
per-level float route, the port on the CPU.

Tolerances: the trees have the same structure, split features and
conditions (exact), ``default_left`` equal where a row with a missing split
value reaches the node; margins within 1e-5 (relative, atol 1e-5); the
default metric's history within 1e-6 (one unit of its 6th decimal).
``survival:cox`` sums its risk sets in float64 in the port and in float32
in the JAX package, so its gradients differ by ulps; its trees are compared
exactly all the same (they agree on this data) and its margins within
1e-5. An explicit ``max_delta_step`` of 0 reaches both the tree parameters
and ``count:poisson`` (whose own default is 0.7) and survives pickling.
"""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt

torch.set_num_threads(1)

BASE = {"max_depth": 3, "max_bin": 16, "eta": 0.3}
CPU = dict(device="cpu")
N, NV, F = 2048, 512, 6


def _score_data(seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(N + NV, F).astype(np.float32)
    X[rng.rand(N + NV, F) < 0.05] = np.nan
    s = np.nan_to_num(X) @ (rng.randn(F) * 0.5)
    return rng, X, s


def _labels(objective, rng, s):
    """``(label, label_lower, label_upper)`` for ``objective`` from the
    linear score ``s``."""
    n = s.shape[0]
    if objective == "count:poisson":
        return rng.poisson(np.exp(0.5 * s)), None, None
    if objective == "reg:tweedie":
        counts = rng.poisson(0.4 * np.exp(0.5 * s))
        return np.array([rng.gamma(2.0, 1.0, c).sum() for c in counts]), \
            None, None
    if objective == "reg:gamma":
        return rng.gamma(2.0, np.exp(0.3 * s) / 2.0), None, None
    if objective == "reg:pseudohubererror":
        return s + rng.standard_t(2.0, n), None, None
    if objective == "reg:squaredlogerror":
        return np.expm1(np.abs(s) + 0.2 * rng.rand(n)), None, None
    if objective == "reg:logistic":
        return 1.0 / (1.0 + np.exp(-s - 0.3 * rng.randn(n))), None, None
    if objective in ("binary:logitraw", "binary:hinge"):
        return (s + 0.5 * rng.randn(n) > 0).astype(np.float64), None, None
    t = np.exp(1.0 + 0.5 * s + 0.4 * rng.randn(n))
    if objective == "survival:cox":  # negative: censored
        return np.where(rng.rand(n) < 0.3, -t, t), None, None
    kind = rng.rand(n)  # survival:aft: 60% exact, 30% right, 10% interval
    lower = np.where(kind < 0.9, t, t * 0.6)
    upper = np.select([kind < 0.6, kind < 0.9], [t, np.inf], t * 1.8)
    lower = np.where((kind >= 0.6) & (kind < 0.9), t * rng.uniform(0.5, 1.0, n),
                     lower)
    return lower, lower, upper


def _f32(a):
    return None if a is None else np.asarray(a, np.float32)


def _matrices(X, y, lo, hi, sl):
    kw = {}
    if lo is not None:
        kw = dict(label_lower_bound=_f32(lo[sl]), label_upper_bound=_f32(hi[sl]))
    return (xgb.DMatrix(X[sl], label=_f32(y[sl]), **kw),
            xgbt.DMatrix(X[sl], _f32(y[sl]), **kw, **CPU))


def _train_both(params, seed=0):
    rng, X, s = _score_data(seed)
    y, lo, hi = _labels(params["objective"], rng, s)
    (jd, td), (jv, tv) = (_matrices(X, y, lo, hi, sl)
                          for sl in (slice(0, N), slice(N, None)))
    jres, tres = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        jb = xgb.train(params, jd, 3, evals=[(jv, "val")], evals_result=jres,
                       verbose_eval=False)
    tb = xgbt.train(params, td, 3, evals=[(tv, "val")], evals_result=tres,
                    verbose_eval=False)
    return jb, tb, jres, tres, X


def _trees(b):
    j = b.save_json() if isinstance(b, xgbt.Booster) else json.loads(
        b.save_raw())
    return j["learner"]["gradient_booster"]["model"]["trees"]


def _missing_nodes(tree, X):
    lc, rc = np.asarray(tree["left_children"]), np.asarray(
        tree["right_children"])
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


def _assert_same(jb, tb, jres, tres, X):
    jt, tt = _trees(jb), _trees(tb)
    assert len(jt) == len(tt) == 3
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        internal = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[internal],
            np.asarray(b["split_conditions"], np.float32)[internal])
        for i in _missing_nodes(a, X[:N]):
            if internal[i]:
                assert a["default_left"][i] == b["default_left"][i], i
    Xv = X[N:]
    np.testing.assert_allclose(
        tb.predict(xgbt.DMatrix(Xv, **CPU), output_margin=True),
        jb.predict(xgb.DMatrix(Xv), output_margin=True), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(tb.predict(xgbt.DMatrix(Xv, **CPU)),
                               jb.predict(xgb.DMatrix(Xv)), rtol=1e-5,
                               atol=1e-5)
    assert list(tres["val"]) == list(jres["val"])
    for name, vals in jres["val"].items():
        np.testing.assert_allclose(np.rint(np.asarray(tres["val"][name]) * 1e6),
                                   np.rint(np.asarray(vals) * 1e6), rtol=0,
                                   atol=1)


CASES = [
    {"objective": "count:poisson"},
    {"objective": "reg:tweedie", "tweedie_variance_power": 1.3},
    {"objective": "reg:pseudohubererror", "huber_slope": 1.5},
    {"objective": "reg:gamma"},
    {"objective": "reg:squaredlogerror"},
    {"objective": "reg:logistic"},
    {"objective": "binary:logitraw"},
    {"objective": "binary:hinge"},
    {"objective": "survival:aft", "aft_loss_distribution": "normal",
     "aft_loss_distribution_scale": 1.2,
     "eval_metric": ["aft-nloglik", "interval-regression-accuracy"]},
    {"objective": "survival:cox"},
]


@pytest.mark.parametrize("params", CASES, ids=[c["objective"] for c in CASES])
def test_training_matches_jax(params):
    jb, tb, jres, tres, X = _train_both({**BASE, **params})
    _assert_same(jb, tb, jres, tres, X)
    # the port's model loads into the JAX package and back
    raw = tb.save_raw()
    assert json.loads(raw)["learner"]["objective"]["name"] == \
        params["objective"]
    Xv = X[N:]
    np.testing.assert_allclose(
        xgb.Booster(model_file=bytearray(raw)).predict(xgb.DMatrix(Xv)),
        tb.predict(xgbt.DMatrix(Xv, **CPU)), rtol=1e-5, atol=1e-5)
    port = xgbt.Booster(model_file=jb.save_raw(), **CPU)
    np.testing.assert_allclose(port.predict(xgbt.DMatrix(Xv, **CPU)),
                               jb.predict(xgb.DMatrix(Xv)), rtol=1e-5,
                               atol=1e-5)


def test_explicit_zero_max_delta_step_reaches_both_layers_and_pickles():
    """``max_delta_step`` 0 set by the caller: the trees are the JAX
    package's, the Poisson objective uses 0 (not its own 0.7) and the tree
    parameters get 0 too; after a pickle round trip both still hold (the
    JAX package's ``test_golden_poisson_mds_survives_pickle``)."""
    params = {**BASE, "objective": "count:poisson", "max_delta_step": 0.0}
    jb, tb, jres, tres, X = _train_both(params)
    _assert_same(jb, tb, jres, tres, X)
    assert tb._obj._max_delta_step() == 0.0
    assert tb._gbm.train_param.max_delta_step == 0.0
    back = pickle.loads(pickle.dumps(tb))
    assert back._obj._max_delta_step() == 0.0
    assert back._gbm.train_param.max_delta_step == 0.0
    # unset: the objective's 0.7, the trees' 0, before and after a pickle
    rng = np.random.RandomState(0)
    Xs = rng.randn(200, 3).astype(np.float32)
    ys = rng.poisson(2.0, 200).astype(np.float32)
    d = xgbt.DMatrix(Xs, ys, **CPU)
    b = xgbt.train({"objective": "count:poisson", "max_depth": 2}, d, 2,
                   verbose_eval=False)
    b2 = pickle.loads(pickle.dumps(b))
    assert b2._obj._max_delta_step() == pytest.approx(0.7)
    assert b2._gbm.train_param.max_delta_step == 0.0
    b3 = xgbt.train({"objective": "count:poisson", "max_depth": 2,
                     "max_delta_step": 0.1}, d, 2, verbose_eval=False)
    b4 = pickle.loads(pickle.dumps(b3))
    assert b4._obj._max_delta_step() == pytest.approx(0.1)
    assert b4._gbm.train_param.max_delta_step == pytest.approx(0.1)


def test_label_bounds_slice_and_float_info():
    rng, X, s = _score_data(1)
    y, lo, hi = _labels("survival:aft", rng, s)
    d = xgbt.DMatrix(X, _f32(y), label_lower_bound=_f32(lo), **CPU)
    d.set_float_info("label_upper_bound", _f32(hi))
    np.testing.assert_array_equal(d.get_float_info("label_upper_bound"),
                                  _f32(hi))
    idx = np.arange(0, X.shape[0], 7)
    sl = d.slice(idx)
    for field in ("label", "label_lower_bound", "label_upper_bound"):
        np.testing.assert_array_equal(sl.get_float_info(field),
                                      d.get_float_info(field)[idx])
    assert xgbt.DMatrix(X, **CPU).get_float_info("label_lower_bound").size \
        == 0
    with pytest.raises(ValueError, match="unknown float field"):
        d.set_float_info("qid", y)
