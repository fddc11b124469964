"""Port parity for multiclass training: ``multi:softprob`` and
``multi:softmax`` with 3 classes, 3 rounds, depth 3, ``max_bin`` 16 on
2048 x 6 rows with 5% NaNs (labels: the argmax of a linear score plus
Gumbel noise), the JAX package pinned to its per-level float route
(``XGBTPU_DISPATCH=tree_grow=level,sibling_sub=off,hist_acc=float``), the
port on the CPU.

Tolerances: the 9 trees (tree ``k`` of round ``i`` grown from column
``k`` of the gradient, ``tree_info`` ``[0, 1, 2]`` per round) have the same
structure, split features and conditions (exact), ``default_left`` equal
where a row with a missing split value reaches the node, leaf values within
rtol 1e-5; margins and probabilities within 1e-5; the ``merror``,
``mlogloss`` and ``auc`` histories within 1e-6 (one unit of the 6th decimal
they are rounded to); models carry across as the XGBoost JSON both ways,
predicting within 1e-5; every prediction shape (``output_margin``,
``strict_shape``, ``pred_leaf``, ``iteration_range``, ``inplace_predict``)
equals the JAX package's.
"""

import json

import jax
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt

torch.set_num_threads(1)

K = 3
PARAMS = {"objective": "multi:softprob", "num_class": K, "max_depth": 3,
          "max_bin": 16, "eta": 0.3,
          "eval_metric": ["merror", "mlogloss", "auc"]}
CPU = dict(device="cpu")


def _data(seed=0, n=2560, F=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    W = rng.randn(F, K)
    y = np.argmax(np.nan_to_num(X) @ W + rng.gumbel(size=(n, K)), 1)
    return X[:2048], y[:2048].astype(np.float32), X[2048:], \
        y[2048:].astype(np.float32)


def _pinned(fn):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        return fn()


def _train_both(params, rounds=3, data=None, **kw):
    X, y, Xv, yv = data if data is not None else _data()
    jres, tres = {}, {}
    jb = _pinned(lambda: xgb.train(
        params, xgb.DMatrix(X, label=y), rounds,
        evals=[(xgb.DMatrix(Xv, label=yv), "val")], evals_result=jres,
        verbose_eval=False, **kw))
    tb = xgbt.train(params, xgbt.DMatrix(X, y, **CPU), rounds,
                    evals=[(xgbt.DMatrix(Xv, yv, **CPU), "val")],
                    evals_result=tres, verbose_eval=False, **kw)
    return jb, tb, jres, tres


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def softprob(data):
    return _train_both(PARAMS, data=data)


def _model(b):
    j = b.save_json() if isinstance(b, xgbt.Booster) else json.loads(
        b.save_raw())
    return j["learner"]["gradient_booster"]["model"]


def _missing_nodes(tree, X):
    """Nodes reached by a row whose split value is missing."""
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
            left = dl[i] if np.isnan(v) else v < cond[i]
            i = lc[i] if left else rc[i]
    return seen


def assert_same_trees(jb, tb, X):
    jm, tm = _model(jb), _model(tb)
    assert jm["tree_info"] == tm["tree_info"]
    assert len(jm["trees"]) == len(tm["trees"])
    for a, b in zip(jm["trees"], tm["trees"]):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        internal = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[internal],
            np.asarray(b["split_conditions"], np.float32)[internal])
        np.testing.assert_allclose(b["split_conditions"],
                                   a["split_conditions"], rtol=1e-5,
                                   atol=1e-6)
        for i in _missing_nodes(a, X):
            if internal[i]:
                assert a["default_left"][i] == b["default_left"][i], i


def _micro(v):
    return np.rint(np.asarray(v, np.float64) * 1e6)


def test_nine_trees_margins_and_histories_match_jax(data, softprob):
    X, _, Xv, _ = data
    jb, tb, jres, tres = softprob
    assert tb.n_groups == K and tb.num_boosted_rounds() == 3
    assert_same_trees(jb, tb, X)
    assert _model(tb)["tree_info"] == [0, 1, 2] * 3
    jm = jb.predict(xgb.DMatrix(Xv), output_margin=True)
    tm = tb.predict(xgbt.DMatrix(Xv, **CPU), output_margin=True)
    assert tm.shape == jm.shape == (Xv.shape[0], K)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)
    tp = tb.predict(xgbt.DMatrix(Xv, **CPU))
    np.testing.assert_allclose(tp, jb.predict(xgb.DMatrix(Xv)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tp.sum(1), 1.0, atol=1e-6)
    for name in ("merror", "mlogloss", "auc"):
        np.testing.assert_allclose(_micro(tres["val"][name]),
                                   _micro(jres["val"][name]), rtol=0, atol=1)
    assert tres["val"]["mlogloss"][-1] < tres["val"]["mlogloss"][0]


def test_models_carry_across(data, softprob):
    _, _, Xv, _ = data
    jb, tb, _, _ = softprob
    port = xgbt.Booster(model_file=jb.save_raw(), **CPU)
    assert port.n_groups == K and port._obj.name == "multi:softprob"
    np.testing.assert_allclose(port.predict(xgbt.DMatrix(Xv, **CPU)),
                               jb.predict(xgb.DMatrix(Xv)), rtol=1e-5,
                               atol=1e-5)
    raw = tb.save_raw()
    lmp = json.loads(raw)["learner"]
    assert lmp["learner_model_param"]["num_class"] == str(K)
    assert lmp["objective"]["name"] == "multi:softprob"
    back = xgb.Booster(model_file=bytearray(raw))
    np.testing.assert_allclose(back.predict(xgb.DMatrix(Xv)),
                               tb.predict(xgbt.DMatrix(Xv, **CPU)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [
    {}, {"output_margin": True}, {"strict_shape": True},
    {"output_margin": True, "strict_shape": True}, {"pred_leaf": True},
    {"iteration_range": (1, 3)}, {"iteration_range": (0, 1),
                                  "output_margin": True},
    {"ntree_limit": 6}])
@pytest.mark.parametrize("objective", ["multi:softprob", "multi:softmax"])
def test_predict_shapes_match_jax(data, softprob, objective, kw):
    _, _, Xv, _ = data
    jb, tb, _, _ = softprob
    if objective == "multi:softmax":  # the same trees, another transform
        raw = json.loads(tb.save_raw())
        raw["learner"]["objective"]["name"] = objective
        raw = json.dumps(raw).encode()
        jb = xgb.Booster(model_file=bytearray(raw))
        tb = xgbt.Booster(model_file=raw, **CPU)
    want = jb.predict(xgb.DMatrix(Xv), **kw)
    got = tb.predict(xgbt.DMatrix(Xv, **CPU), **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if kw.get("pred_leaf"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strict_shape", [False, True])
@pytest.mark.parametrize("predict_type", ["value", "margin"])
@pytest.mark.parametrize("objective", ["multi:softprob", "multi:softmax"])
def test_inplace_predict_matches_jax(data, softprob, objective, predict_type,
                                     strict_shape):
    _, _, Xv, _ = data
    _, tb, _, _ = softprob
    raw = json.loads(tb.save_raw())
    raw["learner"]["objective"]["name"] = objective
    raw = json.dumps(raw).encode()
    jb = xgb.Booster(model_file=bytearray(raw))
    tb = xgbt.Booster(model_file=raw, **CPU)
    kw = dict(predict_type=predict_type, strict_shape=strict_shape)
    want = jb.inplace_predict(Xv, **kw)
    got = tb.inplace_predict(Xv, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, tb.predict(
        xgbt.DMatrix(Xv, **CPU), output_margin=predict_type == "margin",
        strict_shape=strict_shape).reshape(got.shape), rtol=0, atol=0)


def test_softmax_trains_the_softprob_trees_and_predicts_classes(data,
                                                                softprob):
    X, y, Xv, _ = data
    _, tprob, _, _ = softprob
    jb, tb, jres, tres = _train_both({**PARAMS, "objective": "multi:softmax"},
                                     data=data)
    assert_same_trees(jb, tb, X)
    assert _model(tb)["trees"] == _model(tprob)["trees"]
    got = tb.predict(xgbt.DMatrix(Xv, **CPU))
    assert got.shape == (Xv.shape[0],) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jb.predict(xgb.DMatrix(Xv)))
    np.testing.assert_array_equal(
        got, np.argmax(tprob.predict(xgbt.DMatrix(Xv, **CPU)), 1))
    # the metrics saw the probabilities (eval_transform), not the classes
    np.testing.assert_allclose(_micro(tres["val"]["mlogloss"]),
                               _micro(jres["val"]["mlogloss"]), rtol=0,
                               atol=1)


def test_weighted_multiclass_matches_jax(data):
    X, y, Xv, yv = data
    w = np.random.RandomState(3).uniform(0.3, 2.0, X.shape[0]).astype(
        np.float32)
    params = {**PARAMS, "eval_metric": ["mlogloss"]}
    jb = _pinned(lambda: xgb.train(
        params, xgb.DMatrix(X, label=y, weight=w), 3, verbose_eval=False))
    tb = xgbt.train(params, xgbt.DMatrix(X, y, weight=w, **CPU), 3,
                    verbose_eval=False)
    assert_same_trees(jb, tb, X)
    np.testing.assert_allclose(
        tb.predict(xgbt.DMatrix(Xv, **CPU), output_margin=True),
        jb.predict(xgb.DMatrix(Xv), output_margin=True), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("metric", ["mlogloss", "auc"])
def test_early_stopping_reads_the_metric_direction(data, metric):
    """``auc`` on K classes maximizes and ``mlogloss`` minimizes, read from
    the Booster's metric objects: the same stop and best round as the JAX
    package's (held-out labels permuted, so the metric soon stalls)."""
    X, y, Xv, yv = data
    yp = np.random.RandomState(1).permutation(yv)
    params = {**PARAMS, "eval_metric": [metric]}
    jb = _pinned(lambda: xgb.train(
        params, xgb.DMatrix(X, label=y), 30,
        evals=[(xgb.DMatrix(Xv, label=yp), "val")],
        early_stopping_rounds=3, verbose_eval=False))
    tb = xgbt.train(params, xgbt.DMatrix(X, y, **CPU), 30,
                    evals=[(xgbt.DMatrix(Xv, yp, **CPU), "val")],
                    early_stopping_rounds=3, verbose_eval=False)
    assert tb.best_iteration == jb.best_iteration
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() < 30
    assert tb.metric_maximize(metric) == (metric == "auc")


def test_stratified_cv_on_class_labels_matches_jax(data):
    X, y, _, _ = data
    X = np.nan_to_num(X)  # held-out missing values: see test_torch_training
    params = {**PARAMS, "eval_metric": ["merror", "mlogloss"]}
    jh = _pinned(lambda: xgb.cv(params, xgb.DMatrix(X, label=y), 3, nfold=3,
                                stratified=True, seed=2, as_pandas=False))
    th = xgbt.cv(params, xgbt.DMatrix(X, y, **CPU), 3, nfold=3,
                 stratified=True, seed=2, as_pandas=False)
    assert list(th) == list(jh)
    for k in jh:
        np.testing.assert_allclose(th[k], jh[k], rtol=0, atol=1.5e-6)
