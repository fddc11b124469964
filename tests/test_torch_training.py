"""Port parity for the training surface: callbacks and early stopping,
continued training, custom objectives and metrics, the predict options,
slicing, copies and pickling, attributes and feature metadata, parameter
validation, ``update_many`` and ``cv``.

Both packages run on the same numpy data (2048 x 6 training rows and 512
held-out rows, 5% NaN; ``binary:logistic``, depth 3, ``max_bin`` 16), the
JAX package pinned to its per-level float route
(``XGBTPU_DISPATCH=tree_grow=level,sibling_sub=off,hist_acc=float``), the
port on the CPU. Tolerances, per check:

- trees: the same structure, split features and conditions (exact); leaf
  values and base weights within rtol 1e-5 (atol 1e-7), loss changes
  within rtol 1e-5; ``default_left``
  equal wherever a row with a missing split value reaches the node (where
  none does, both directions score the same and f32 rounding breaks the
  tie either way, as ``tests/test_torch_slice.py`` explains);
- margins and predictions within 1e-5;
- the eval history: every value is rounded to 6 decimals (the JAX
  package parses it from the ``%.6f`` eval string) and within 1e-6 (one
  unit of the 6th decimal) of the JAX package's; early stopping's round
  and ``best_iteration`` equal, ``best_score`` within 1e-6;
- pickles, copies and ``update_many`` against the port itself: bitwise;
- ``cv``: the same folds (bitwise equal rows), means and stds within 1e-6
  (with stratified folds on the NaN-free rows: see the test).
"""

import copy
import json
import pickle

import jax
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu.callback import EarlyStopping as JEarlyStopping
from xgboost_tpu.callback import LearningRateScheduler as JScheduler
from xgboost_tpu.training import _make_folds as j_make_folds
from xgboost_tpu_torch.callback import EarlyStopping as TEarlyStopping
from xgboost_tpu_torch.callback import LearningRateScheduler as TScheduler
from xgboost_tpu_torch.training import _make_folds as t_make_folds

torch.set_num_threads(1)

PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16,
          "eta": 0.3, "eval_metric": ["auc", "logloss"]}
CPU = dict(device="cpu")
NAMES = ["age", "height", "weight", "income", "score", "rate"]


def _data(seed, n, F=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rng.randn(F) + 0.5 * rng.randn(n)) > 0
         ).astype(np.float32)
    return X, y


@pytest.fixture(scope="module", autouse=True)
def _pin_jax_route():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def data():
    X, y = _data(0, 2048)
    Xv, yv = _data(1, 512)
    # the held-out rows with their labels permuted: a set whose metric
    # stops improving early
    yn = np.random.RandomState(2).permutation(yv)
    return X, y, Xv, yv, yn


class Both:
    """The same matrices in both packages."""

    def __init__(self, data, **kw):
        X, y, Xv, yv, yn = data
        self.X, self.Xv = X, Xv
        self.jd = xgb.DMatrix(X, label=y, **kw)
        self.td = xgbt.DMatrix(X, y, **kw, **CPU)
        self.jv = xgb.DMatrix(Xv, label=yv)
        self.tv = xgbt.DMatrix(Xv, yv, **CPU)
        self.jn = xgb.DMatrix(Xv, label=yn)
        self.tn = xgbt.DMatrix(Xv, yn, **CPU)

    def evals(self, noise=False):
        j, t = [(self.jv, "val")], [(self.tv, "val")]
        if noise:
            j.append((self.jn, "noise"))
            t.append((self.tn, "noise"))
        return j, t

    def fresh(self):
        """The held-out rows in matrices no Booster has cached."""
        return xgb.DMatrix(self.Xv), xgbt.DMatrix(self.Xv, **CPU)


@pytest.fixture(scope="module")
def both(data):
    return Both(data)


def _train(both, rounds, noise=False, params=PARAMS, **kw):
    """train() in both packages with the same arguments; ``kw`` values that
    differ per package are given as ``(jax value, port value)`` under keys
    ending in ``_pair``."""
    jkw, tkw = {}, {}
    for k, v in kw.items():
        if k.endswith("_pair"):
            jkw[k[:-5]], tkw[k[:-5]] = v
        else:
            jkw[k] = tkw[k] = v
    je, te = both.evals(noise)
    jres, tres = {}, {}
    jb = xgb.train(params, both.jd, rounds, evals=je, evals_result=jres,
                   verbose_eval=False, **jkw)
    tb = xgbt.train(params, both.td, rounds, evals=te, evals_result=tres,
                    verbose_eval=False, **tkw)
    return jb, tb, jres, tres


def _trees(bst):
    return json.loads(bst.save_raw())["learner"]["gradient_booster"][
        "model"]["trees"]


def _missing_nodes(tree, X):
    """Nodes reached by at least one row whose split value is missing."""
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
            left = dl[i] if np.isnan(v) else v < cond[i]
            i = lc[i] if left else rc[i]
    return seen


def _assert_same_trees(jtrees, ttrees, Xs):
    assert len(jtrees) == len(ttrees)
    for a, b in zip(jtrees, ttrees):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        internal = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[internal],
            np.asarray(b["split_conditions"], np.float32)[internal])
        for key in ("split_conditions", "base_weights"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(b["loss_changes"])[internal],
                                   np.asarray(a["loss_changes"])[internal],
                                   rtol=1e-5)
        seen = set().union(*(_missing_nodes(t, X) for t in (a, b)
                             for X in Xs))
        for i in np.flatnonzero(internal):
            if i in seen:
                assert a["default_left"][i] == b["default_left"][i], i


def _assert_same_model(jb, tb, both, tol=1e-5):
    _assert_same_trees(_trees(jb), _trees(tb), (both.X, both.Xv))
    jx, tx = both.fresh()
    np.testing.assert_allclose(tb.predict(tx, output_margin=True),
                               jb.predict(jx, output_margin=True),
                               rtol=tol, atol=tol)


def _micro(values):
    return np.rint(np.asarray(values, np.float64) * 1e6)


def _assert_same_history(jres, tres):
    assert jres.keys() == tres.keys()
    for name in jres:
        assert jres[name].keys() == tres[name].keys()
        for m, jv in jres[name].items():
            tv = tres[name][m]
            assert len(tv) == len(jv), (name, m)
            for v in tv:
                assert v == float(f"{v:.6f}"), (name, m, v)
            # within 1e-6, one unit of the 6th decimal (two values a hair
            # apart may round to neighbours), compared in those units,
            # where 6-decimal numbers are exact
            np.testing.assert_allclose(_micro(tv), _micro(jv), rtol=0, atol=1)


# ---------------------------------------------------------------------------
# the two faults this surface repairs
# ---------------------------------------------------------------------------

def test_history_is_rounded_to_6_decimals_and_printed_with_5(both, capsys):
    jb, tb, jres, tres = _train(both, 5, noise=True)
    _assert_same_history(jres, tres)
    capsys.readouterr()
    je, te = both.evals(noise=True)
    res = {}
    xgbt.train(PARAMS, both.td, 3, evals=te, evals_result=res,
               verbose_eval=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[")]
    want = ["\t".join([f"[{i}]"] + [f"{d}-{m}:{res[d][m][i]:.5f}"
                                     for d in res for m in res[d]])
            for i in range(3)]
    assert lines == want


def test_verbose_eval_period_matches(both, capsys):
    je, te = both.evals()
    printed = []
    for mod, d, ev in ((xgb, both.jd, je), (xgbt, both.td, te)):
        capsys.readouterr()
        mod.train(PARAMS, d, 5, evals=ev, verbose_eval=2)
        printed.append([ln.split("\t")[0] for ln in
                        capsys.readouterr().out.splitlines()
                        if ln.startswith("[")])
    assert printed[1] == printed[0] == ["[0]", "[2]", "[4]"]


@pytest.mark.parametrize("as_pickle", [False, True])
def test_training_checkpoint_matches(both, tmp_path, as_pickle):
    from xgboost_tpu.callback import TrainingCheckPoint as JCheckPoint
    from xgboost_tpu_torch.callback import TrainingCheckPoint as TCheckPoint
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    _train(both, 5, callbacks_pair=(
        [JCheckPoint(str(tmp_path / "jax"), as_pickle=as_pickle,
                     interval=2)],
        [TCheckPoint(str(tmp_path / "port"), as_pickle=as_pickle,
                     interval=2)]))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    ext = "pkl" if as_pickle else "json"
    assert names == [f"model_1.{ext}", f"model_3.{ext}"]
    def load(mod, sub, name):
        path = tmp_path / sub / name
        if not as_pickle:
            return mod.Booster(model_file=str(path), **(
                CPU if mod is xgbt else {}))
        with open(path, "rb") as f:
            return pickle.load(f)

    for name in names:
        port, jax_ckpt = load(xgbt, "port", name), load(xgb, "jax", name)
        assert port.num_boosted_rounds() == jax_ckpt.num_boosted_rounds()
        _assert_same_model(jax_ckpt, port, both)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_model_json_keeps_feature_meta_and_attributes(data, direction):
    X, y = data[0], data[1]
    types = ["q", "q", "int", "q", "float", "q"]
    if direction == "jax_to_port":
        src = xgb.train(PARAMS, xgb.DMatrix(X, label=y, feature_names=NAMES,
                                            feature_types=types), 2,
                        verbose_eval=False)
        src.set_attr(best_iteration="1", best_score="0.5", note="kept")
        dst = xgbt.Booster(model_file=src.save_raw(), **CPU)
        again = json.loads(dst.save_raw())["learner"]
    else:
        src = xgbt.train(PARAMS, xgbt.DMatrix(X, y, feature_names=NAMES,
                                              feature_types=types, **CPU), 2,
                         verbose_eval=False)
        src.set_attr(best_iteration="1", best_score="0.5", note="kept")
        dst = xgb.Booster(model_file=bytearray(src.save_raw()))
        again = json.loads(dst.save_raw())["learner"]
    assert again["feature_names"] == NAMES
    assert again["feature_types"] == types
    assert again["attributes"] == {"best_iteration": "1",
                                   "best_score": "0.5", "note": "kept"}
    assert dst.feature_names == NAMES and dst.feature_types == types
    assert dst.attributes() == src.attributes()
    assert dst.attr("note") == "kept"
    if direction == "jax_to_port":  # the port reads it from the attributes
        assert dst.best_iteration == 1 and dst.best_score == 0.5


# ---------------------------------------------------------------------------
# callbacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["rounds_on_last_set", "auc_on_val"])
def test_early_stopping_matches(both, case):
    if case == "rounds_on_last_set":
        kw = dict(early_stopping_rounds=3)
    else:
        kw = dict(callbacks_pair=(
            [JEarlyStopping(2, metric_name="auc", data_name="val",
                            min_delta=2e-3)],
            [TEarlyStopping(2, metric_name="auc", data_name="val",
                            min_delta=2e-3)]))
    jb, tb, jres, tres = _train(both, 40, noise=True, **kw)
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() < 40
    assert tb.best_iteration == int(jb.attr("best_iteration"))
    # a history value: within one unit of its 6th decimal
    assert abs(_micro(tb.best_score) - _micro(jb.best_score)) <= 1
    assert abs(_micro(tb.best_score) - _micro(jb.attr("best_score"))) <= 1
    _assert_same_history(jres, tres)
    _assert_same_model(jb, tb, both)


def test_early_stopping_save_best(both):
    jb, tb, jres, tres = _train(both, 40, noise=True, callbacks_pair=(
        [JEarlyStopping(3, save_best=True)],
        [TEarlyStopping(3, save_best=True)]))
    best = int(jb.attr("best_iteration"))
    assert jb.num_boosted_rounds() == tb.num_boosted_rounds() == best + 1
    assert tb.best_iteration == best
    _assert_same_history(jres, tres)
    _assert_same_model(jb, tb, both)


def test_learning_rate_scheduler_same_trees(both):
    rates = [0.3, 0.2, 0.1, 0.05, 0.3, 0.01]
    jb, tb, _, _ = _train(both, len(rates), callbacks_pair=(
        [JScheduler(rates)], [TScheduler(lambda i: rates[i])]))
    _assert_same_model(jb, tb, both)
    # each tree carries the eta of the round it grew in: a leaf value is
    # eta x the leaf's weight (base_weights hold eta x weight too)
    for t, eta in zip(_trees(tb), rates):
        leaf = np.asarray(t["left_children"]) < 0
        np.testing.assert_array_equal(
            np.asarray(t["split_conditions"], np.float32)[leaf],
            np.asarray(t["base_weights"], np.float32)[leaf])
    w0 = [np.asarray(t["base_weights"])[0] for t in _trees(tb)]
    assert all(abs(w) > 0 for w in w0)


def test_set_param_eta_reaches_the_next_tree(both):
    jb = xgb.Booster(PARAMS, cache=[both.jd])
    tb = xgbt.Booster(PARAMS, cache=[both.td], **CPU)
    for i, eta in enumerate((0.3, 0.05, 0.05)):
        jb.set_param("eta", eta)
        tb.set_param({"learning_rate": eta})
        jb.update(both.jd, i)
        tb.update(both.td, i)
    _assert_same_model(jb, tb, both)


# ---------------------------------------------------------------------------
# continued training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["booster", "path", "bytes"])
def test_continuation_matches_jax_continuation(both, source, tmp_path):
    jb0, tb0, _, _ = _train(both, 4)

    def model(bst, tag):
        if source == "booster":
            return bst
        if source == "bytes":
            return bytes(bst.save_raw())
        path = tmp_path / f"{tag}.json"
        bst.save_model(path)
        return str(path)

    jb, tb, jres, tres = _train(both, 4, xgb_model_pair=(
        model(jb0, "jax"), model(tb0, "port")))
    assert jb.num_boosted_rounds() == tb.num_boosted_rounds() == 8
    assert tb0.num_boosted_rounds() == 4  # the source model is untouched
    _assert_same_history(jres, tres)
    _assert_same_model(jb, tb, both)
    assert _trees(tb)[:4] == _trees(tb0)


# ---------------------------------------------------------------------------
# custom objectives and metrics
# ---------------------------------------------------------------------------

def _logistic_obj(margin, dtrain):
    y = dtrain.get_label()
    p = 1.0 / (1.0 + np.exp(-margin.astype(np.float64)))
    return p - y, p * (1.0 - p)


def _error_metric(margin, dmat):
    y = dmat.get_label()
    return "myerror", float(np.mean((margin > 0.0) != (y > 0.5)))


@pytest.mark.parametrize("how", ["feval", "custom_metric"])
def test_custom_objective_and_metric(both, how):
    params = {**PARAMS, "disable_default_eval_metric": True,
              "eval_metric": []}
    jb, tb, jres, tres = _train(both, 4, noise=True, params=params,
                                obj=_logistic_obj, **{how: _error_metric})
    assert list(tres["val"]) == ["myerror"]
    _assert_same_history(jres, tres)
    _assert_same_model(jb, tb, both)


def test_eval_set_string_matches(both):
    jb, tb, _, _ = _train(both, 3)
    je, te = both.evals(noise=True)
    js = jb.eval_set(je, 7, feval=_error_metric)
    ts = tb.eval_set(te, 7, feval=_error_metric)
    jtok, ttok = js.split("\t"), ts.split("\t")
    assert [t.rpartition(":")[0] for t in ttok] == \
        [t.rpartition(":")[0] for t in jtok]
    assert ttok[0] == "[7]"
    np.testing.assert_allclose([float(t.rpartition(":")[2]) for t in ttok[1:]],
                               [float(t.rpartition(":")[2]) for t in jtok[1:]],
                               rtol=0, atol=1e-6)
    assert tb.eval(both.tv, "val", 2) == tb.eval_set([(both.tv, "val")], 2)
    # output_margin=False hands feval the transformed predictions
    # (the reference's rule; the JAX package always passes the margin)
    _, tx = both.fresh()
    top = tb.predict(tx).max()
    s = tb.eval_set([(both.tv, "val")], 0, output_margin=False,
                    feval=lambda p, d: ("top", float(p.max())))
    assert s.endswith(f"val-top:{top:.6f}")


# ---------------------------------------------------------------------------
# predict options
# ---------------------------------------------------------------------------

PREDICT_CASES = [
    {},
    {"output_margin": True},
    {"strict_shape": True},
    {"output_margin": True, "strict_shape": True},
    {"iteration_range": (1, 3)},
    {"iteration_range": (2, 0), "output_margin": True},
    {"iteration_range": (0, 0)},
    {"ntree_limit": 2},
    {"pred_leaf": True},
    {"training": True},
]


@pytest.fixture(scope="module")
def trained(both):
    return _train(both, 4)


@pytest.mark.parametrize("kw", PREDICT_CASES, ids=[
    "-".join(f"{k}={v}" for k, v in c.items()) or "plain"
    for c in PREDICT_CASES])
def test_predict_options_match(both, trained, kw):
    jb, tb, _, _ = trained
    for jd, td in (both.fresh(), (both.jv, both.tv)):
        want = jb.predict(jd, **kw)
        got = tb.predict(td, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype
        if kw.get("pred_leaf"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_predict_refuses_what_is_not_ported_and_foreign_names(both, trained):
    """Foreign feature names raise. SHAP (which this test once checked to
    raise, before it was ported) gives the JAX package's values for the
    separately trained models (trees within rtol 1e-5, so 1e-5 here)."""
    jb, tb, _, _ = trained
    jd, td = both.fresh()
    for kw in ({"pred_contribs": True}, {"pred_interactions": True},
               {"pred_contribs": True, "approx_contribs": True}):
        got, want = tb.predict(td, **kw), jb.predict(jd, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    named = xgbt.train(PARAMS, xgbt.DMatrix(both.X, both.td.get_label(),
                                            feature_names=NAMES, **CPU), 1,
                       verbose_eval=False)
    other = xgbt.DMatrix(both.Xv, feature_names=NAMES[::-1], **CPU)
    with pytest.raises(ValueError, match="feature_names mismatch"):
        named.predict(other)
    np.testing.assert_array_equal(
        named.predict(other, validate_features=False),
        named.predict(xgbt.DMatrix(both.Xv, feature_names=NAMES, **CPU)))


# ---------------------------------------------------------------------------
# model state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", [slice(1, 3), slice(None, 2), 2,
                                 slice(0, 4, 2), slice(1, None)],
                         ids=["1:3", ":2", "2", "0:4:2", "1:"])
def test_slicing_matches(both, trained, key):
    jb, tb, _, _ = trained
    js, ts = jb[key], tb[key]
    assert ts.num_boosted_rounds() == js.num_boosted_rounds()
    rounds = range(4)[key if isinstance(key, slice) else slice(key, key + 1)]

    def no_id(trees):  # tree ids are renumbered on save
        return [{k: v for k, v in t.items() if k != "id"} for t in trees]

    assert no_id(_trees(ts)) == no_id([_trees(tb)[r] for r in rounds])
    _assert_same_model(js, ts, both)
    if isinstance(key, slice) and (key.step or 1) == 1:
        lo, hi = key.start or 0, key.stop or 0
        jx, tx = both.fresh()
        np.testing.assert_array_equal(
            ts.predict(tx), tb.predict(tx, iteration_range=(lo, hi)))


@pytest.mark.parametrize("how", ["pickle", "copy", "deepcopy", "copy.copy"])
def test_pickle_and_copies_are_bitwise(both, trained, how):
    dup_of = {"pickle": lambda b: pickle.loads(pickle.dumps(b)),
              "copy": lambda b: b.copy(), "deepcopy": copy.deepcopy,
              "copy.copy": copy.copy}[how]
    tb = orig = trained[1]  # its trees as grown (device heap arrays)
    dup = dup_of(tb)
    assert dup is not tb and dup.device == tb.device
    _, tx = both.fresh()
    for kw in ({}, {"output_margin": True}, {"iteration_range": (1, 3)}):
        np.testing.assert_array_equal(dup.predict(tx, **kw),
                                      tb.predict(tx, **kw))
    assert dup.save_raw() == tb.save_raw()
    assert dup._extra_params == tb._extra_params
    assert dup.lparam.eval_metric == tb.lparam.eval_metric
    # a copy of a copy keeps the whole configuration and the attributes
    tb = tb.copy()
    tb.set_attr(note="kept")
    again = dup_of(tb)
    assert again.attributes() == tb.attributes() == {"note": "kept"}
    assert again.lparam.to_dict() == tb.lparam.to_dict()
    assert again.lparam._explicit == tb.lparam._explicit
    # the copy trains on as the original does
    a, b = dup.copy(), orig.copy()
    for bst in (a, b):
        bst.update(both.td, 4)
    assert a.save_raw() == b.save_raw()


def test_introspection_matches(both, trained):
    jb, tb, _, _ = trained
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == 4
    assert tb.num_features() == jb.num_features() == 6
    tb2, jb2 = tb.copy(), jb.copy()
    for b in (tb2, jb2):
        b.set_attr(a="1", b="2")
        b.set_attr(a=None)
        b.feature_names = NAMES
        b.feature_types = ["q"] * 6
    assert tb2.attributes() == jb2.attributes() == {"b": "2"}
    assert tb2.attr("a") is None and tb2.attr("b") == "2"
    assert tb2.feature_names == jb2.feature_names == NAMES
    assert tb2.feature_types == jb2.feature_types


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params,raises", [
    ({"validate_parameters": True, "not_a_parameter": 1}, True),
    ({"validate_parameters": True, "max_depht": 3}, True),
    ({"validate_parameters": True, "max_leaves": 0, "seed": 7,
      "lambda": 2.0, "nthread": 2}, False),
    ({"not_a_parameter": 1}, False),
])
def test_validate_parameters_matches(both, params, raises):
    p = {**PARAMS, **params}
    if raises:
        with pytest.raises(ValueError) as je:
            xgb.train(p, both.jd, 1, verbose_eval=False)
        with pytest.raises(ValueError) as te:
            xgbt.train(p, both.td, 1, verbose_eval=False)
        assert str(te.value) == str(je.value)
    else:
        jb = xgb.train(p, both.jd, 2, verbose_eval=False)
        tb = xgbt.train(p, both.td, 2, verbose_eval=False)
        _assert_same_model(jb, tb, both)


@pytest.mark.parametrize("params,ported", [
    ({"max_leaves": 8}, True),
    ({"num_parallel_tree": 2}, True),
    ({"updater": "refresh"}, False),
    ({"multi_strategy": "multi_output_tree"}, True),
    ({"booster": "gblinear"}, True),
    ({"feature_selector": "shuffle", "top_k": 2}, True)])
def test_unported_parameters_raise(both, params, ported):
    """A key the port has not ported raises, through ``train`` and
    ``set_param``. ``max_leaves`` (read by the lossguide grower only),
    ``num_parallel_tree``, the linear booster and its keys and
    ``multi_strategy`` (read by nothing in either package) are ported: they
    train the JAX package's model (the linear keys change no tree, and a
    linear model's rounds count 0 in both packages). The tree boosters'
    ``updater`` sequences are ported too: ``updater="refresh"`` with no
    model to refresh raises the JAX package's ValueError, message for
    message, and a trained Booster takes it through ``set_param``."""
    if params == {"updater": "refresh"}:
        with pytest.raises(ValueError) as je:
            xgb.train({**PARAMS, **params}, both.jd, 1, verbose_eval=False)
        with pytest.raises(ValueError) as te:
            xgbt.train({**PARAMS, **params}, both.td, 1, verbose_eval=False)
        assert str(te.value) == str(je.value)
        bst = xgbt.train(PARAMS, both.td, 1, verbose_eval=False)
        bst.set_param(params)
        assert bst._gbm.is_update_process
        return
    if ported:
        jb = xgb.train({**PARAMS, **params}, both.jd, 2, verbose_eval=False)
        tb = xgbt.train({**PARAMS, **params}, both.td, 2, verbose_eval=False)
        if params.get("booster") == "gblinear":
            np.testing.assert_allclose(tb._gbm.host_weights(),
                                       np.asarray(jb._gbm.weights),
                                       rtol=1e-5, atol=1e-6)
            jx, tx = both.fresh()
            np.testing.assert_allclose(tb.predict(tx, output_margin=True),
                                       jb.predict(jx, output_margin=True),
                                       rtol=1e-5, atol=1e-5)
            assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == 0
            return
        _assert_same_model(jb, tb, both)
        assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == 2
        return
    with pytest.raises(NotImplementedError):
        xgbt.train({**PARAMS, **params}, both.td, 1, verbose_eval=False)
    bst = xgbt.train(PARAMS, both.td, 1, verbose_eval=False)
    with pytest.raises(NotImplementedError):
        bst.set_param(params)


@pytest.mark.parametrize("kw", [{"resume_from": "ckpt"},
                                {"checkpoint_interval": 5},
                                {"checkpoint_shared": True},
                                {"resume_mode": "append"}])
def test_train_refuses_checkpoint_options(both, kw, tmp_path):
    """The checkpoint options are ported: each trains as the JAX package's
    ``train`` does with it (a directory each for ``resume_from``), and an
    unknown ``resume_mode`` raises ValueError in both."""
    jkw, tkw = dict(kw), dict(kw)
    if "resume_from" in kw:
        jkw["resume_from"] = str(tmp_path / "jax")
        tkw["resume_from"] = str(tmp_path / "port")
    jb = xgb.train(PARAMS, both.jd, 2, verbose_eval=False, **jkw)
    tb = xgbt.train(PARAMS, both.td, 2, verbose_eval=False, **tkw)
    _assert_same_model(jb, tb, both)
    for train, d in ((xgb.train, both.jd), (xgbt.train, both.td)):
        with pytest.raises(ValueError, match="resume_mode"):
            train(PARAMS, d, 1, verbose_eval=False, resume_mode="bogus")


def test_update_many_equals_per_round_update(both):
    per_round = xgbt.Booster(PARAMS, cache=[both.td], **CPU)
    for i in range(5):
        per_round.update(both.td, i)
    many = xgbt.Booster(PARAMS, cache=[both.td], **CPU)
    many.update_many(both.td, 0, 3, chunk=2)
    many.update_many(both.td, 3, 2)
    fields = ("keep", "feature", "split_cond", "default_left", "leaf_value")
    for a, b in zip(per_round._gbm.model._entries, many._gbm.model._entries):
        for f in fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(per_round._caches[id(both.td)].margin,
                       many._caches[id(both.td)].margin)
    assert per_round.save_raw() == many.save_raw()


# ---------------------------------------------------------------------------
# DMatrix metadata and cv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["index", "mask", "negative"])
def test_dmatrix_slice_matches(data, kind):
    X, y = data[0], data[1]
    w = np.linspace(0.5, 1.5, X.shape[0]).astype(np.float32)
    jd = xgb.DMatrix(X, label=y, weight=w, base_margin=y - 0.5,
                     feature_names=NAMES)
    td = xgbt.DMatrix(X, y, weight=w, base_margin=y - 0.5,
                      feature_names=NAMES, **CPU)
    rng = np.random.RandomState(4)
    idx = {"index": rng.choice(X.shape[0], 300, replace=False),
           "mask": rng.rand(X.shape[0]) < 0.3,
           "negative": -rng.randint(1, X.shape[0], 50)}[kind]
    js, ts = jd.slice(idx), td.slice(idx)
    np.testing.assert_array_equal(ts.data.numpy(), js.data)
    for get in ("get_label", "get_weight", "get_base_margin"):
        np.testing.assert_array_equal(getattr(ts, get)(), getattr(js, get)())
    assert ts.feature_names == js.feature_names == NAMES
    assert ts.num_row() == js.num_row() and ts.device == td.device
    with pytest.raises(IndexError):
        td.slice([X.shape[0]])


def test_dmatrix_setters_match(data):
    X, y = data[0], data[1]
    jd, td = xgb.DMatrix(X), xgbt.DMatrix(X, **CPU)
    for d in (jd, td):
        d.set_label(y)
        d.set_weight(np.full(X.shape[0], 2.0))
        d.set_base_margin(np.zeros(X.shape[0]))
    for get in ("get_label", "get_weight", "get_base_margin"):
        np.testing.assert_array_equal(getattr(td, get)(), getattr(jd, get)())
    assert xgbt.DMatrix(X, **CPU).get_label().shape == (0,)


@pytest.mark.parametrize("stratified", [False, True])
def test_cv_folds_and_results_match(data, both, stratified):
    if stratified:
        # the NaN-free rows: with stratified folds (seed 5) a test row with
        # a missing value reaches, in round 6, a node whose default
        # direction no training row decided; that tie (see the module
        # docstring) then changes the fold's test AUC, in either package
        X = np.nan_to_num(data[0])
        both = Both((X,) + tuple(data[1:]))
    jf = j_make_folds(both.jd, 3, {}, 5, stratified, None)
    tf = t_make_folds(both.td, 3, 5, stratified, None)
    for (ja, jt), (ta, tt) in zip(jf, tf):
        np.testing.assert_array_equal(ta.data.numpy(), ja.data)
        np.testing.assert_array_equal(tt.data.numpy(), jt.data)
        np.testing.assert_array_equal(tt.get_label(), jt.get_label())
    kw = dict(nfold=3, stratified=stratified, seed=5, as_pandas=False,
              early_stopping_rounds=2)
    jr = xgb.cv(PARAMS, both.jd, 6, **kw)
    tr = xgbt.cv(PARAMS, both.td, 6, **kw)
    assert list(tr) == list(jr) == [
        f"{s}-{m}-{a}" for s in ("train", "test") for m in ("auc", "logloss")
        for a in ("mean", "std")]
    for k in jr:
        assert len(tr[k]) == len(jr[k])
        np.testing.assert_allclose(tr[k], jr[k], rtol=0, atol=1e-6)
    df = xgbt.cv(PARAMS, both.td, 2, nfold=3, seed=5)
    assert list(df.columns) == list(jr)
    # callbacks are accepted and none runs (the JAX package's cv): a
    # learning-rate schedule changes nothing
    kw = dict(nfold=3, seed=5, as_pandas=False)
    jc = xgb.cv(PARAMS, both.jd, 2, callbacks=[JScheduler([0.9, 0.9])], **kw)
    tc = xgbt.cv(PARAMS, both.td, 2, callbacks=[TScheduler([0.9, 0.9])],
                 **kw)
    assert tc == xgbt.cv(PARAMS, both.td, 2, **kw)
    assert jc == xgb.cv(PARAMS, both.jd, 2, **kw)


class _Recorder:
    """A callback that records every call it gets."""

    def __init__(self, base):
        self.calls = []
        self.base = base

    def __getattr__(self, name):
        def call(*args, **kw):
            self.calls.append(name)
            return getattr(self.base, name)(*args, **kw)
        return call


def test_cv_accepts_callbacks_and_runs_none(both):
    """``cv(callbacks=...)``: both packages take the list and call none of
    its methods; the histories equal the calls without it."""
    from xgboost_tpu.callback import TrainingCallback as JCallback
    from xgboost_tpu_torch.callback import TrainingCallback as TCallback

    kw = dict(nfold=3, seed=1, as_pandas=False)
    jrec, trec = _Recorder(JCallback()), _Recorder(TCallback())
    jr = xgb.cv(PARAMS, both.jd, 3, callbacks=[jrec], **kw)
    tr = xgbt.cv(PARAMS, both.td, 3, callbacks=[trec], **kw)
    assert jrec.calls == trec.calls == []
    assert tr == xgbt.cv(PARAMS, both.td, 3, **kw)
    assert list(tr) == list(jr)
    for k in jr:
        np.testing.assert_allclose(tr[k], jr[k], rtol=0, atol=1e-6)
