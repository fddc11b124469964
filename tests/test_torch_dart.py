"""Port parity: the DART booster, ``num_parallel_tree`` and the keys that
change nothing, against the JAX package.

Both packages train on the same numpy data (2048 x 6 training rows with 5%
missing values, 512 held-out rows without: where no training row with a
missing value reaches a node, its default direction is a tie either
package breaks either way), ``binary:logistic``, ``max_bin`` 16, 3 rounds
(5 for ``skip_drop``), the JAX package pinned to its per-level float route
(``XGBTPU_DISPATCH=tree_grow=level,sibling_sub=off,hist_acc=float``), the
port on the CPU. Tolerances:

- trees: structure and split conditions exact, ``default_left`` where a
  training row with a missing value reaches the node, leaf values within
  rtol 1e-5 and atol 1e-6;
- DART's ``weight_drop``: equal (the same float64 values: both packages
  draw the drops from ``np.random.RandomState`` in the same order);
- margins of the training and the held-out rows, ``iteration_range``
  walks (with DART's weights), ``ntree_limit``, slices and models loaded
  across the packages (JSON both ways): within 1e-5;
- the eval history within 1e-6 (6-decimal values);
- pickling, copies and continuation: against the JAX package's own
  continuation (the same trees and ``weight_drop``) and the port itself
  (bitwise).

DART cases (each booster seeds its RandomState with 0, as in the JAX
package, so the drop rates are set high enough for drops in 3 rounds):
uniform drops with ``normalize_type`` tree and ``skip_drop``, weighted
drops with ``forest``, ``one_drop`` at ``rate_drop`` 0, and DART
over lossguide trees. ``num_parallel_tree`` 3 with ``subsample`` 0.7 on
the depthwise and the lossguide growers (each parallel tree its own
key). The keys that change nothing (``sketch_eps``, ``sparse_threshold``,
``single_precision_histogram=False``, ``predictor``) grow the same trees
and warn as the JAX package does.
"""

import copy
import json
import pickle
import warnings

import jax
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt

torch.set_num_threads(1)

F = 6
BASE = {"objective": "binary:logistic", "max_bin": 16, "eta": 0.3,
        "max_depth": 3, "eval_metric": ["auc", "logloss"]}
CASES = {
    "dart_uniform_tree_skip": (5, dict(booster="dart", rate_drop=0.5,
                                       skip_drop=0.3)),
    "dart_weighted_forest": (3, dict(booster="dart", rate_drop=0.8,
                                     sample_type="weighted",
                                     normalize_type="forest")),
    "dart_one_drop": (3, dict(booster="dart", one_drop=True)),
    "dart_lossguide": (3, dict(booster="dart", rate_drop=0.8,
                               grow_policy="lossguide", max_leaves=8,
                               max_depth=0)),
    "parallel3": (3, dict(num_parallel_tree=3, subsample=0.7)),
    "parallel3_lossguide": (3, dict(num_parallel_tree=3, subsample=0.7,
                                    grow_policy="lossguide", max_leaves=6)),
}


def _data(seed, n):
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
def sets():
    X, y = _data(0, 2560)
    return (X[:2048], y[:2048]), (np.nan_to_num(X[2048:]), y[2048:])


def _train_both(p, rounds, sets):
    (X, y), (Xv, yv) = sets
    jres, tres = {}, {}
    jb = xgb.train(p, xgb.DMatrix(X, label=y), rounds,
                   evals=[(xgb.DMatrix(Xv, label=yv), "val")],
                   evals_result=jres, verbose_eval=False)
    tb = xgbt.train(p, xgbt.DMatrix(X, y, device="cpu"), rounds,
                    evals=[(xgbt.DMatrix(Xv, yv, device="cpu"), "val")],
                    evals_result=tres, verbose_eval=False)
    return jb, tb, jres, tres


@pytest.fixture(scope="module")
def trained(sets):
    return {name: _train_both({**BASE, **extra}, rounds, sets)
            for name, (rounds, extra) in CASES.items()}


def _gb(model_json):
    return model_json["learner"]["gradient_booster"]


def _trees(model_json):
    m = _gb(model_json)["model"]
    return (m["gbtree"] if "gbtree" in m else m)["trees"]


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
            np.testing.assert_allclose(b[key], a[key], rtol=1e-5, atol=1e-6)


def _margins(bst, X, **kw):
    if isinstance(bst, xgb.Booster):
        return bst.predict(xgb.DMatrix(X), output_margin=True, **kw)
    return bst.predict(xgbt.DMatrix(X, device="cpu"), output_margin=True,
                       **kw)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _weight_drop(model_json):
    return _gb(model_json)["model"].get("weight_drop")


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_matches_jax(sets, trained, case):
    jb, tb, jres, tres = trained[case]
    (X, _), (Xv, _) = sets
    jj, tj = json.loads(jb.save_raw()), tb.save_json()
    _assert_same_trees(_trees(jj), _trees(tj), X)
    assert _weight_drop(tj) == _weight_drop(jj)
    for rows in (X, Xv):
        _close(_margins(tb, rows), _margins(jb, rows))
    for m in ("auc", "logloss"):
        np.testing.assert_allclose(np.rint(np.asarray(tres["val"][m]) * 1e6),
                                   np.rint(np.asarray(jres["val"][m]) * 1e6),
                                   rtol=0, atol=1.0)
    rounds, extra = CASES[case]
    npt = extra.get("num_parallel_tree", 1)
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == rounds
    assert len(_trees(tj)) == rounds * npt
    if extra.get("booster") == "dart":
        assert min(_weight_drop(tj)) < 1.0  # some round dropped trees
        assert len(_weight_drop(tj)) == rounds


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranges_match_jax(sets, trained, case):
    jb, tb, _, _ = trained[case]
    (_, _), (Xv, _) = sets
    for rng in [(0, 1), (1, 3), (2, 0)]:
        want = _margins(jb, Xv, iteration_range=rng)
        _close(_margins(tb, Xv, iteration_range=rng), want)
        _close(tb.inplace_predict(Xv, iteration_range=rng,
                                  predict_type="margin"), want)
    npt = CASES[case][1].get("num_parallel_tree", 1)
    _close(_margins(tb, Xv, ntree_limit=2 * npt),
           _margins(jb, Xv, ntree_limit=2 * npt))


@pytest.mark.parametrize("case", ["parallel3", "parallel3_lossguide"])
def test_parallel_slices_match_jax(sets, trained, case):
    jb, tb, _, _ = trained[case]
    (_, _), (Xv, _) = sets
    for sl in (slice(1, 3), slice(0, 3, 2), 2):
        js, ts = jb[sl], tb[sl]
        assert ts.num_boosted_rounds() == js.num_boosted_rounds()
        assert len(_trees(ts.save_json())) == 3 * js.num_boosted_rounds()
        _close(_margins(ts, Xv), _margins(js, Xv))


def test_a_sliced_dart_keeps_every_weight_and_cannot_predict(sets, trained):
    """Both packages slice the trees of a DART booster but keep its whole
    ``weight_drop`` (the reference slices the weights too): the slice's
    JSON carries every weight and its walk refuses the mismatch."""
    jb, tb, _, _ = trained["dart_weighted_forest"]
    (_, _), (Xv, _) = sets
    js, ts = jb[1:3], tb[1:3]
    assert _weight_drop(ts.save_json()) == _weight_drop(
        json.loads(js.save_raw())) == _weight_drop(tb.save_json())
    with pytest.raises(TypeError):
        _margins(js, Xv)
    with pytest.raises(ValueError, match="3 tree weights for 2 trees"):
        _margins(ts, Xv)


@pytest.mark.parametrize("case", sorted(CASES))
def test_json_loads_in_both_directions(sets, trained, case):
    jb, tb, _, _ = trained[case]
    (_, _), (Xv, _) = sets
    in_port = xgbt.Booster(model_file=jb.save_raw(), device="cpu")
    _close(_margins(in_port, Xv), _margins(jb, Xv))
    assert in_port._gbm.name == jb._gbm.name
    in_jax = xgb.Booster(model_file=bytearray(tb.save_raw()))
    _close(_margins(in_jax, Xv), _margins(tb, Xv))
    assert _gb(json.loads(in_jax.save_raw())) == _gb(tb.save_json())


@pytest.mark.parametrize("case", ["dart_uniform_tree_skip", "parallel3"])
def test_pickle_copy_and_continuation(sets, trained, case):
    """A pickle and a copy predict bitwise as the original and keep
    ``weight_drop``; 3 + 2 rounds continued from the pickle grow the JAX
    package's continuation (a continued DART draws from a fresh
    ``RandomState``, as the JAX package's does)."""
    jb, tb, _, _ = trained[case]
    (X, y), (Xv, _) = sets
    p = {**BASE, **CASES[case][1]}
    again = pickle.loads(pickle.dumps(tb))
    for other in (again, copy.copy(tb)):
        assert other.save_raw() == tb.save_raw()
        np.testing.assert_array_equal(_margins(other, Xv), _margins(tb, Xv))
    jfirst = xgb.train(p, xgb.DMatrix(X, label=y), 3, verbose_eval=False)
    tfirst = xgbt.train(p, xgbt.DMatrix(X, y, device="cpu"), 3,
                        verbose_eval=False)
    jc = xgb.train(p, xgb.DMatrix(X, label=y), 2,
                   xgb_model=pickle.loads(pickle.dumps(jfirst)),
                   verbose_eval=False)
    tc = xgbt.train(p, xgbt.DMatrix(X, y, device="cpu"), 2,
                    xgb_model=pickle.loads(pickle.dumps(tfirst)),
                    verbose_eval=False)
    jj, tj = json.loads(jc.save_raw()), tc.save_json()
    assert tc.num_boosted_rounds() == 5
    _assert_same_trees(_trees(jj), _trees(tj), X)
    assert _weight_drop(tj) == _weight_drop(jj)
    _close(_margins(tc, Xv), _margins(jc, Xv))


def test_dart_draws_once_per_update_and_never_at_eval(sets):
    """The drops come from the booster's RandomState: ``update`` draws,
    eval and predict do not (a second eval leaves the stream where it
    was)."""
    (X, y), (Xv, yv) = sets
    d = xgbt.DMatrix(X, y, device="cpu")
    dv = xgbt.DMatrix(Xv, yv, device="cpu")
    bst = xgbt.Booster({**BASE, "booster": "dart", "rate_drop": 0.5},
                       cache=[d], device="cpu")
    bst.update(d, 0)
    state = bst._gbm._rng.get_state()[1].copy()
    bst.eval(dv)
    bst.predict(dv)
    np.testing.assert_array_equal(bst._gbm._rng.get_state()[1], state)
    bst.update(d, 1)
    assert not np.array_equal(bst._gbm._rng.get_state()[1], state)


# ---------------------------------------------------------------------------
# the keys that change nothing
# ---------------------------------------------------------------------------

INERT = {
    "sketch_eps": (0.1, "sketch_eps is superseded by max_bin"),
    "sparse_threshold": (0.5, "sparse_threshold has no effect"),
    "single_precision_histogram": (False, "single_precision_histogram=False"),
    "predictor": ("gpu_predictor", "predictor=gpu_predictor requested"),
}


@pytest.mark.parametrize("key", sorted(INERT))
def test_inert_keys_warn_and_change_nothing(sets, key, capsys):
    (X, y), _ = sets
    value, text = INERT[key]
    plain = xgbt.train(BASE, xgbt.DMatrix(X, y, device="cpu"), 2,
                       verbose_eval=False)
    with pytest.warns(UserWarning, match=text.replace("=", ".")):
        got = xgbt.train({**BASE, key: value},
                         xgbt.DMatrix(X, y, device="cpu"), 2,
                         verbose_eval=False)
    assert _trees(got.save_json()) == _trees(plain.save_json())
    # the JAX package says the same on its console
    capsys.readouterr()
    xgb.train({**BASE, key: value}, xgb.DMatrix(X, label=y), 1,
              verbose_eval=False)
    assert text in capsys.readouterr().err


def test_inert_keys_at_their_defaults_do_not_warn(sets):
    (X, y), _ = sets
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        xgbt.train({**BASE, "predictor": "auto", "single_precision_histogram":
                    True}, xgbt.DMatrix(X, y, device="cpu"), 1,
                   verbose_eval=False)


def test_unknown_predictor_raises_as_in_jax(sets):
    (X, y), _ = sets
    p = {**BASE, "predictor": "bogus"}
    with pytest.raises(ValueError) as je:
        xgb.train(p, xgb.DMatrix(X, label=y), 1, verbose_eval=False)
    with pytest.raises(ValueError) as te:
        xgbt.train(p, xgbt.DMatrix(X, y, device="cpu"), 1,
                   verbose_eval=False)
    assert str(te.value) == str(je.value) == "Unknown predictor: bogus"
