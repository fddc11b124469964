"""Port parity: ``tree_method="exact"`` against the JAX package.

The exact candidate set. ``compute_exact_cuts`` of both packages on the
same rows: the cut values and the minimums equal exactly (host float32 in
both), for numerical columns with missing values, an all-missing column, a
categorical column of sparse codes, and the ``cap`` error with the same
message. ``DMatrix.get_binned_exact``: the same cuts and bins, int16 bins
once the width passes 254, and one cached matrix per DMatrix.

Training. 3 rounds of ``tree_method="exact"`` and of
``updater="grow_colmaker,prune"`` (the legacy sequence, which is the same
method) on 1024 x 5 rows of a few hundred distinct values each (5%
missing), ``binary:logistic``, the held-out rows evaluated: the same trees
with ``tests/test_torch_lossguide.py``'s tolerances (structure and split
conditions exact, ``default_left`` where a training row with a missing
value reaches the node, leaf values within rtol 1e-5 and atol 5e-5),
margins within the same, the eval history within 1e-6, and the model JSON
loads in the other package in both directions within the same. The
estimators pass ``tree_method`` (exact, approx) and ``updater`` (the local
histmaker) to the booster and predict as the JAX package's within the
same tolerances.
"""

import json

import jax
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from test_torch_lossguide import TOL, _assert_same_trees, _margins, _trees
from xgboost_tpu.data import quantile as jq
from xgboost_tpu_torch.data import quantile as tq

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _pin_jax_route():
    """The JAX package's float level histograms (the parity tests' route)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        yield
    jax.clear_caches()


def _grid_data(seed, n, F=5, levels=300):
    """Rows of at most ``levels`` distinct values per column (a 0.1 grid),
    5% missing, and a label from a linear score."""
    rng = np.random.RandomState(seed)
    X = (rng.randint(0, levels, (n, F)) / 10.0 - levels / 20.0
         ).astype(np.float32)
    y = ((X @ rng.randn(F) + rng.randn(n)) > 0).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    return X, y


def _cut_cases():
    rng = np.random.RandomState(3)
    X, _ = _grid_data(1, 400)
    blank = X.copy()
    blank[:, 2] = np.nan
    cat = X.copy()
    cat[:, 1] = rng.choice([0, 3, 7, 40], 400)  # sparse codes
    cat[rng.rand(400) < 0.1, 1] = np.nan
    return {"numerical": (X, None), "all_missing_column": (blank, None),
            "categorical": (cat, [1])}


@pytest.mark.parametrize("case", sorted(_cut_cases()))
def test_compute_exact_cuts_matches_jax(case):
    X, cat = _cut_cases()[case]
    jc = jq.compute_exact_cuts(X, categorical=cat)
    tc = tq.compute_exact_cuts(torch.from_numpy(X), categorical=cat)
    np.testing.assert_array_equal(tc.values, np.asarray(jc.values))
    np.testing.assert_array_equal(tc.min_vals, np.asarray(jc.min_vals))
    assert tc.values.dtype == np.float32 and tc.max_bin == jc.max_bin


def test_compute_exact_cuts_cap_error_matches_jax():
    X = np.random.RandomState(0).randn(300, 2).astype(np.float32)
    with pytest.raises(ValueError) as je:
        jq.compute_exact_cuts(X, cap=100)
    with pytest.raises(ValueError) as te:
        tq.compute_exact_cuts(X, cap=100)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("levels", [100, 3000])
def test_get_binned_exact_matches_jax(levels):
    X, y = _grid_data(2, 2000, levels=levels)
    jb = xgb.DMatrix(X, label=y).get_binned_exact()
    td = xgbt.DMatrix(X, y, device="cpu")
    tb = td.get_binned_exact()
    assert td.get_binned_exact() is tb
    np.testing.assert_array_equal(tb.cuts.values, np.asarray(jb.cuts.values))
    np.testing.assert_array_equal(tb.bins.numpy().astype(np.int32),
                                  np.asarray(jb.bins).astype(np.int32))
    assert tb.bins.dtype == (torch.uint8 if tb.cuts.max_bin + 1 <= 255
                             else torch.int16)
    assert levels != 3000 or tb.bins.dtype == torch.int16


METHODS = {"exact": {"tree_method": "exact"},
           "grow_colmaker_prune": {"updater": "grow_colmaker,prune"}}
BASE = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3,
        "eval_metric": ["auc", "logloss"]}


@pytest.fixture(scope="module")
def trained():
    X, y = _grid_data(0, 1280)
    sets = (X[:1024], y[:1024]), (np.nan_to_num(X[1024:]), y[1024:])
    (Xt, yt), (Xv, yv) = sets
    out = {}
    for name, extra in METHODS.items():
        p = {**BASE, **extra}
        jres, tres = {}, {}
        jb = xgb.train(p, xgb.DMatrix(Xt, label=yt), 3,
                       evals=[(xgb.DMatrix(Xv, label=yv), "val")],
                       evals_result=jres, verbose_eval=False)
        tb = xgbt.train(p, xgbt.DMatrix(Xt, yt, device="cpu"), 3,
                        evals=[(xgbt.DMatrix(Xv, yv, device="cpu"), "val")],
                        evals_result=tres, verbose_eval=False)
        out[name] = (jb, tb, jres, tres)
    return sets, out


@pytest.mark.parametrize("method", sorted(METHODS))
def test_train_matches_jax(trained, method):
    ((X, _), (Xv, _)), out = trained
    jb, tb, jres, tres = out[method]
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
    assert tb.num_boosted_rounds() == 3


@pytest.mark.parametrize("method", sorted(METHODS))
def test_json_loads_in_both_directions(trained, method):
    ((_, _), (Xv, _)), out = trained
    jb, tb, _, _ = out[method]
    in_port = xgbt.Booster(model_file=jb.save_raw(), device="cpu")
    np.testing.assert_allclose(_margins(in_port, Xv), _margins(jb, Xv),
                               rtol=1e-5, atol=TOL)
    in_jax = xgb.Booster(model_file=bytearray(tb.save_raw()))
    np.testing.assert_allclose(_margins(in_jax, Xv), _margins(tb, Xv),
                               rtol=1e-5, atol=TOL)


@pytest.mark.parametrize("kw", [{"tree_method": "exact"},
                                {"tree_method": "approx"},
                                {"updater": "grow_local_histmaker"}])
def test_estimators_pass_the_method_to_the_booster(kw):
    """``XGBClassifier(tree_method=...)`` and ``updater=`` reach the
    booster, and the fitted model predicts as the JAX package's (within
    rtol 1e-5 and atol 5e-5: continuous gradients, summed in float32 by
    the JAX package and in fixed point by the port)."""
    X, y = _grid_data(4, 600)
    y = y.astype(int)
    tc = xgbt.XGBClassifier(n_estimators=3, max_depth=3, device="cpu",
                            **kw).fit(X, y)
    jc = xgb.XGBClassifier(n_estimators=3, max_depth=3, **kw).fit(X, y)
    gbm = tc.get_booster()._gbm
    assert gbm.gbtree_param.tree_method == kw.get("tree_method", "auto")
    assert gbm._updater_seq == ([kw["updater"]] if "updater" in kw else [])
    np.testing.assert_allclose(tc.predict_proba(X), jc.predict_proba(X),
                               rtol=1e-5, atol=TOL)
