"""Port parity for the whole slice: train, evaluate, predict, model IO.

Both packages train ``binary:logistic`` with the depthwise hist grower for
3 rounds at depth 3, B = 16, on the same 2048 x 6 numpy matrix with 5% NaNs
(the JAX package pinned to its per-level float route:
``XGBTPU_DISPATCH=tree_grow=level,sibling_sub=off,hist_acc=float``). The
trees must have the same structure, split features and conditions; margins
and predictions agree within 1e-5 and AUC within 1e-6. A JAX model loads
into the port and predicts within 1e-5, and the port's JSON loads into JAX.
The same holds at the default ``max_bin`` of 256 (int16 bins in the port,
uint16 in the JAX package) on 4096 x 8, with AUC within 1e-5, and
``Booster.inplace_predict`` (value and margin, ``iteration_range``,
``base_margin``) agrees with the JAX package's within 1e-5.

A node that no training row with a missing split value reaches scores both
missing directions identically (both route the same rows), so its
default_left is a tie that rounding breaks either way in either package.
default_left must agree at the nodes that saw missing values; where it
differs elsewhere, the node's loss change must agree and no training or
validation row may take its missing branch in either model.
"""

import json

import jax
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch.predictor import predict_margin

torch.set_num_threads(1)

PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16,
          "eta": 0.3, "eval_metric": ["auc", "logloss"]}
PARAMS256 = {**PARAMS, "max_bin": 256}


def _data(seed, n, F=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rng.randn(F) + 0.5 * rng.randn(n)) > 0
         ).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def data():
    return _data(0, 2048), _data(1, 512)


def _train_both(params, X, y, Xv, yv):
    jres, tres = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        jb = xgb.train(params, xgb.DMatrix(X, label=y), 3,
                       evals=[(xgb.DMatrix(Xv, label=yv), "val")],
                       evals_result=jres, verbose_eval=False)
    tb = xgbt.train(params, xgbt.DMatrix(X, y, device="cpu"), 3,
                    evals=[(xgbt.DMatrix(Xv, yv, device="cpu"), "val")],
                    evals_result=tres, verbose_eval=False)
    return jb, tb, jres, tres


@pytest.fixture(scope="module")
def trained(data):
    (X, y), (Xv, yv) = data
    jb, tb, jres, tres = _train_both(PARAMS, X, y, Xv, yv)
    # the heap stack of the device-grown trees, before model IO compacts them
    heap = tb._gbm.model.stacked()
    return jb, tb, jres, tres, heap


@pytest.fixture(scope="module")
def data256():
    X, y = _data(2, 5120, F=8)  # one labelling rule for both sets
    return (X[:4096], y[:4096]), (X[4096:], y[4096:])


@pytest.fixture(scope="module")
def trained256(data256):
    (X, y), (Xv, yv) = data256
    return _train_both(PARAMS256, X, y, Xv, yv)


def _trees(model_json):
    return model_json["learner"]["gradient_booster"]["model"]["trees"]


def _nodes_with_missing(tree, X):
    """Nodes reached by at least one row whose split value is missing."""
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


def _assert_same_model(jb, tb, jres, tres, X, Xv, auc_atol):
    jt, tt = _trees(json.loads(jb.save_raw())), _trees(tb.save_json())
    assert len(jt) == len(tt) == 3
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[np.asarray(a["left_children"]) >= 0],
            np.asarray(b["split_conditions"], np.float32)[np.asarray(b["left_children"]) >= 0])
        trained_missing = _nodes_with_missing(a, X)
        any_missing = (trained_missing | _nodes_with_missing(b, X)
                       | _nodes_with_missing(a, Xv)
                       | _nodes_with_missing(b, Xv))
        for i in np.flatnonzero(np.asarray(a["left_children"]) >= 0):
            if i in trained_missing:
                assert a["default_left"][i] == b["default_left"][i], i
            elif a["default_left"][i] != b["default_left"][i]:
                # a tie: no training row tells the directions apart, the
                # node scored the same split, and no row of either set
                # takes the missing branch, so the tie changes no output
                assert i not in any_missing, i
                np.testing.assert_allclose(b["loss_changes"][i],
                                           a["loss_changes"][i], rtol=1e-5)
        np.testing.assert_allclose(b["split_conditions"], a["split_conditions"],
                                   rtol=1e-5, atol=1e-5)
    jm = jb.predict(xgb.DMatrix(Xv), output_margin=True)
    tm = tb.predict(xgbt.DMatrix(Xv, device="cpu"), output_margin=True)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.predict(xgbt.DMatrix(Xv, device="cpu")),
                               jb.predict(xgb.DMatrix(Xv)), rtol=1e-5,
                               atol=1e-5)
    # both histories hold 6-decimal numbers (parsed from the "%.6f" eval
    # string); compared in units of the 6th decimal, where they are exact
    np.testing.assert_allclose(_micro(tres["val"]["auc"]),
                               _micro(jres["val"]["auc"]),
                               rtol=0, atol=auc_atol * 1e6)
    np.testing.assert_allclose(tres["val"]["logloss"], jres["val"]["logloss"],
                               rtol=1e-5)
    assert tres["val"]["auc"][-1] > tres["val"]["auc"][0]


def test_same_trees_margins_and_metrics(data, trained):
    jb, tb, jres, tres, _ = trained
    (X, _), (Xv, _) = data
    _assert_same_model(jb, tb, jres, tres, X, Xv, auc_atol=1e-6)


def test_models_carry_across(data, trained):
    jb, tb, _, _, _ = trained
    (_, _), (Xv, _) = data
    # JAX model -> port
    port = xgbt.Booster(model_file=jb.save_raw(), device="cpu")
    np.testing.assert_allclose(port.predict(xgbt.DMatrix(Xv, device="cpu")),
                               jb.predict(xgb.DMatrix(Xv)), rtol=1e-5,
                               atol=1e-5)
    # port model -> JAX, bytes round-trip through the port unchanged
    raw = tb.save_raw()
    back = xgb.Booster(model_file=bytearray(raw))
    np.testing.assert_allclose(back.predict(xgb.DMatrix(Xv)),
                               tb.predict(xgbt.DMatrix(Xv, device="cpu")),
                               rtol=1e-5, atol=1e-5)
    again = xgbt.Booster(model_file=raw, device="cpu")
    assert json.loads(again.save_raw()) == json.loads(raw)


def test_device_grown_and_loaded_forests_agree(data, trained):
    """The heap stack of device-grown trees and the BFS-compacted trees of
    the saved model walk to the same margins."""
    _, tb, _, _, heap = trained
    (_, _), (Xv, _) = data
    dv = xgbt.DMatrix(Xv, device="cpu")
    assert heap.heap_layout
    m_heap = predict_margin(heap, dv.data, torch.zeros((Xv.shape[0], 1)))
    loaded = xgbt.Booster(model_file=tb.save_raw(), device="cpu")
    np.testing.assert_array_equal(
        loaded.predict(dv, output_margin=True), m_heap.numpy()[:, 0])


def test_bin256_same_trees_margins_and_metrics(data256, trained256):
    jb, tb, jres, tres = trained256
    (X, _), (Xv, _) = data256
    binned = [d._binned[256] for d in tb._cache_refs.values()
              if 256 in d._binned]
    assert binned and all(b.bins.dtype == torch.int16 for b in binned)
    _assert_same_model(jb, tb, jres, tres, X, Xv, auc_atol=1e-5)
    # the port's model loads in the JAX package and predicts the same
    back = xgb.Booster(model_file=bytearray(tb.save_raw()))
    np.testing.assert_allclose(back.predict(xgb.DMatrix(Xv)),
                               tb.predict(xgbt.DMatrix(Xv, device="cpu")),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("iteration_range", [None, (1, 3), (0, 2), (2, 0)])
@pytest.mark.parametrize("predict_type", ["value", "margin"])
def test_inplace_predict_matches_jax(data256, trained256, iteration_range,
                                     predict_type):
    _, tb, _, _ = trained256
    (_, _), (Xv, _) = data256
    jb = xgb.Booster(model_file=bytearray(tb.save_raw()))
    kw = dict(iteration_range=iteration_range, predict_type=predict_type)
    np.testing.assert_allclose(tb.inplace_predict(Xv, **kw),
                               jb.inplace_predict(Xv, **kw),
                               rtol=1e-5, atol=1e-5)
    base = np.random.RandomState(4).randn(Xv.shape[0]).astype(np.float32)
    np.testing.assert_allclose(tb.inplace_predict(Xv, base_margin=base, **kw),
                               jb.inplace_predict(Xv, base_margin=base, **kw),
                               rtol=1e-5, atol=1e-5)
