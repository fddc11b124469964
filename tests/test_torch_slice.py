"""Port parity for the whole slice: train, evaluate, predict, model IO.

Both packages train ``binary:logistic`` with the depthwise hist grower for
3 rounds at depth 3, B = 16, on the same 2048 x 6 numpy matrix with 5% NaNs
(the JAX package pinned to its per-level float route:
``XGBTPU_DISPATCH=tree_grow=level,sibling_sub=off,hist_acc=float``). The
trees must have the same structure, split features and conditions; margins
and predictions agree within 1e-5 and AUC within 1e-6. A JAX model loads
into the port and predicts within 1e-5, and the port's JSON loads into JAX.

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


@pytest.fixture(scope="module")
def trained(data):
    (X, y), (Xv, yv) = data
    jres, tres = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        jb = xgb.train(PARAMS, xgb.DMatrix(X, label=y), 3,
                       evals=[(xgb.DMatrix(Xv, label=yv), "val")],
                       evals_result=jres, verbose_eval=False)
    tb = xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), 3,
                    evals=[(xgbt.DMatrix(Xv, yv, device="cpu"), "val")],
                    evals_result=tres, verbose_eval=False)
    # the heap stack of the device-grown trees, before model IO compacts them
    heap = tb._gbm.model.stacked()
    return jb, tb, jres, tres, heap


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


def test_same_trees_margins_and_metrics(data, trained):
    jb, tb, jres, tres, _ = trained
    (X, _), (Xv, _) = data
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
    np.testing.assert_allclose(tres["val"]["auc"], jres["val"]["auc"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tres["val"]["logloss"], jres["val"]["logloss"],
                               rtol=1e-5)
    assert tres["val"]["auc"][-1] > tres["val"]["auc"][0]


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
