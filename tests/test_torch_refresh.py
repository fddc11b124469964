"""Port parity: ``process_type="update"`` / ``updater="refresh"`` against
the JAX package.

The reference's refresh fixture (``tests/cpp/tree/test_refresh.cc:18-57``,
as ``tests/test_golden_parity.py`` transcribes it: 8 rows, a hand-made
depth-1 tree, fixed gradient pairs), refreshed by both packages: right
leaf -0.183392 and root loss change -0.224489 (the min_child_weight zero
rule of CalcGain), the left leaf 0 (CalcWeight's), sum_hessian and
base_weights of every node, with ``refresh_leaf`` 1 and 0 (0 keeps the
leaf values and refreshes the statistics), within 1e-6 of the reference
and equal to the JAX package's.

A model of 4 depth-3 rounds (``binary:logistic``, 512 x 5 rows with 5%
missing) refreshed on a second sample through ``train(xgb_model=)`` with
an eval set, for ``process_type="update"`` with ``refresh_leaf`` 1 and 0
and for ``updater="refresh"`` alone: the same tree count, every node's
statistics (``split_conditions``, ``base_weights``, ``sum_hessian`` within
rtol 1e-5 and atol 1e-6, ``loss_changes`` within rtol 1e-4 and atol 1e-4:
each is a difference of gains of tens, summed in float64 in another
order, then rounded to float32), the eval history of the refresh rounds
within 1e-6 (the eval set's cached margins dropped as the leaves change
under the same tree count), and the training margins within rtol 1e-5.
Too many rounds, and a refresh with no model, raise the JAX package's
ValueError with its message. A refreshed model's JSON loads in the other
package, and a JAX model refreshed by the port equals the JAX package's
own refresh.
"""

import json

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt

torch.set_num_threads(1)

GRADS = np.array([0.23] * 4 + [0.27] * 4, np.float32)
HESS = np.array([0.24] * 4 + [0.29] * 4, np.float32)


def _fixture_model():
    return {
        "version": [1, 6, 0],
        "learner": {
            "attributes": {}, "feature_names": [], "feature_types": [],
            "gradient_booster": {
                "model": {
                    "gbtree_model_param": {"num_trees": "1",
                                           "size_leaf_vector": "0"},
                    "tree_info": [0],
                    "trees": [{
                        "base_weights": [0.0, 0.0, 0.0],
                        "categories": [], "categories_nodes": [],
                        "categories_segments": [], "categories_sizes": [],
                        "default_left": [0, 0, 0], "id": 0,
                        "left_children": [1, -1, -1],
                        "loss_changes": [0.0, 0.0, 0.0],
                        "parents": [2147483647, 0, 0],
                        "right_children": [2, -1, -1],
                        "split_conditions": [0.2, 0.0, 0.0],
                        "split_indices": [2, 0, 0],
                        "split_type": [0, 0, 0],
                        "sum_hessian": [0.0, 0.0, 0.0],
                        "tree_param": {"num_deleted": "0",
                                       "num_feature": "3", "num_nodes": "3",
                                       "size_leaf_vector": "0"},
                    }],
                },
                "name": "gbtree",
            },
            "learner_model_param": {"base_score": "0", "num_class": "0",
                                    "num_feature": "3"},
            "objective": {"name": "reg:squarederror",
                          "reg_loss_param": {"scale_pos_weight": "1"}},
        },
    }


def _fobj(pred, dtrain):
    return GRADS, HESS


@pytest.mark.parametrize("refresh_leaf", [1, 0])
def test_reference_refresh_fixture_in_both_packages(tmp_path, refresh_leaf):
    X = np.full((8, 3), 0.5, np.float32)
    X[:, 2] = 0.3
    X[4, 2] = 0.1  # the one (0.27, 0.29) row that goes left
    path = tmp_path / "fixture_tree.json"
    path.write_text(json.dumps(_fixture_model()))
    params = {"max_depth": 1, "process_type": "update",
              "refresh_leaf": refresh_leaf, "reg_lambda": 1.0,
              "reg_alpha": 0.0, "eta": 0.3, "verbosity": 0}
    y = np.zeros(8, np.float32)
    jt = xgb.train(params, xgb.DMatrix(X, label=y), 1, obj=_fobj,
                   xgb_model=xgb.Booster(model_file=str(path))
                   )._gbm.model.trees[0]
    tt = xgbt.train(params, xgbt.DMatrix(X, y, device="cpu"), 1, obj=_fobj,
                    xgb_model=xgbt.Booster(model_file=str(path),
                                           device="cpu"),
                    verbose_eval=False)._gbm.model.trees[0]
    for name in ("split_conditions", "base_weights", "loss_changes",
                 "sum_hessian"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      name)
    np.testing.assert_allclose(tt.loss_changes[0], -0.224489, atol=1e-6)
    np.testing.assert_allclose(tt.sum_hessian, [2.12, 0.29, 1.83], atol=1e-6)
    if refresh_leaf:
        np.testing.assert_allclose(tt.split_conditions[2], -0.183392,
                                   atol=1e-6)
        assert tt.split_conditions[1] == 0.0
    else:
        np.testing.assert_array_equal(tt.split_conditions,
                                      np.float32([0.2, 0.0, 0.0]))


BASE = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
        "eval_metric": ["logloss"]}
REFRESH = {
    "update_leaf1": {"process_type": "update", "refresh_leaf": 1},
    "update_leaf0": {"process_type": "update", "refresh_leaf": 0},
    "updater_refresh": {"updater": "refresh"},
}


def _data(seed, n=512, F=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = ((X @ rng.randn(F) + rng.randn(n)) > 0).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    return X, y


@pytest.fixture(scope="module")
def models():
    X, y = _data(0)
    jb = xgb.train(BASE, xgb.DMatrix(X, label=y), 4, verbose_eval=False)
    tb = xgbt.train(BASE, xgbt.DMatrix(X, y, device="cpu"), 4,
                    verbose_eval=False)
    return jb, tb


def _refresh_both(models, extra, rounds=4):
    jb, tb = models
    X2, y2 = _data(1)
    Xv, yv = _data(2, 256)
    p = {**BASE, **extra}
    jres, tres = {}, {}
    jv, tv = xgb.DMatrix(Xv, label=yv), xgbt.DMatrix(Xv, yv, device="cpu")
    # the eval set's margins are cached from the original model first
    jb_, tb_ = jb.copy(), tb.copy()
    jb_.eval_set([(jv, "val")]), tb_.eval_set([(tv, "val")])
    jd, td = xgb.DMatrix(X2, label=y2), xgbt.DMatrix(X2, y2, device="cpu")
    j2 = xgb.train(p, jd, rounds, xgb_model=jb_, evals=[(jv, "val")],
                   evals_result=jres, verbose_eval=False)
    t2 = xgbt.train(p, td, rounds, xgb_model=tb_, evals=[(tv, "val")],
                    evals_result=tres, verbose_eval=False)
    return (X2, Xv), j2, t2, jres, tres


def _assert_same_stats(jtrees, ttrees):
    assert len(jtrees) == len(ttrees)
    for a, b in zip(jtrees, ttrees):
        np.testing.assert_array_equal(b.left_children, a.left_children)
        for name in ("split_conditions", "base_weights", "sum_hessian"):
            np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(b.loss_changes, a.loss_changes,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", sorted(REFRESH))
def test_refresh_matches_jax(models, case):
    (X2, Xv), j2, t2, jres, tres = _refresh_both(models, REFRESH[case])
    jb, tb = models
    assert t2.num_boosted_rounds() == j2.num_boosted_rounds() == 4
    _assert_same_stats(j2._gbm.model.trees, t2._gbm.model.trees)
    np.testing.assert_allclose(np.rint(np.asarray(tres["val"]["logloss"]) * 1e6),
                               np.rint(np.asarray(jres["val"]["logloss"]) * 1e6),
                               rtol=0, atol=1.0)
    np.testing.assert_allclose(
        t2.predict(xgbt.DMatrix(X2, device="cpu"), output_margin=True),
        j2.predict(xgb.DMatrix(X2), output_margin=True), rtol=1e-5, atol=1e-6)
    # the eval history is that of fresh walks of the refreshed forest
    fresh = xgbt.Booster(model_file=t2.save_raw(), device="cpu")
    assert abs(fresh.eval_values([(xgbt.DMatrix(
        Xv, _data(2, 256)[1], device="cpu"), "v")])["v"]["logloss"]
        - tres["val"]["logloss"][-1]) < 1e-6
    if case == "update_leaf0":  # the leaf values stay the original's
        for a, b in zip(tb._gbm.model.trees, t2._gbm.model.trees):
            leaf = a.left_children == -1
            np.testing.assert_array_equal(b.split_conditions[leaf],
                                          a.split_conditions[leaf])


def test_errors_match_jax(models):
    jb, tb = models
    X, y = _data(3)
    p = {**BASE, "process_type": "update"}
    with pytest.raises(ValueError) as je:
        xgb.train(p, xgb.DMatrix(X, label=y), 5, xgb_model=jb.copy(),
                  verbose_eval=False)
    with pytest.raises(ValueError) as te:
        xgbt.train(p, xgbt.DMatrix(X, y, device="cpu"), 5,
                   xgb_model=tb.copy(), verbose_eval=False)
    assert str(te.value) == str(je.value)
    assert "exceeds the number of trees" in str(te.value)
    with pytest.raises(ValueError) as je:
        xgb.train(p, xgb.DMatrix(X, label=y), 1, verbose_eval=False)
    with pytest.raises(ValueError) as te:
        xgbt.train(p, xgbt.DMatrix(X, y, device="cpu"), 1,
                   verbose_eval=False)
    assert str(te.value) == str(je.value)
    assert "requires an existing model" in str(te.value)


def test_refreshed_json_loads_in_both_directions(models):
    jb, tb = models
    (X2, Xv), j2, t2, _, _ = _refresh_both(models, REFRESH["update_leaf1"])
    in_jax = xgb.Booster(model_file=bytearray(t2.save_raw()))
    np.testing.assert_allclose(in_jax.predict(xgb.DMatrix(Xv),
                                              output_margin=True),
                               t2.predict(xgbt.DMatrix(Xv, device="cpu"),
                                          output_margin=True),
                               rtol=1e-6, atol=1e-6)
    # the JAX package's model, refreshed by the port, against its own
    # refresh of the same model on the same rows
    y2 = _data(1)[1]
    from_jax = xgbt.Booster(model_file=jb.save_raw(), device="cpu")
    t3 = xgbt.train({**BASE, **REFRESH["update_leaf1"]},
                    xgbt.DMatrix(X2, y2, device="cpu"), 4,
                    xgb_model=from_jax, verbose_eval=False)
    _assert_same_stats(j2._gbm.model.trees, t3._gbm.model.trees)
