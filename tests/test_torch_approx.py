"""Port parity: ``tree_method="approx"`` against the JAX package.

The per-round sketch. ``DMatrix.build_binned`` with hessian weights
(``p(1-p)`` of random margins, so every weight differs) on 2048 x 6 rows
with 5% missing values: the cut values equal the JAX package's exactly
(both take the weighted CDF as a strict left-to-right float32 sum, the
port on the host), and so do the bins; the build is not cached.

Training. 3 rounds of ``tree_method="approx"`` and of
``updater="grow_histmaker"`` (the same method), ``binary:logistic``, and
3 rounds of a 3-class ``multi:softprob`` (the sketch weighted by the
hessians summed over the classes, as numpy sums them in the JAX package),
the held-out rows evaluated: the same trees with
``tests/test_torch_lossguide.py``'s tolerances (structure and split
conditions exact, ``default_left`` where a training row with a missing
value reaches the node, leaf values within rtol 1e-5 and atol 5e-5),
margins within the same and the eval history within 1e-6.
"""

import json

import jax
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from test_torch_lossguide import TOL, _assert_same_trees, _margins, _trees

torch.set_num_threads(1)

N, F = 2048, 6


@pytest.fixture(scope="module", autouse=True)
def _pin_jax_route():
    """The JAX package's float level histograms (the parity tests' route)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        yield
    jax.clear_caches()


def _data(seed, n, classes=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    score = np.nan_to_num(X) @ rng.randn(F, max(classes - 1, 1))
    if classes == 2:
        y = ((score[:, 0] + 0.5 * rng.randn(n)) > 0).astype(np.float32)
    else:
        y = np.argmax(np.concatenate([score, np.zeros((n, 1))], 1)
                      + 0.5 * rng.randn(n, classes), 1).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    return X, y


@pytest.mark.parametrize("max_bin", [16, 256])
def test_build_binned_with_hessian_weights_matches_jax(max_bin):
    X, y = _data(0, N)
    p = 1.0 / (1.0 + np.exp(-np.random.RandomState(1).randn(N)))
    hw = (p * (1.0 - p)).astype(np.float32)
    jb = xgb.DMatrix(X, label=y).build_binned(max_bin, hw)
    td = xgbt.DMatrix(X, y, device="cpu")
    tb = td.build_binned(max_bin, torch.from_numpy(hw))
    np.testing.assert_array_equal(tb.cuts.values, np.asarray(jb.cuts.values))
    np.testing.assert_array_equal(tb.bins.numpy().astype(np.int32),
                                  np.asarray(jb.bins).astype(np.int32))
    assert td.build_binned(max_bin, torch.from_numpy(hw)) is not tb
    # a different weighting moves the cuts: the sketch reads the weights
    unit = td.build_binned(max_bin)
    assert not np.array_equal(unit.cuts.values, tb.cuts.values)


CASES = {
    "approx": ({"tree_method": "approx"}, 2),
    "grow_histmaker": ({"updater": "grow_histmaker"}, 2),
    "approx_multiclass": ({"tree_method": "approx",
                           "objective": "multi:softprob", "num_class": 3,
                           "eval_metric": ["mlogloss"]}, 3),
}
BASE = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32,
        "eta": 0.3, "eval_metric": ["auc", "logloss"]}


@pytest.fixture(scope="module")
def trained():
    out = {}
    for name, (extra, classes) in CASES.items():
        X, y = _data(2, 2560, classes)
        Xt, yt, Xv, yv = X[:N], y[:N], np.nan_to_num(X[N:]), y[N:]
        p = {**BASE, **extra}
        jres, tres = {}, {}
        jb = xgb.train(p, xgb.DMatrix(Xt, label=yt), 3,
                       evals=[(xgb.DMatrix(Xv, label=yv), "val")],
                       evals_result=jres, verbose_eval=False)
        tb = xgbt.train(p, xgbt.DMatrix(Xt, yt, device="cpu"), 3,
                        evals=[(xgbt.DMatrix(Xv, yv, device="cpu"), "val")],
                        evals_result=tres, verbose_eval=False)
        out[name] = (Xt, Xv, jb, tb, jres, tres)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_matches_jax(trained, case):
    X, Xv, jb, tb, jres, tres = trained[case]
    _assert_same_trees(_trees(json.loads(jb.save_raw())),
                       _trees(tb.save_json()), X)
    for rows in (X, Xv):
        np.testing.assert_allclose(_margins(tb, rows), _margins(jb, rows),
                                   rtol=1e-5, atol=TOL)
    for m, vals in jres["val"].items():
        np.testing.assert_allclose(np.rint(np.asarray(tres["val"][m]) * 1e6),
                                   np.rint(np.asarray(vals) * 1e6),
                                   rtol=0, atol=1.0)
    classes = CASES[case][1]
    assert tb.num_boosted_rounds() == 3
    assert len(_trees(tb.save_json())) == 3 * (classes if classes > 2 else 1)


def test_approx_cuts_follow_the_round_hessians(trained):
    """Each approx round sketches a new matrix from its own hessians
    (round 0's are all 0.25 at margin 0, a later round's differ), and
    caches none; the hist method on the same data keeps one."""
    X, _, _, _, _, _ = trained["approx"]
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float32)
    d = xgbt.DMatrix(X, y, device="cpu")
    built = []
    build = d.build_binned

    def recording(max_bin, sketch_weights=None):
        built.append((sketch_weights.clone(), build(max_bin, sketch_weights)))
        return built[-1][1]

    d.build_binned = recording
    xgbt.train({**BASE, "tree_method": "approx"}, d, 2, verbose_eval=False)
    assert len(built) == 2 and not d._binned
    (w0, b0), (w1, b1) = built
    assert torch.all(w0 == 0.25) and not torch.all(w1 == 0.25)
    assert not np.array_equal(b0.cuts.values, b1.cuts.values)
    del d.build_binned
    xgbt.train({**BASE, "tree_method": "hist"}, d, 2, verbose_eval=False)
    assert list(d._binned) == [BASE["max_bin"]]
