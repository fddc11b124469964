"""Port parity: the linear booster (``booster="gblinear"``,
``xgboost_tpu_torch/gbm/gblinear.py``) against the JAX package, on the CPU.

Both packages train on the same seeded numpy data (256 x 6 with 10%
missing values) for 5 rounds: ``reg:squarederror`` on a linear target with
every updater and selector (``coord_descent`` with cyclic, shuffle, random,
greedy and thrifty, greedy and thrifty at ``top_k`` 2 with ``lambda`` and
``alpha``, ``shotgun`` with cyclic and shuffle), ``binary:logistic`` and
3-class ``multi:softprob`` with a deterministic and a random selector.
Tolerances:

- weights within rtol 1e-5, atol 1e-6 (the JAX package sums in float32,
  the port in float64 rounded to float32);
- margins and predictions within 1e-5; contributions within 1e-6;
- a model carried across (JSON both ways): the same weights bitwise, so
  dumps, scores, predictions and contributions equal the other package's
  (predictions within 1e-6).

``threefry.randint`` against ``jax.random.randint`` is in
``test_torch_random.py``.
"""

import json

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch.data.dmatrix import DMatrix as TDMatrix

torch.set_num_threads(1)

F = 6
ROUNDS = 5
SELECTORS = {
    "cyclic": dict(feature_selector="cyclic"),
    "shuffle": dict(feature_selector="shuffle"),
    "random": dict(feature_selector="random"),
    "greedy": dict(feature_selector="greedy"),
    "thrifty": dict(feature_selector="thrifty"),
    "greedy_top2_reg": dict(feature_selector="greedy", top_k=2,
                            **{"lambda": 0.5, "alpha": 0.05}),
    "thrifty_top2_reg": dict(feature_selector="thrifty", top_k=2,
                             **{"lambda": 0.5, "alpha": 0.05}),
    "shotgun_cyclic": dict(updater="shotgun", feature_selector="cyclic"),
    "shotgun_shuffle": dict(updater="shotgun", feature_selector="shuffle"),
}


def _data(seed=0, n=256):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.1] = np.nan
    coef = rng.randn(F).astype(np.float32)
    yr = (np.nan_to_num(X) @ coef + 0.3 + 0.1 * rng.randn(n)
          ).astype(np.float32)
    z = np.nan_to_num(X) @ rng.randn(F, 3)
    ym = np.argmax(z + 0.3 * rng.randn(n, 3), 1).astype(np.float32)
    return X, yr, (yr > 0.3).astype(np.float32), ym


@pytest.fixture(scope="module")
def data():
    return _data()


def _params(objective, sel):
    p = {"booster": "gblinear", "objective": objective, **SELECTORS[sel]}
    if objective == "multi:softprob":
        p["num_class"] = 3
    return p


def _label(data, objective):
    X, yr, yb, ym = data
    return {"reg:squarederror": yr, "binary:logistic": yb,
            "multi:softprob": ym}[objective]


def _train_both(data, params, rounds=ROUNDS):
    X = data[0]
    y = _label(data, params["objective"])
    jb = xgb.train(params, xgb.DMatrix(X, label=y), rounds,
                   verbose_eval=False)
    tb = xgbt.train(params, xgbt.DMatrix(X, y, device="cpu"), rounds,
                    verbose_eval=False)
    return jb, tb


CASES = ([("reg:squarederror", s) for s in SELECTORS]
         + [(o, s) for o in ("binary:logistic", "multi:softprob")
            for s in ("cyclic", "random")])


@pytest.mark.parametrize("objective,sel", CASES)
def test_weights_match_jax(data, objective, sel):
    jb, tb = _train_both(data, _params(objective, sel))
    jw = np.asarray(jb._gbm.weights)
    tw = tb._gbm.host_weights()
    assert tw.shape == jw.shape == (F + 1, 3 if "multi" in objective else 1)
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
    X = data[0]
    np.testing.assert_allclose(
        tb.predict(xgbt.DMatrix(X, device="cpu"), output_margin=True),
        jb.predict(xgb.DMatrix(X), output_margin=True), rtol=0, atol=1e-5)


def test_recovers_the_generating_coefficients():
    """``tests/test_components.py``'s case in the port: 50 rounds of
    ``reg:squarederror`` on ``1.5 x0 - 2 x1 + 0.5`` recover it (the
    intercept is the default base score, 0.5, so the bias stays 0)."""
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 3).astype(np.float32)
    y = (1.5 * X[:, 0] - 2.0 * X[:, 1] + 0.5).astype(np.float32)
    d = xgbt.DMatrix(X, y, device="cpu")
    bst = xgbt.train({"booster": "gblinear", "objective": "reg:squarederror",
                      "eta": 0.5, "lambda": 0.0}, d, 50, verbose_eval=False)
    w = bst._gbm.host_weights()[:, 0]
    np.testing.assert_allclose(w, [1.5, -2.0, 0.0, 0.0], atol=0.05)
    assert float(np.sqrt(np.mean((bst.predict(d) - y) ** 2))) < 0.1


def test_trains_on_raw_rows_without_bins(data, monkeypatch):
    """The booster reads ``dtrain.data``: no sketch, no bins, no one-hot."""
    def no_bins(*a, **k):
        raise AssertionError("gblinear built bins")

    monkeypatch.setattr(TDMatrix, "get_binned", no_bins)
    X, yr = data[0], data[1]
    bst = xgbt.train({"booster": "gblinear"}, xgbt.DMatrix(X, yr,
                                                           device="cpu"),
                     2, evals=[(xgbt.DMatrix(X, yr, device="cpu"), "t")],
                     verbose_eval=False)
    assert bst._gbm.weights.shape == (F + 1, 1)


@pytest.mark.parametrize("objective", ["reg:squarederror", "multi:softprob"])
def test_json_both_ways_dumps_scores_and_contribs(data, objective):
    X = data[0]
    jb, tb = _train_both(data, _params(objective, "shuffle"), rounds=2)
    to_jax = xgb.Booster(model_file=tb.save_raw())
    to_port = xgbt.Booster(model_file=jb.save_raw(), device="cpu")
    np.testing.assert_array_equal(np.asarray(to_jax._gbm.weights),
                                  tb._gbm.host_weights())
    np.testing.assert_array_equal(to_port._gbm.host_weights(),
                                  np.asarray(jb._gbm.weights))
    jd, td = xgb.DMatrix(X), xgbt.DMatrix(X, device="cpu")
    for a, b in ((to_jax, tb), (jb, to_port)):
        for fmt in ("text", "json"):
            assert b.get_dump(dump_format=fmt) == a.get_dump(dump_format=fmt)
        assert b.get_score() == a.get_score()
        np.testing.assert_allclose(b.predict(td), a.predict(jd), rtol=0,
                                   atol=1e-6)
        got = b.predict(td, pred_contribs=True)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, a.predict(jd, pred_contribs=True),
                                   rtol=0, atol=1e-6)
        got = b.predict(td, pred_interactions=True)
        want = a.predict(jd, pred_interactions=True)
        assert got.shape == want.shape and not got.any()
    assert json.loads(tb.save_raw())["learner"]["gradient_booster"][
        "name"] == "gblinear"


def test_refusals(data):
    X, yr = data[0], data[1]
    d = xgbt.DMatrix(X, yr, device="cpu")
    bst = xgbt.train({"booster": "gblinear"}, d, 1, verbose_eval=False)
    with pytest.raises(ValueError, match="leaf index"):
        bst.predict(d, pred_leaf=True)
    with pytest.raises(ValueError, match="Slice"):
        bst[:1]
    with pytest.raises(ValueError, match="not defined"):
        bst.trees_to_dataframe()
    with pytest.raises(ValueError, match="weight"):
        bst.get_score(importance_type="gain")
    with pytest.raises(ValueError, match="shotgun"):
        xgbt.train({"booster": "gblinear", "updater": "shotgun",
                    "feature_selector": "greedy"}, d, 1, verbose_eval=False)
    with pytest.raises(ValueError, match="feature_selector"):
        xgbt.train({"booster": "gblinear", "feature_selector": "best"}, d, 1,
                   verbose_eval=False)


def test_config_inplace_predict_and_continuation(data):
    """``save_config`` / ``load_config`` carry the linear parameters;
    ``inplace_predict`` goes through a DMatrix; the linear booster's
    ``num_boosted_rounds`` is 0 in both packages, so a continued model
    restarts its selectors' keys at round 0, as the JAX package's does."""
    X, yr = data[0], data[1]
    params = {"booster": "gblinear", "feature_selector": "random",
              "lambda": 0.25, "eta": 0.4}
    td = xgbt.DMatrix(X, yr, device="cpu")
    tb = xgbt.train(params, td, 2, verbose_eval=False)
    cfg = json.loads(tb.save_config())["learner"]
    assert cfg["gradient_booster"]["name"] == "gblinear"
    assert cfg["gradient_booster"]["params"]["lambda"] == 0.25
    other = xgbt.Booster(device="cpu")
    other.load_config(tb.save_config())
    other.update(td, 0)
    other.update(td, 1)
    np.testing.assert_array_equal(other._gbm.host_weights(),
                                  tb._gbm.host_weights())
    np.testing.assert_array_equal(tb.inplace_predict(X),
                                  tb.predict(xgbt.DMatrix(X, device="cpu")))
    jb = xgb.train(params, xgb.DMatrix(X, label=yr), 2, verbose_eval=False)
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == 0
    jc = xgb.train(params, xgb.DMatrix(X, label=yr), 2, xgb_model=jb,
                   verbose_eval=False)
    tc = xgbt.train(params, td, 2, xgb_model=tb, verbose_eval=False)
    np.testing.assert_allclose(tc._gbm.host_weights(),
                               np.asarray(jc._gbm.weights), rtol=1e-5,
                               atol=1e-6)
