"""Port parity for the metrics: every metric of the port against the JAX
package's on the same predictions, labels, weights and label bounds, with
and without weights and with zero total weight; the argument forms
(``error@0.7``, ``tweedie-nloglik@1.2``); K-class AUC and AUC-PR with
ties; ``create_metric``'s parsing and each metric's ``maximize``; and the
reference's own unit-test values.

Tolerances. Equal within 1e-6 (relative, or absolute below 1): the port
sums in float64 where the JAX package sums in float32 (or, for AUC-PR and
the interval accuracy, in numpy float64 on the host). ``aft-nloglik`` is
held within 1e-6 on rows of all four censoring types near their times; in
the far tails its float32 interval probabilities cancel
(``tests/test_torch_objectives.py`` says how much). The reference's
fixtures (``tests/cpp/metric/*``, copied with
their citations from ``tests/test_golden_parity.py:320-400`` and
``:434-560``; the grouped, ranking AUC at ``:460`` waits for ranking) keep
the tolerances that file states (mostly 1e-3).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_tpu.metric import create_metric as j_metric
from xgboost_tpu.params import LearnerParam as JParam
from xgboost_tpu_torch.metric import create_metric as t_metric
from xgboost_tpu_torch.params import LearnerParam as TParam

torch.set_num_threads(1)

N = 300


def _preds(kind, rng, n):
    if kind == "prob":
        return rng.rand(n)
    if kind == "positive":
        return rng.gamma(2.0, 1.0, n) + 0.05
    if kind == "real":
        return rng.randn(n)
    raise ValueError(kind)


def _labels(kind, rng, n):
    if kind == "binary":
        return (rng.rand(n) < 0.4).astype(np.float64)
    if kind == "real":
        return rng.randn(n)
    if kind == "positive":
        return rng.gamma(2.0, 1.0, n) + 0.05
    if kind == "counts":
        return rng.poisson(1.5, n).astype(np.float64)
    if kind == "tweedie":
        counts = rng.poisson(0.8, n)
        return np.array([rng.gamma(2.0, 1.0, c).sum() for c in counts])
    raise ValueError(kind)


# (metric, prediction kind, label kind)
ELEMENTWISE = [
    ("rmse", "real", "real"),
    ("rmsle", "positive", "positive"),
    ("mae", "real", "real"),
    ("mape", "real", "positive"),
    ("mphe", "real", "real"),
    ("logloss", "prob", "binary"),
    ("error", "prob", "binary"),
    ("error@0.7", "prob", "binary"),
    ("poisson-nloglik", "positive", "counts"),
    ("gamma-deviance", "positive", "positive"),
    ("gamma-nloglik", "positive", "positive"),
    ("tweedie-nloglik@1.5", "positive", "tweedie"),
    ("tweedie-nloglik@1.2", "positive", "tweedie"),
    ("tweedie-nloglik", "positive", "tweedie"),
    ("auc", "prob", "binary"),
    ("aucpr", "prob", "binary"),
]

WEIGHTS = ["none", "random", "zero"]


def _j(a):
    return None if a is None else jnp.asarray(a, jnp.float32)


def _t(a):
    return None if a is None else torch.as_tensor(a, dtype=torch.float32)


def _same(got, want, tol=1e-6):
    if math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == pytest.approx(want, rel=tol, abs=tol)


def _weights(kind, rng, n):
    if kind == "none":
        return None
    if kind == "zero":
        return np.zeros(n, np.float32)
    return rng.uniform(0.1, 3.0, n).astype(np.float32)


def _eval_both(name, p, y, w, **bounds):
    jm, tm = j_metric(name), t_metric(name)
    jb = {k: _j(v) for k, v in bounds.items()}
    tb = {k: _t(v) for k, v in bounds.items()}
    want = float(jm.evaluate(_j(p), _j(y), _j(w), **jb))
    got = tm.evaluate(_t(p), _t(y), _t(w), **tb)
    assert isinstance(got, float)
    assert tm.name == jm.name
    assert tm.maximize == jm.maximize
    return got, want


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("name,pk,lk", ELEMENTWISE,
                         ids=[c[0] for c in ELEMENTWISE])
def test_metric_matches_jax(name, pk, lk, weights):
    rng = np.random.RandomState(len(name) + len(weights))
    p = _preds(pk, rng, N).astype(np.float32)
    y = _labels(lk, rng, N).astype(np.float32)
    if name == "aucpr":  # ties: a coarse grid of scores
        p = np.round(p * 8) / 8
    got, want = _eval_both(name, p, y, _weights(weights, rng, N))
    _same(got, want)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("name", ["merror", "mlogloss", "auc"])
def test_multiclass_metric_matches_jax(name, weights):
    rng = np.random.RandomState(5 + len(weights))
    K = 4
    logits = rng.randn(N, K) * 1.5
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    p = np.round(p * 16) / 16  # ties within each class's scores
    y = rng.randint(0, K, N).astype(np.float32)
    got, want = _eval_both(name, p.astype(np.float32), y,
                           _weights(weights, rng, N))
    _same(got, want)


def test_merror_on_class_indices_matches_jax():
    """``multi:softmax`` predictions: [n] class indices."""
    rng = np.random.RandomState(2)
    p = rng.randint(0, 3, N).astype(np.float32)
    y = rng.randint(0, 3, N).astype(np.float32)
    got, want = _eval_both("merror", p, y, None)
    _same(got, want)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("dist", ["normal", "logistic", "extreme"])
def test_aft_metrics_match_jax(dist, weights):
    rng = np.random.RandomState(7)
    t = rng.gamma(2.0, 20.0, N).astype(np.float32)
    kind = rng.randint(0, 4, N)
    lower = np.where(kind == 2, 0.0, t).astype(np.float32)
    upper = np.select([kind == 1, kind == 3], [np.inf, t * 2.5], t
                      ).astype(np.float32)
    m = (np.log(t) + 0.7 * rng.randn(N)).astype(np.float32)
    w = _weights(weights, rng, N)
    params = {"objective": "survival:aft", "aft_loss_distribution": dist,
              "aft_loss_distribution_scale": 1.3}
    for name in ("aft-nloglik", "interval-regression-accuracy"):
        jm, tm = j_metric(name), t_metric(name)
        jm.lparam, tm.lparam = JParam(**params), TParam(**params)
        want = float(jm.evaluate(_j(m), _j(t), _j(w), label_lower=_j(lower),
                                 label_upper=_j(upper)))
        got = tm.evaluate(_t(m), _t(t), _t(w), label_lower=_t(lower),
                          label_upper=_t(upper))
        _same(got, want)
        assert tm.maximize == jm.maximize


def test_cox_nloglik_matches_jax():
    rng = np.random.RandomState(4)
    y = np.sort(rng.randint(1, 50, N)).astype(np.float32)
    y = np.where(rng.rand(N) < 0.3, -y, y).astype(np.float32)
    p = np.exp(rng.randn(N)).astype(np.float32)
    got, want = _eval_both("cox-nloglik", p, y, None)
    _same(got, want)
    got, want = _eval_both("cox-nloglik", p, -np.abs(y), None)
    assert math.isnan(got) and math.isnan(want)


def test_aucpr_ties_and_no_positives():
    """AUC-PR evaluates at the ends of tie blocks: one block of all rows
    gives the positive rate; no positives gives NaN in both."""
    y = np.array([0, 1, 1, 0, 1, 0], np.float32)
    for p in (np.full(6, 0.3, np.float32),
              np.array([0.1, 0.9, 0.9, 0.9, 0.2, 0.2], np.float32)):
        got, want = _eval_both("aucpr", p, y, None)
        _same(got, want)
    got, _ = _eval_both("aucpr", np.full(6, 0.3, np.float32), y, None)
    assert got == pytest.approx(0.5)
    got, want = _eval_both("aucpr", np.linspace(0, 1, 6), np.zeros(6), None)
    assert math.isnan(got) and math.isnan(want)


def test_aucpr_refuses_k_class_predictions_as_jax_does():
    p = np.random.RandomState(0).rand(20, 3).astype(np.float32)
    y = np.arange(20, dtype=np.float32) % 3
    with pytest.raises(IndexError):
        j_metric("aucpr").evaluate(_j(p), _j(y))
    with pytest.raises(ValueError, match="one score per row"):
        t_metric("aucpr").evaluate(_t(p), _t(y))


def test_multiclass_auc_with_an_absent_class_is_nan_in_both():
    rng = np.random.RandomState(0)
    p = rng.rand(50, 3).astype(np.float32)
    y = rng.randint(0, 2, 50).astype(np.float32)  # class 2 absent
    got, want = _eval_both("auc", p, y, None)
    assert math.isnan(got) and math.isnan(want)


def test_create_metric_parses_arguments_and_refuses_unported():
    assert t_metric("error@0.7").name == "error@0.7"
    assert t_metric("error@0.7").t == pytest.approx(0.7)
    m = t_metric("tweedie-nloglik@1.2")
    assert m.name == "tweedie-nloglik@1.2" and m.rho == pytest.approx(1.2)
    assert t_metric("tweedie-nloglik").name == j_metric(
        "tweedie-nloglik").name == "tweedie-nloglik@1.5"
    for name in ("auc", "aucpr", "interval-regression-accuracy"):
        assert t_metric(name).maximize and j_metric(name).maximize
    for name in ("rmse", "mlogloss", "merror", "cox-nloglik"):
        assert not t_metric(name).maximize
    for name in ("ndcg", "map@3", "pre@2", "ams@0.15", "ndcg-", "map@2-"):
        assert t_metric(name).name == j_metric(name).name == name
        assert t_metric(name).maximize and j_metric(name).maximize
    with pytest.raises(NotImplementedError, match="not ported"):
        t_metric("no-such-metric")


# ---------------------------------------------------------------------------
# the reference's fixtures, as tests/test_golden_parity.py:320-400 and
# :434-560 carry them (values copied, not imported); tests/cpp/metric/*
# ---------------------------------------------------------------------------

def check_metric(name, preds, labels, expected, weights=None, tol=0.001,
                 **kw):
    m = t_metric(name)
    val = m.evaluate(_t(preds), _t(labels), _t(weights), **kw)
    assert val == pytest.approx(expected, abs=tol), (name, val, expected)


_P4, _Y4 = [0.1, 0.9, 0.1, 0.9], [0, 0, 1, 1]
_WN, _WP = [-1, 1, 9, -9], [1, 2, 9, 8]
# (metric, preds, labels, expected, weights, tol)
GOLDEN = [
    # test_elementwise_metric.cc:42
    ("rmse", [0, 1], [0, 1], 0, None, 1e-8),
    ("rmse", _P4, _Y4, 0.6403, None, 1e-3),
    ("rmse", _P4, _Y4, 2.8284, _WN, 1e-3),
    ("rmse", _P4, _Y4, 0.6708, _WP, 1e-3),
    # :68
    ("rmsle", [0.1, 0.2, 0.4, 0.8, 1.6], [1.0] * 5, 0.4063, None, 1e-3),
    ("rmsle", [0.1, 0.2, 0.4, 0.8, 1.6], [1.0] * 5, 0.6212,
     [0, -1, 1, -9, 9], 1e-3),
    ("rmsle", [0.1, 0.2, 0.4, 0.8, 1.6], [1.0] * 5, 0.2415,
     [0, 1, 2, 9, 8], 1e-3),
    # :93
    ("mae", _P4, _Y4, 0.5, None, 1e-3),
    ("mae", _P4, _Y4, 8.0, _WN, 1e-3),
    ("mae", _P4, _Y4, 0.54, _WP, 1e-3),
    # :118
    ("mape", [150, 300], [100, 200], 0.5, None, 1e-8),
    ("mape", [50, 400, 500, 4000], [100, 200, 500, 1000], 1.125, None, 1e-3),
    ("mape", [50, 400, 500, 4000], [100, 200, 500, 1000], -26.5, _WN, 1e-3),
    ("mape", [50, 400, 500, 4000], [100, 200, 500, 1000], 1.3250, _WP, 1e-3),
    # :143
    ("mphe", _P4, _Y4, 0.1751, None, 1e-3),
    ("mphe", _P4, _Y4, 3.4037, _WN, 1e-3),
    ("mphe", _P4, _Y4, 0.1922, _WP, 1e-3),
    # :168
    ("logloss", [0.5, 1e-17, 1.0 + 1e-17, 0.9], _Y4, 0.1996, None, 1e-3),
    ("logloss", _P4, _Y4, 1.2039, None, 1e-3),
    ("logloss", _P4, _Y4, 21.9722, _WN, 1e-3),
    ("logloss", _P4, _Y4, 1.3138, _WP, 1e-3),
    # :197
    ("error", _P4, _Y4, 0.5, None, 1e-3),
    ("error", _P4, _Y4, 10.0, _WN, 1e-3),
    ("error", _P4, _Y4, 0.55, _WP, 1e-3),
    ("error@0.1", [-0.1, -0.9, 0.1, 0.9], _Y4, 0.25, None, 1e-3),
    ("error@0.1", [-0.1, -0.9, 0.1, 0.9], _Y4, 9.0, _WN, 1e-3),
    ("error@0.1", [-0.1, -0.9, 0.1, 0.9], _Y4, 0.45, _WP, 1e-3),
    # :252
    ("poisson-nloglik", [0, 1], [0, 1], 0.5, None, 1e-6),
    ("poisson-nloglik", [0.5, 1e-17, 1.0 + 1e-17, 0.9], _Y4, 0.6263, None,
     1e-3),
    ("poisson-nloglik", _P4, _Y4, 1.1019, None, 1e-3),
    ("poisson-nloglik", _P4, _Y4, 13.3750, _WN, 1e-3),
    ("poisson-nloglik", _P4, _Y4, 1.5783, _WP, 1e-3),
    # test_auc.cc:14
    ("auc", [0, 1], [0, 1], 1.0, None, 1e-8),
    ("auc", [0, 1], [1, 0], 0.0, None, 1e-8),
    ("auc", [0, 0], [0, 1], 0.5, None, 1e-8),
    ("auc", [1, 1], [0, 1], 0.5, None, 1e-8),
    ("auc", [1, 0, 0], [0, 0, 1], 0.25, None, 1e-8),
    ("auc", [0.9, 0.1, 0.4, 0.3], [0, 0, 1, 1], 0.75, [1.0, 3.0, 2.0, 4.0],
     1e-8),
    # :41, ties everywhere
    ("auc", [0.79523796, 0.5201713, 0.79523796, 0.24273258, 0.53452194,
             0.53452194, 0.24273258, 0.5201713, 0.79523796, 0.53452194,
             0.24273258, 0.53452194, 0.79523796, 0.5201713, 0.24273258,
             0.5201713, 0.5201713, 0.53452194, 0.5201713, 0.53452194],
     [0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1, 1, 1, 0], 0.5,
     None, 1e-8),
    # :160
    ("aucpr", [0, 0, 1, 1], [0, 0, 1, 1], 1, None, 1e-6),
    ("aucpr", _P4, _Y4, 0.5, None, 1e-3),
    # test_golden_parity.py:511: the product form keeps soft labels
    ("logloss", [0.9], [0.3], 1.6439, None, 1e-3),
]


@pytest.mark.parametrize("case", range(len(GOLDEN)))
def test_golden_metric(case):
    name, preds, labels, expected, weights, tol = GOLDEN[case]
    check_metric(name, preds, labels, expected, weights, tol)


def test_golden_logloss_out_of_range_is_not_negative():
    # test_golden_parity.py:511
    assert t_metric("logloss").evaluate(_t([5.0]), _t([1.0])) >= 0.0


def test_golden_multiclass_auc():  # test_auc.cc:59
    m = t_metric("auc")
    val = m.evaluate(torch.eye(3), _t([0.0, 1.0, 2.0]))
    assert val == pytest.approx(1.0, abs=1e-6)


def test_golden_merror_mlogloss():  # test_multiclass_metric.cc:44,64
    eye, flat = torch.eye(3), torch.full((3, 3), 0.1)
    lab = _t([0.0, 1.0, 2.0])
    assert t_metric("merror").evaluate(eye, lab) == pytest.approx(0, abs=1e-8)
    assert t_metric("merror").evaluate(flat, lab) == pytest.approx(
        0.666, abs=1e-3)
    assert t_metric("mlogloss").evaluate(eye, lab) == pytest.approx(
        0, abs=1e-5)
    assert t_metric("mlogloss").evaluate(flat, lab) == pytest.approx(
        2.302, abs=1e-3)


def test_golden_interval_regression_accuracy():  # test_survival_metric.cu:79
    m = t_metric("interval-regression-accuracy")
    preds = torch.full((4,), math.log(60.0))
    lab = torch.zeros(4)

    def acc(lower, upper):
        return m.evaluate(preds, lab, label_lower=_t(lower),
                          label_upper=_t(upper))

    inf = float("inf")
    assert acc([20, 0, 60, 16], [80, 20, 80, 200]) == pytest.approx(0.75)
    assert acc([20, 0, 70, 16], [80, 20, 80, 200]) == pytest.approx(0.50)
    assert acc([20, 0, 70, 16], [80, 20, inf, 200]) == pytest.approx(0.50)
    assert acc([20, 0, 70, 16], [80, 20, inf, inf]) == pytest.approx(0.50)
    assert acc([70, 0, 70, 16], [80, 20, inf, inf]) == pytest.approx(0.25)


class _P:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("dist,want", [("normal", 2.1508),
                                       ("logistic", 2.1804),
                                       ("extreme", 2.0706)])
def test_golden_aft_nloglik(dist, want):  # test_survival_metric.cu:50
    m = t_metric("aft-nloglik")
    m.lparam = _P(aft_loss_distribution=dist,
                  aft_loss_distribution_scale=1.0)
    got = m.evaluate(torch.full((4,), math.log(64.0)), torch.zeros(4),
                     label_lower=_t([100.0, 0.0, 60.0, 16.0]),
                     label_upper=_t([100.0, 20.0, float("inf"), 200.0]))
    assert got == pytest.approx(want, abs=2e-3), (dist, got, want)
