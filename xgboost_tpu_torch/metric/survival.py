"""Survival metrics (reference ``src/metric/survival_metric.cu``,
``aft-nloglik`` / ``interval-regression-accuracy`` at :287-293;
``cox-nloglik`` in ``rank_metric.cc``; the JAX package's
``metric/survival.py``). AFT predictions arrive untransformed, in log
space (``AFT.eval_transform``), with the label bounds."""

from __future__ import annotations

import torch

from ..objective.survival import AFT
from .base import Metric, register, weighted_sum

__all__ = ["AFTNLogLik", "IntervalAccuracy", "CoxNLogLik"]


def _bounds(label, label_lower, label_upper):
    return (label if label_lower is None else label_lower,
            label if label_upper is None else label_upper)


@register("aft-nloglik")
class AFTNLogLik(Metric):
    name = "aft-nloglik"

    def evaluate(self, preds, label, weight=None, *, label_lower=None,
                 label_upper=None, **kw):
        # configured like the objective: the same distribution and scale
        # (survival_metric.cu parses the same AFTParam)
        yl, yu = _bounds(label, label_lower, label_upper)
        margin = preds.reshape(-1)
        ll = AFT(self.lparam)._loglik(margin, yl.float(), yu.float())
        if weight is None or weight.numel() != margin.shape[0]:
            weight = None
        s, w = weighted_sum(ll, weight)
        # IEEE division: a zero total weight gives NaN, as in the JAX
        # package
        return float(torch.tensor(-s, dtype=torch.float64) / w)


@register("interval-regression-accuracy")
class IntervalAccuracy(Metric):
    name = "interval-regression-accuracy"
    maximize = True

    def evaluate(self, preds, label, weight=None, *, label_lower=None,
                 label_upper=None, **kw):
        # log(lower) <= pred <= log(upper), the predictions in log space
        # and the bounds linear (survival_metric.cu); unweighted, as in
        # the JAX package
        yl, yu = _bounds(label, label_lower, label_upper)
        p = preds.reshape(-1).double()
        yl, yu = yl.double(), yu.double()
        ok = (p >= torch.log(torch.clamp(yl, min=0.0))) & (
            ~torch.isfinite(yu) | (p <= torch.log(torch.clamp(yu, min=0.0))))
        return float(ok.double().mean())


@register("cox-nloglik")
class CoxNLogLik(Metric):
    name = "cox-nloglik"

    def evaluate(self, preds, label, weight=None, **kw):
        from ..parallel.mesh import collective_active

        if collective_active():
            # risk-set sums need the globally time-ordered cohort; the
            # reference refuses too (rank_metric.cc:348)
            raise ValueError(
                "Cox metric does not support distributed evaluation")
        # rows sorted by time ascending; preds are exp(margin)
        e = preds.reshape(-1).double()
        y = label.double()
        rsum = torch.flip(torch.cumsum(torch.flip(e, [0]), 0), [0])
        events = y > 0
        n_events = int(events.sum())
        if n_events == 0:
            return float("nan")
        ll = (torch.log(torch.clamp(e[events], min=1e-30))
              - torch.log(torch.clamp(rsum[events], min=1e-30)))
        return float(-ll.sum() / n_events)
