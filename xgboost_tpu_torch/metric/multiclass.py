"""Multiclass metrics (reference ``src/metric/multiclass_metric.cu``,
``merror``/``mlogloss`` at :248-252; the JAX package's
``metric/multiclass.py``). A zero total weight returns the residue, not
NaN (the reference's GetFinal)."""

from __future__ import annotations

import torch

from .base import Metric, dist_reduce, register, weighted_sum

__all__ = ["MultiError", "MultiLogLoss"]

_EPS = 1e-16


def _final(s: float, w: float) -> float:
    return s / w if w > 0 else s


@register("merror")
class MultiError(Metric):
    name = "merror"

    def evaluate(self, preds, label, weight=None, **kw):
        # [n] class indices (multi:softmax output) or [n, K] scores
        yhat = preds if preds.dim() == 1 else torch.argmax(preds, dim=-1)
        wrong = (yhat.to(torch.int32) != label.to(torch.int32)).to(
            torch.float32)
        return _final(*dist_reduce(*weighted_sum(wrong, weight)))


@register("mlogloss")
class MultiLogLoss(Metric):
    name = "mlogloss"

    def evaluate(self, preds, label, weight=None, **kw):
        picked = torch.gather(preds, 1, label.long()[:, None])[:, 0]
        loss = -torch.log(torch.clamp(picked, _EPS, 1.0))
        return _final(*dist_reduce(*weighted_sum(loss, weight)))
