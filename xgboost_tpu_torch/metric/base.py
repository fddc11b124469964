"""Metric base (reference ``include/xgboost/metric.h``; every elementwise
metric is sum(w * loss) / sum(w), ``elementwise_metric.cu``)."""

from __future__ import annotations

from typing import Dict, Optional, Type

import torch

__all__ = ["Metric", "ElementwiseMetric", "create_metric", "register"]

_REGISTRY: Dict[str, Type["Metric"]] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


class Metric:
    name: str = ""

    def evaluate(self, preds: torch.Tensor, label: torch.Tensor,
                 weight: Optional[torch.Tensor] = None) -> float:
        raise NotImplementedError


class ElementwiseMetric(Metric):
    """sum(w * loss(pred, y)) / sum(w); losses in f32, sums in float64."""

    def loss(self, pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def finalize(self, s: float, w: float) -> float:
        # wsum == 0 returns the raw sum (elementwise_metric.cu GetFinal)
        return s if w == 0 else s / w

    def evaluate(self, preds, label, weight=None):
        if preds.dim() == 2 and preds.shape[1] == 1:
            preds = preds[:, 0]
        loss = self.loss(preds, label).double()
        if weight is not None and weight.numel():
            w = weight.double()
            s, tw = (loss * w).sum(), w.sum()
        else:
            s, tw = loss.sum(), float(loss.shape[0])
        return self.finalize(float(s), float(tw))


def create_metric(name: str) -> Metric:
    cls = _REGISTRY.get(name)
    if cls is None:
        raise NotImplementedError(
            f"metric {name!r} is not ported yet; the port has "
            f"{sorted(_REGISTRY)}")
    return cls()
