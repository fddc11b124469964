"""Metric base (reference ``include/xgboost/metric.h``; every elementwise
metric is sum(w * loss) / sum(w), ``elementwise_metric.cu``). Metrics run
on the predictions' device; their sums run in float64. Under an active row
group of several ranks each metric's (sum, weight) pair is summed over the
ranks (``dist_reduce``) before the final divide, the reference's
AllReduce in every ``GetFinal``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

__all__ = ["Metric", "ElementwiseMetric", "create_metric", "register",
           "weighted_sum", "dist_reduce"]

_REGISTRY: Dict[str, Type["Metric"]] = {}


def register(*names: str):
    """Register a metric class under ``names``. A name ending in ``@``
    takes an argument (``error@0.7``, ``tweedie-nloglik@1.2``): the class
    is built as ``cls(arg, full_name=name)``."""
    def deco(cls):
        for n in names:
            _REGISTRY[n] = cls
        return cls
    return deco


class Metric:
    name: str = ""
    #: True for metrics where larger is better; early stopping reads it
    maximize: bool = False
    #: the learner's parameters, for metrics configured like the
    #: objective (``aft-nloglik``); set by the learner
    lparam = None
    #: set by a trailing ``-`` in the name (``create_metric``)
    minus: bool = False

    def evaluate(self, preds: torch.Tensor, label: torch.Tensor,
                 weight: Optional[torch.Tensor] = None, *,
                 label_lower: Optional[torch.Tensor] = None,
                 label_upper: Optional[torch.Tensor] = None,
                 groups=None) -> float:
        """The metric of ``preds``; ``groups`` is the matrix's
        ``QueryGroups`` (read by the ranking metrics and the grouped
        AUC)."""
        raise NotImplementedError


def weighted_sum(loss: torch.Tensor, weight: Optional[torch.Tensor]
                 ) -> Tuple[float, float]:
    """``(sum(w * loss), sum(w))`` in float64; unit weights when ``weight``
    is None or empty."""
    loss = loss.double()
    if weight is not None and weight.numel():
        w = weight.double()
        return float((loss * w).sum()), float(w.sum())
    return float(loss.sum()), float(loss.shape[0])


def dist_reduce(s: float, w: float) -> Tuple[float, float]:
    """A metric's (residue, weight) pair summed over every rank of an
    active row group (the JAX package's ``dist_reduce``): the pairs are
    gathered as float64 over the gloo group and summed in rank order on
    the host, so every rank finalises the same bits and early stopping
    stops at the same round everywhere. The identity unless
    ``parallel.collective_active()``: a rank evaluating outside a
    ``mesh_context`` never enters a gather the others do not."""
    from ..parallel.mesh import collective_active, current_mesh

    if not collective_active():
        return s, w
    from .. import collective

    arr = collective.process_allgather(np.asarray([s, w], np.float64),
                                       site="metric_reduce",
                                       mesh=current_mesh())
    s_all, w_all = 0.0, 0.0
    for rs, rw in arr:
        s_all += float(rs)
        w_all += float(rw)
    return s_all, w_all


class ElementwiseMetric(Metric):
    """sum(w * loss(pred, y)) / sum(w); losses in f32, sums in float64."""

    def loss(self, pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def finalize(self, s: float, w: float) -> float:
        # wsum == 0 returns the raw sum (elementwise_metric.cu GetFinal)
        return s if w == 0 else s / w

    def evaluate(self, preds, label, weight=None, **kw):
        if preds.dim() == 2 and preds.shape[1] == 1:
            preds = preds[:, 0]
        return self.finalize(*dist_reduce(
            *weighted_sum(self.loss(preds, label), weight)))


def create_metric(name: str) -> Metric:
    """The metric ``name``; ``base@arg`` builds the argument form of
    ``base``, and a trailing ``-`` (``ndcg-``, ``map@2-``) sets ``minus``:
    a ranking group without relevant rows then scores 0 instead of 1 (the
    JAX package's ``registry.create_metric``)."""
    minus = name.endswith("-")
    core = name[:-1] if minus else name
    m = None
    if "@" in core:
        base, _, arg = core.partition("@")
        cls = _REGISTRY.get(base + "@")
        if cls is not None:
            m = cls(arg, full_name=name)
    if m is None:
        cls = _REGISTRY.get(core)
        if cls is None:
            raise NotImplementedError(
                f"metric {name!r} is not ported yet; the port has "
                f"{sorted(_REGISTRY)}")
        m = cls()
        if not m.name:
            m.name = core
    if minus:
        m.name = name
        m.minus = True
    return m
