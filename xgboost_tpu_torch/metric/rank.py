"""Ranking metrics: ``ndcg``, ``map``, ``pre`` (each also ``@n`` and with
a trailing ``-``) and ``ams@ratio`` (the port of the JAX package's
``metric/rank.py``; reference ``src/metric/rank_metric.cc``).

The per-group metrics take one stable sort by (group, -score) and score
every group in that segmented layout; the result is the mean over
non-empty groups. They run on the predictions' device with float64 sums
and ignore weights, as the JAX package's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..data.dmatrix import QueryGroups
from .base import Metric, dist_reduce, register

__all__ = ["NDCG", "MAP", "PrecisionAt", "AMS"]

F64 = torch.float64


def _segmented_layout(p: torch.Tensor, y: torch.Tensor,
                      groups: QueryGroups):
    """``(ys, local)``: the labels sorted by (group, -score), ties in row
    order (groups keep their rows' positions), and each position's 0-based
    rank in its group."""
    start = groups.rows()[1]
    local = torch.arange(p.shape[0], device=p.device) - start
    return y[groups.argsort(-p)], local


def _per_group(x: torch.Tensor, groups: QueryGroups) -> torch.Tensor:
    return torch.zeros(groups.n_groups, dtype=F64,
                       device=x.device).index_add_(0, groups.rows()[0], x)


class _PerGroupMetric(Metric):
    maximize = True

    def __init__(self, arg: str = "", full_name: str = ""):
        self.topn = int(arg) if arg else 0
        if full_name:
            self.name = full_name

    def group_scores(self, ys, groups, local, k) -> torch.Tensor:
        """Per-group scores of the labels ``ys`` in the segmented layout
        (``local``: each position's rank in its group) at top ``k``."""
        raise NotImplementedError

    def evaluate(self, preds, label, weight=None, *, groups=None, **kw):
        p = preds.reshape(-1)
        if groups is None:
            groups = QueryGroups(np.array([0, p.shape[0]]), p.device)
        groups.check_rows(p.shape[0])
        ys, local = _segmented_layout(p, label.to(F64), groups)
        sizes = groups.sizes
        k = self.topn if self.topn > 0 else int(sizes.max(initial=0))
        scores = self.group_scores(ys, groups, local, k)
        scores = scores[torch.as_tensor(sizes > 0, device=p.device)]
        # under a row group: every rank's score sum over every rank's
        # group count (rank_metric.cc GetFinal)
        s, c = dist_reduce(float(scores.sum()), float(scores.numel()))
        return s / c if c > 0 else float("nan")

    def _empty_score(self) -> float:
        return 0.0 if self.minus else 1.0


@register("ndcg@", "ndcg")
class NDCG(_PerGroupMetric):
    name = "ndcg"

    def group_scores(self, ys, groups, local, k):
        disc = 1.0 / torch.log2(local.to(F64) + 2.0)
        top = (local < k).to(F64)
        dcg = _per_group((torch.pow(2.0, ys) - 1.0) * disc * top, groups)
        yi = ys[groups.argsort(-ys)]  # the ideal order
        idcg = _per_group((torch.pow(2.0, yi) - 1.0) * disc * top, groups)
        return torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-30),
                           torch.full_like(idcg, self._empty_score()))


@register("map@", "map")
class MAP(_PerGroupMetric):
    name = "map"

    def group_scores(self, ys, groups, local, k):
        rel = (ys > 0).long()
        cs = torch.cumsum(rel, 0)
        first = torch.arange(ys.shape[0], device=ys.device) - local
        hits = (cs - (cs - rel)[first]).to(F64)  # relevant rows at or above
        relf = rel.to(F64)
        prec = torch.where(local < k, hits / (local.to(F64) + 1.0) * relf,
                           torch.zeros_like(hits))
        num = _per_group(prec, groups)
        # divided by the group's relevant rows, not those in the top n
        # (rank_metric.cc:321-330)
        den = _per_group(relf, groups)
        return torch.where(den > 0, num / torch.clamp(den, min=1e-30),
                           torch.full_like(den, self._empty_score()))


@register("pre@", "pre")
class PrecisionAt(_PerGroupMetric):
    name = "pre"

    def group_scores(self, ys, groups, local, k):
        hits = _per_group(((ys > 0) & (local < k)).to(F64), groups)
        if self.topn > 0:  # pre@n divides by n
            # a tensor divisor: the card rounds a quotient by a number
            # as a product by its reciprocal
            return hits / torch.full_like(hits, max(k, 1))
        # bare "pre": the precision over the whole group
        sizes = torch.as_tensor(groups.sizes, device=ys.device)
        return hits / torch.clamp(sizes, min=1).to(F64)


@register("ams@")
class AMS(Metric):
    """Approximate median significance of the top ``ratio`` of the rows by
    score (rank_metric.cc); one score over all rows, weighted."""

    maximize = True

    def __init__(self, arg: str = "0.15", full_name: str = ""):
        self.ratio = float(arg)
        self.name = full_name or f"ams@{arg}"

    def evaluate(self, preds, label, weight=None, **kw):
        from ..parallel.mesh import collective_active

        if collective_active():
            # the global top-ratio cut cannot be formed from local sorts;
            # the reference refuses too (rank_metric.cc:107)
            raise ValueError(
                "metric AMS does not support distributed evaluation")
        p = preds.reshape(-1)
        n = label.shape[0]
        w = (weight.to(F64) if weight is not None and weight.numel() == n
             else torch.ones(n, dtype=F64, device=p.device))
        top = torch.argsort(-p, stable=True)[:int(self.ratio * n)]
        signal = label[top] > 0.5
        s = float((w[top] * signal).sum())
        b = float((w[top] * ~signal).sum())
        br = 10.0
        if b + br <= 0:
            return 0.0
        return math.sqrt(max(0.0, 2.0 * ((s + b + br)
                                         * math.log(1.0 + s / (b + br)) - s)))
