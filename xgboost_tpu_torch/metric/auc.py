"""ROC AUC and AUC-PR (reference ``src/metric/auc.cc``; the JAX package's
``metric/auc.py``). ROC AUC sorts by score, builds tie blocks from score
boundaries and computes P(s_pos > s_neg) + 0.5 P(=) from weighted block
sums; K classes give the plain mean of the K one-vs-rest AUCs, as the JAX
package computes it; with query groups, the mean of the per-group AUCs of
``label > 0`` over the groups that hold both classes. AUC-PR walks the
scores in descending order and evaluates precision and recall at the ends
of tie blocks. Sums run in float64, on the predictions' device. Under an
active row group of several ranks ROC AUC and AUC-PR are the weighted
mean of the ranks' own values (each rank's ``(auc * w, w)`` summed by
``dist_reduce``; a rank whose value is NaN adds ``(0, 0)``), as the JAX
package and the reference's distributed AUC compute them (auc.cc:293),
and the grouped AUC is every rank's sum of group AUCs over every rank's
count of valid groups."""

from __future__ import annotations

from typing import Optional

import torch

from .base import Metric, dist_reduce, register

__all__ = ["AUC", "AUCPR"]


def _weights(label: torch.Tensor, weight: Optional[torch.Tensor]
             ) -> torch.Tensor:
    n = label.shape[0]
    if weight is not None and weight.numel() == n:
        return weight
    return torch.ones(n, dtype=torch.float32, device=label.device)


def _dist_mean(local: float, local_w: float) -> float:
    """The weighted mean of the ranks' values (``local`` itself without a
    row group); NaN locals drop out."""
    from ..parallel.mesh import collective_active

    if not collective_active():
        return local
    if local != local:
        local, local_w = 0.0, 0.0
    s, w = dist_reduce(local * local_w, local_w)
    return s / w if w > 0 else float("nan")


def _binary_auc(score: torch.Tensor, label: torch.Tensor,
                weight: torch.Tensor) -> float:
    n = score.shape[0]
    order = torch.argsort(score, stable=True)
    s = score[order]
    y = label[order].double()
    w = weight[order].double()
    wp = w * y
    wn = w * (1.0 - y)
    newblk = torch.ones(n, dtype=torch.bool, device=score.device)
    newblk[1:] = s[1:] != s[:-1]
    seg = torch.cumsum(newblk.long(), dim=0) - 1  # block id per row
    blk_wn = torch.zeros(n, dtype=torch.float64, device=score.device)
    blk_wn.index_add_(0, seg, wn)
    cum = torch.cumsum(blk_wn, dim=0) - blk_wn  # neg weight strictly below
    num = (wp * (cum[seg] + 0.5 * blk_wn[seg])).sum()
    Wp, Wn = float(wp.sum()), float(wn.sum())
    if Wp <= 0 or Wn <= 0:
        return float("nan")
    return float(num) / (Wp * Wn)


def _grouped_auc(score: torch.Tensor, label: torch.Tensor,
                 weight: torch.Tensor, groups):
    """``(sum, count)`` of the per-group ROC AUCs over the groups that hold
    both classes (the JAX package's ``_grouped_auc``): one sort by (group,
    score), tie blocks that stop at group boundaries, and ``_binary_auc``'s
    block sums per group."""
    n, G = score.shape[0], groups.n_groups
    dev = score.device
    order = groups.argsort(score)
    g, s = groups.rows()[0][order], score[order]
    y, w = label[order].double(), weight[order].double()
    wp, wn = w * y, w * (1.0 - y)
    newblk = torch.ones(n, dtype=torch.bool, device=dev)
    newblk[1:] = (s[1:] != s[:-1]) | (g[1:] != g[:-1])
    seg = torch.cumsum(newblk.long(), dim=0) - 1
    blk_wn = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, seg, wn)
    cum_blk = (torch.cumsum(blk_wn, dim=0) - blk_wn)[seg]
    per_group = torch.zeros(3, G, dtype=torch.float64, device=dev)
    per_group[0].index_add_(0, g, wn)
    Wn_g = per_group[0]
    below = cum_blk - (torch.cumsum(Wn_g, dim=0) - Wn_g)[g]  # in-group
    per_group[1].index_add_(0, g, wp * (below + 0.5 * blk_wn[seg]))
    per_group[2].index_add_(0, g, wp)
    num_g, Wp_g = per_group[1], per_group[2]
    valid = (Wp_g > 0) & (Wn_g > 0)
    auc_g = num_g / torch.clamp(Wp_g * Wn_g, min=1e-30)
    return (float(torch.where(valid, auc_g, torch.zeros_like(auc_g)).sum()),
            int(valid.sum()))


@register("auc")
class AUC(Metric):
    name = "auc"
    maximize = True

    def evaluate(self, preds, label, weight=None, *, groups=None, **kw):
        w = _weights(label, weight)
        total = float(w.double().sum())
        if preds.dim() == 2 and preds.shape[1] > 1:
            # one-vs-rest per class, then the unweighted mean (the JAX
            # package's; NaN when some class has no rows or all of them)
            aucs = [_binary_auc(preds[:, k], (label == k).to(torch.float32), w)
                    for k in range(preds.shape[1])]
            return _dist_mean(float(sum(aucs) / len(aucs)), total)
        if preds.dim() == 2:
            preds = preds[:, 0]
        if groups is not None and groups.n_groups > 1:
            # ranking: relevant (label > 0) against not, within each query
            groups.check_rows(preds.shape[0])
            s, c = dist_reduce(*_grouped_auc(
                preds, (label > 0).to(torch.float32), w, groups))
            return s / c if c > 0 else float("nan")
        return _dist_mean(_binary_auc(preds, label, w), total)


@register("aucpr")
class AUCPR(Metric):
    name = "aucpr"
    maximize = True

    def evaluate(self, preds, label, weight=None, **kw):
        p = preds.reshape(-1).double()
        y = label.double()
        if p.shape[0] != y.shape[0]:
            # the JAX package flattens K-class scores, and its label no
            # longer lines up (numpy raises there)
            raise ValueError("aucpr takes one score per row; K-class "
                             "predictions are not supported")
        w = _weights(label, weight).double()
        return _dist_mean(self._local(p, y, w), float(w.sum()))

    @staticmethod
    def _local(p: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> float:
        if y.shape[0] == 0:
            return float("nan")
        order = torch.argsort(-p, stable=True)
        y, w, p = y[order], w[order], p[order]
        tp = torch.cumsum(w * y, 0)
        fp = torch.cumsum(w * (1.0 - y), 0)
        total_pos = float(tp[-1])
        if total_pos <= 0 or float(w.sum()) <= 0:
            return float("nan")
        ends = torch.ones_like(p, dtype=torch.bool)
        ends[:-1] = p[1:] != p[:-1]
        tp_e, fp_e = tp[ends], fp[ends]
        recall = tp_e / total_pos
        precision = tp_e / torch.clamp(tp_e + fp_e, min=1e-30)
        prev_r = torch.cat([recall.new_zeros(1), recall[:-1]])
        return float(((recall - prev_r) * precision).sum())
