"""Binary ROC AUC (reference ``src/metric/auc.cc``; the JAX package's
``metric/auc.py``): sort by score, build tie blocks from score boundaries,
and compute P(s_pos > s_neg) + 0.5 P(=) from weighted block sums. The sums
run in float64."""

from __future__ import annotations

from typing import Optional

import torch

from .base import Metric, register

__all__ = ["AUC"]


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


@register("auc")
class AUC(Metric):
    name = "auc"

    def evaluate(self, preds, label, weight: Optional[torch.Tensor] = None):
        if preds.dim() == 2:
            if preds.shape[1] > 1:
                raise NotImplementedError("multiclass AUC is not ported yet")
            preds = preds[:, 0]
        n = label.shape[0]
        w = (weight if weight is not None and weight.numel() == n
             else torch.ones(n, dtype=torch.float32, device=label.device))
        return _binary_auc(preds, label, w)
