"""``auc`` of one output: ``P(s_pos > s_neg) + P(s_pos = s_neg) / 2`` over
the scores, in float64. The scores are the probabilities the metric is
given: ``sigmoid`` of the margin, rounded to the margin's type."""

from __future__ import annotations

import torch

F64 = torch.float64


def auc(score: torch.Tensor, y: torch.Tensor) -> float:
    n = score.shape[0]
    order = torch.argsort(score, stable=True)
    s, yy = score[order], y[order].to(F64)
    new = torch.ones(n, dtype=torch.bool, device=score.device)
    new[1:] = s[1:] != s[:-1]
    blk = torch.cumsum(new.long(), 0) - 1
    neg = torch.zeros(n, dtype=F64, device=score.device).index_add_(0, blk, 1.0 - yy)
    below = torch.cumsum(neg, 0) - neg
    num = (yy * (below[blk] + 0.5 * neg[blk])).sum()
    P = float(yy.sum())
    return float(num) / (P * (n - P))


def evaluate(margin: torch.Tensor, y: torch.Tensor, sizes, arg) -> float:
    m = margin[:, 0]
    return auc(torch.sigmoid(m.to(F64)).to(m.dtype), y)
