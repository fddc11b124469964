"""The evaluation metrics the cells report, in float64.

- ``auc``: ``P(s_pos > s_neg) + P(s_pos = s_neg) / 2`` over the scores.
- ``logloss``: the mean of ``-(y log p + (1 - y) log(1 - p))``, ``p``
  clipped to ``[1e-7, 1 - 1e-7]`` in its own type.
- ``ndcg@k``: per query, the DCG of the top ``k`` rows by score (ties in
  row order), gain ``2^y - 1``, discount ``1 / log2(2 + rank)``, over the
  ideal DCG (1 where that is 0); the mean over the queries.
- ``map@k``: per query, the sum over the relevant rows (``y > 0``) in the
  top ``k`` of the share of relevant rows at or above them, over the
  query's count of relevant rows (1 where it has none); the mean.

Scores are the predictions the metric is given: probabilities
(``sigmoid`` of the margin, rounded to the margin's type) for the binary
metrics, margins for the ranking ones. The clip, too, is in the
predictions' type: in float32, 1 - 1e-7 is 1 - 2**-23, so a row whose
probability rounds to 1 against its label loses 23 log 2, not log 1e7.
"""

from __future__ import annotations

import torch

from .objective import _group_rows, _sort_in_groups

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


def logloss(p: torch.Tensor, y: torch.Tensor) -> float:
    q = torch.clamp(p, 1e-7, 1.0 - 1e-7).to(F64)
    yy = y.to(F64)
    return float((-(yy * torch.log(q) + (1.0 - yy) * torch.log(1.0 - q))).mean())


def _ranked(score, y, sizes):
    group_of, start, _ = _group_rows(sizes)
    ys = y.to(F64)[_sort_in_groups(-score.to(F64), group_of)]
    local = torch.arange(score.shape[0], device=score.device) - start
    return ys, local, group_of


def _per_query(x, group_of, G):
    return torch.zeros(G, dtype=F64, device=x.device).index_add_(0, group_of, x)


def ndcg(score, y, sizes, k: int) -> float:
    G = sizes.shape[0]
    ys, local, group_of = _ranked(score, y, sizes)
    top = (local < k).to(F64)
    disc = 1.0 / torch.log2(local.to(F64) + 2.0)
    dcg = _per_query((torch.pow(2.0, ys) - 1.0) * disc * top, group_of, G)
    ideal = ys[_sort_in_groups(-ys, group_of)]
    idcg = _per_query((torch.pow(2.0, ideal) - 1.0) * disc * top, group_of, G)
    s = torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-30), torch.ones_like(idcg))
    return float(s.mean())


def map_at(score, y, sizes, k: int) -> float:
    G = sizes.shape[0]
    ys, local, group_of = _ranked(score, y, sizes)
    rel = (ys > 0).to(F64)
    first = torch.arange(ys.shape[0], device=ys.device) - local
    cs = torch.cumsum(rel, 0)
    hits = cs - (cs - rel)[first]
    prec = torch.where(local < k, hits / (local.to(F64) + 1.0) * rel,
                       torch.zeros_like(hits))
    num, den = _per_query(prec, group_of, G), _per_query(rel, group_of, G)
    s = torch.where(den > 0, num / torch.clamp(den, min=1e-30), torch.ones_like(den))
    return float(s.mean())


def evaluate(name: str, margin: torch.Tensor, y: torch.Tensor, sizes) -> float:
    """Metric ``name`` of the margins ``margin`` [n]."""
    base, _, arg = name.partition("@")
    if base == "auc":
        return auc(torch.sigmoid(margin.to(F64)).to(margin.dtype), y)
    if base == "logloss":
        return logloss(torch.sigmoid(margin.to(F64)).to(margin.dtype), y)
    if base == "ndcg":
        return ndcg(margin, y, sizes, int(arg))
    if base == "map":
        return map_at(margin, y, sizes, int(arg))
    raise ValueError(f"the reference has no metric {name!r}")
