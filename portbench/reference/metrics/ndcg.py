"""``ndcg@k`` of one output: per query, the DCG of the top ``k`` rows by
margin (ties in row order), gain ``2^y - 1``, discount
``1 / log2(2 + rank)``, over the ideal DCG (1 where that is 0); the mean
over the queries, in float64."""

from __future__ import annotations

import torch

from portbench.reference.queries import per_query, ranked, sort_in_groups

F64 = torch.float64


def ndcg(score, y, sizes, k: int) -> float:
    Q = sizes.shape[0]
    ys, local, group_of = ranked(score, y, sizes)
    top = (local < k).to(F64)
    disc = 1.0 / torch.log2(local.to(F64) + 2.0)
    dcg = per_query((torch.pow(2.0, ys) - 1.0) * disc * top, group_of, Q)
    ideal = ys[sort_in_groups(-ys, group_of)]
    idcg = per_query((torch.pow(2.0, ideal) - 1.0) * disc * top, group_of, Q)
    s = torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-30), torch.ones_like(idcg))
    return float(s.mean())


def evaluate(margin: torch.Tensor, y: torch.Tensor, sizes, arg) -> float:
    return ndcg(margin[:, 0], y, sizes, int(arg))
