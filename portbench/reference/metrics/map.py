"""``map@k`` of one output: per query, the sum over the relevant rows
(``y > 0``) in the top ``k`` by margin of the share of relevant rows at or
above them, over the query's count of relevant rows (1 where it has
none); the mean over the queries, in float64."""

from __future__ import annotations

import torch

from portbench.reference.queries import per_query, ranked

F64 = torch.float64


def map_at(score, y, sizes, k: int) -> float:
    Q = sizes.shape[0]
    ys, local, group_of = ranked(score, y, sizes)
    rel = (ys > 0).to(F64)
    first = torch.arange(ys.shape[0], device=ys.device) - local
    cs = torch.cumsum(rel, 0)
    hits = cs - (cs - rel)[first]
    prec = torch.where(local < k, hits / (local.to(F64) + 1.0) * rel,
                       torch.zeros_like(hits))
    num, den = per_query(prec, group_of, Q), per_query(rel, group_of, Q)
    s = torch.where(den > 0, num / torch.clamp(den, min=1e-30), torch.ones_like(den))
    return float(s.mean())


def evaluate(margin: torch.Tensor, y: torch.Tensor, sizes, arg) -> float:
    return map_at(margin[:, 0], y, sizes, int(arg))
