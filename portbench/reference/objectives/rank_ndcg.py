"""``rank:ndcg``: one output; LambdaMART (Burges 2010) with the
reference's sampled pairs (``src/objective/rank_obj.cu``), in float64.

Every row draws ``n_pair`` opponents uniformly from its own query, from
the threefry stream keyed by ``(round * 2654435761) & 0x7FFFFFFF`` (the
copy in ``reference/threefry.py``), the draw's index formed as
``floor(u * size)`` in float32. A pair of different grades is weighed by
``|2^y_i - 2^y_j| * |1/log2(2 + r_i) - 1/log2(2 + r_j)| / IDCG`` (ranks
``r`` by the current margins, ties in row order) and by the sampler's
expectation ``size * (1/opp_i + 1/opp_j) / (2 n_pair)``, ``opp`` a row's
count of other-grade rows in its query; ``rho = sigmoid(-(s_hi - s_lo))``;
the higher-graded end gains ``-rho w``, the other ``+rho w``, and both
ends the hessian ``max(2 rho (1 - rho), 1e-16) w``. Rows start from
``base_score`` (0.5 unless the configuration sets it).
"""

from __future__ import annotations

import torch

from portbench.reference import threefry
from portbench.reference.queries import group_rows, inverse, sort_in_groups
from portbench.work import Work

F64 = torch.float64


def outputs(params: dict) -> int:
    return 1


def base_margin(params: dict) -> float:
    return float(params.get("base_score", 0.5))


def ndcg(margin: torch.Tensor, y: torch.Tensor, sizes: torch.Tensor,
         iteration: int, n_pair: int = 1):
    n = margin.shape[0]
    dev = margin.device
    group_of, start, size = group_rows(sizes)
    m, yy = margin.to(F64), y.to(F64)
    rank = inverse(sort_in_groups(-m, group_of)) - start
    gains = torch.pow(2.0, yy) - 1.0
    disc = 1.0 / torch.log2(rank.to(F64) + 2.0)
    irank = inverse(sort_in_groups(-yy, group_of)) - start
    idcg = torch.zeros(sizes.shape[0], dtype=F64, device=dev).index_add_(
        0, group_of, gains / torch.log2(irank.to(F64) + 2.0))
    idcg = torch.clamp(idcg, min=1e-10)[group_of]

    u = threefry.uniform((iteration * 2654435761) & 0x7FFFFFFF, n, n_pair, dev)
    j_local = torch.minimum((u * size[:, None].to(torch.float32)).long(),
                            size[:, None] - 1)
    j = start[:, None] + j_local
    valid = yy[:, None] != yy[j]

    grade = y.long()
    cell = group_of * 64 + grade
    same = torch.bincount(cell, minlength=int(sizes.shape[0]) * 64)[cell]
    end_w = 1.0 / torch.clamp((size - same).to(F64), min=1.0)
    samp_w = size.to(F64)[:, None] * (end_w[:, None] + end_w[j]) / (2.0 * n_pair)

    hi = yy[:, None] > yy[j]
    s_hi = torch.where(hi, m[:, None], m[j])
    s_lo = torch.where(hi, m[j], m[:, None])
    rho = torch.sigmoid(-(s_hi - s_lo))
    delta = (torch.abs(gains[:, None] - gains[j])
             * torch.abs(disc[:, None] - disc[j]) / idcg[:, None])
    w = torch.where(valid, delta, torch.zeros_like(delta)) * samp_w
    lam = rho * w
    hes = torch.clamp(2.0 * rho * (1.0 - rho), min=1e-16) * w
    sign = torch.where(hi, -1.0, 1.0).to(F64)
    own = torch.arange(n, device=dev)[:, None].expand_as(j)
    grad = torch.zeros(n, dtype=F64, device=dev)
    grad.index_add_(0, own.reshape(-1), (sign * lam).reshape(-1))
    grad.index_add_(0, j.reshape(-1), (-sign * lam).reshape(-1))
    hess = torch.zeros(n, dtype=F64, device=dev)
    hess.index_add_(0, own.reshape(-1), hes.reshape(-1))
    hess.index_add_(0, j.reshape(-1), hes.reshape(-1))
    return grad, torch.clamp(hess, min=1e-16)


def gradient(margin: torch.Tensor, y: torch.Tensor, sizes, iteration: int):
    """``(g, h)`` [n, 1] float64 at the margins ``margin`` [n, 1], one
    opponent a row (the configuration's ``lambdarank_num_pair_per_sample``)."""
    g, h = ndcg(margin[:, 0], y, sizes, iteration)
    return g[:, None], h[:, None]


def work(n: int, groups: int, n_pair: int = 1) -> Work:
    """Reads a row's margin, label and query (12 bytes) and each drawn
    opponent's (12 bytes a pair), writes (g, h); 10 operations a row and
    30 a pair."""
    return Work(n * (12 + 12 * n_pair + 8), n * (10 + 30 * n_pair))
