"""Gradients of the two objectives the cells train, in float64.

``binary:logistic``: ``p = sigmoid(margin)``, ``g = p - y``,
``h = max(p (1 - p), 1e-16)``.

``rank:ndcg`` (LambdaMART, Burges 2010, with the reference's sampled
pairs, ``src/objective/rank_obj.cu``): every row draws
``n_pair`` opponents uniformly from its own query, from the threefry
stream keyed by ``(round * 2654435761) & 0x7FFFFFFF`` (the copy in
``threefry.py``), the draw's index formed as ``floor(u * size)`` in
float32. A pair of different grades is weighed by
``|2^y_i - 2^y_j| * |1/log2(2 + r_i) - 1/log2(2 + r_j)| / IDCG`` (ranks
``r`` by the current margins, ties in row order) and by the sampler's
expectation ``size * (1/opp_i + 1/opp_j) / (2 n_pair)``, ``opp`` a row's
count of other-grade rows in its query; ``rho = sigmoid(-(s_hi - s_lo))``;
the higher-graded end gains ``-rho w``, the other ``+rho w``, and both
ends the hessian ``max(2 rho (1 - rho), 1e-16) w``.
"""

from __future__ import annotations

import math

import torch

from . import threefry

F64 = torch.float64


def logistic(margin: torch.Tensor, y: torch.Tensor):
    p = torch.sigmoid(margin.to(F64))
    return p - y.to(F64), torch.clamp(p * (1.0 - p), min=1e-16)


def _group_rows(sizes: torch.Tensor):
    """``(group_of, start, size)`` per row for query ``sizes`` [G]."""
    G = sizes.shape[0]
    group_of = torch.repeat_interleave(torch.arange(G, device=sizes.device),
                                       sizes)
    starts = torch.cumsum(sizes, 0) - sizes
    return group_of, starts[group_of], sizes[group_of]


def _sort_in_groups(key: torch.Tensor, group_of: torch.Tensor) -> torch.Tensor:
    """Rows ordered by (group, key), ties in row order."""
    o = torch.argsort(key, stable=True)
    return o[torch.argsort(group_of[o], stable=True)]


def _inverse(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return inv


def ndcg(margin: torch.Tensor, y: torch.Tensor, sizes: torch.Tensor,
         iteration: int, n_pair: int = 1):
    n = margin.shape[0]
    dev = margin.device
    group_of, start, size = _group_rows(sizes)
    m, yy = margin.to(F64), y.to(F64)
    rank = _inverse(_sort_in_groups(-m, group_of)) - start
    gains = torch.pow(2.0, yy) - 1.0
    disc = 1.0 / torch.log2(rank.to(F64) + 2.0)
    irank = _inverse(_sort_in_groups(-yy, group_of)) - start
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


def base_margin(objective: str, base_score: float = 0.5) -> float:
    """The margin every row starts from: the logit of ``base_score`` for
    ``binary:logistic``, ``base_score`` itself otherwise."""
    if objective == "binary:logistic":
        return math.log(base_score / (1.0 - base_score))
    return base_score


def gradient(objective: str, margin, y, sizes, iteration: int, n_pair: int = 1):
    if objective == "binary:logistic":
        return logistic(margin, y)
    if objective == "rank:ndcg":
        return ndcg(margin, y, sizes, iteration, n_pair)
    raise ValueError(f"the reference has no objective {objective!r}")
