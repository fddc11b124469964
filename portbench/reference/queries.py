"""Rows in queries, for the ranking objectives and metrics: each row's
query, and orders inside the queries."""

from __future__ import annotations

import torch


def group_rows(sizes: torch.Tensor):
    """``(group_of, start, size)`` per row for query ``sizes`` [Q]."""
    Q = sizes.shape[0]
    group_of = torch.repeat_interleave(torch.arange(Q, device=sizes.device),
                                       sizes)
    starts = torch.cumsum(sizes, 0) - sizes
    return group_of, starts[group_of], sizes[group_of]


def sort_in_groups(key: torch.Tensor, group_of: torch.Tensor) -> torch.Tensor:
    """Rows ordered by (group, key), ties in row order."""
    o = torch.argsort(key, stable=True)
    return o[torch.argsort(group_of[o], stable=True)]


def inverse(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return inv


def ranked(score: torch.Tensor, y: torch.Tensor, sizes: torch.Tensor):
    """``(labels in score order inside each query, each place's rank in
    its query, its query)``, float64 labels, ties in row order."""
    group_of, start, _ = group_rows(sizes)
    ys = y.to(torch.float64)[sort_in_groups(-score.to(torch.float64), group_of)]
    local = torch.arange(score.shape[0], device=score.device) - start
    return ys, local, group_of


def per_query(x: torch.Tensor, group_of: torch.Tensor, Q: int) -> torch.Tensor:
    """``[Q]`` float64 sums of ``x`` by query."""
    return torch.zeros(Q, dtype=torch.float64, device=x.device).index_add_(0, group_of, x)
