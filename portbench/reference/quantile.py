"""Histogram cuts and bins, worked out from the raw feature values.

Each feature's cuts are ``max_bin - 1`` quantiles of its present values
and a sentinel above its largest value (the reference's hist sketch with
unit weights, ``src/common/quantile.cc``; one full sort a feature, since
the cells fit on the card). The quantile at level ``k`` is the smallest
sorted value whose rank reaches ``(k * float32(1/max_bin)) * m`` in
float32, ``m`` the feature's count of present values. A value's bin is
the number of cuts at or below it, at most ``max_bin - 1``; a missing
value (NaN) takes bin ``max_bin``.
"""

from __future__ import annotations

import torch


def cuts(X: torch.Tensor, max_bin: int, block: int = 8):
    """``(values [F, max_bin], min_vals [F])`` float32 for ``X`` [n, F]
    (NaN missing), sorted a few features at a time on ``X``'s device."""
    n, F = X.shape
    dev = X.device
    values = torch.zeros((F, max_bin), dtype=torch.float32, device=dev)
    mins = torch.zeros(F, dtype=torch.float32, device=dev)
    k = torch.arange(1, max_bin, dtype=torch.float32, device=dev)
    step = k * torch.tensor(1.0 / max_bin, dtype=torch.float32, device=dev)
    for f0 in range(0, F, block):
        cols = X[:, f0:f0 + block].t().to(torch.float32)
        valid = ~torch.isnan(cols)
        m = valid.sum(dim=1)
        s = torch.sort(torch.where(valid, cols, torch.full_like(cols, float("inf"))),
                       dim=1).values
        level = step[None, :] * m.to(torch.float32)[:, None]
        idx = (torch.ceil(level).long() - 1).clamp(0, max(n - 1, 0))
        interior = torch.gather(s, 1, idx)
        has = m > 0
        top = torch.gather(s, 1, (m - 1).clamp(min=0)[:, None])[:, 0]
        top = torch.where(has, top, torch.zeros_like(top))
        sentinel = top + torch.clamp(torch.abs(top), min=1.0)
        interior = torch.where(has[:, None], interior, torch.zeros_like(interior))
        values[f0:f0 + block] = torch.cat([interior, sentinel[:, None]], dim=1)
        mins[f0:f0 + block] = torch.where(has, s[:, 0], torch.zeros_like(top))
    return values, mins


def bins(X: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``[n, F]`` int16 bins of ``X`` against ``values`` [F, B]."""
    B = values.shape[1]
    xt = X.t().contiguous().to(torch.float32)
    b = torch.searchsorted(values.contiguous(), xt, right=True).clamp(max=B - 1)
    b = torch.where(torch.isnan(xt), torch.full_like(b, B), b)
    return b.t().to(torch.int16)
