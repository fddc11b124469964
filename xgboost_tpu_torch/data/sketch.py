"""Fixed-size quantile summaries and their merge.

The port of ``_local_summary`` and ``_merge_summaries`` of the JAX
package's ``parallel/sketch.py`` (reference ``HostSketchContainer::
AllReduce``, quantile.cc:270), without the mesh: the streaming and
external-memory matrices (``iterator.py``, ``external.py``) summarize each
batch into ``S = OVERSAMPLE * max_bin`` weighted points per feature and
merge the batches' summaries into the cuts, as the JAX package merges
shards. The distributed sketch itself is not ported.

The prefix sums run in float64 and are rounded to float32 once. Where
every partial sum is exact in float32 (unit weights: integer counts, and
multiples of ``total / S``, dyadic for a power-of-two ``max_bin``, while
the numerators stay below 2^24), that is the JAX package's ``jnp.cumsum``
in any association, so the cuts match it bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["OVERSAMPLE", "local_summary", "merge_summaries"]

OVERSAMPLE = 8

_FLT_MAX = float(np.finfo(np.float32).max)


def _cdf(sw: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(sw.double(), dim=1).float()


def _per(total: torch.Tensor, div: int) -> torch.Tensor:
    """``total / div`` in float32 as XLA computes the JAX package's
    expression: the division by a constant folded into a product with its
    float32 reciprocal (for a power-of-two ``div``, the quotient
    exactly)."""
    return total * torch.tensor(1.0 / div, dtype=torch.float32,
                                device=total.device)


def _levels(count: int, div: int, total: torch.Tensor) -> torch.Tensor:
    """``arange(1, count+1) / div * total`` in float32 as XLA computes it:
    the division folded into the reciprocal and the product reassociated,
    ``k * (total * (1/div))``."""
    k = torch.arange(1, count + 1, dtype=torch.float32, device=total.device)
    return k * _per(total, div)


def local_summary(X: torch.Tensor, weights: Optional[torch.Tensor],
                  max_bin: int) -> Tuple[torch.Tensor, ...]:
    """[n, F] float32 (NaN missing) and row weights [n] (None: unit) ->
    ``(values [F, S], weights [F, S], max [F], min [F])`` on ``X``'s
    device (the JAX package's ``_local_summary``): the values at ``S``
    evenly spaced levels of each feature's weighted CDF, each carrying
    ``total / S``; a feature with no present value has zero weights and
    values, and 0 for its max and min."""
    S = OVERSAMPLE * max_bin
    n = X.shape[0]
    Xt = X.t()
    valid = ~torch.isnan(Xt)
    keys = torch.where(valid, Xt, torch.full_like(Xt, _FLT_MAX))
    svals, order = torch.sort(keys, dim=1, stable=True)
    if weights is None:
        w = valid.to(torch.float32)
    else:
        w = torch.where(valid, weights.to(torch.float32)[None, :],
                        torch.zeros_like(Xt))
    cdf = _cdf(torch.gather(w, 1, order)).contiguous()
    total = cdf[:, -1:]
    idx = torch.searchsorted(cdf, _levels(S, S, total).contiguous(),
                             side="left").clamp(0, n - 1)
    vals = torch.gather(svals, 1, idx)
    has = total > 0
    wts = torch.where(has, _per(total, S).expand(-1, S),
                      torch.zeros_like(vals))
    vals = torch.where(has, vals, torch.zeros_like(vals))
    n_valid = valid.sum(dim=1)
    some = n_valid > 0
    last = torch.gather(svals, 1, (n_valid - 1).clamp(min=0)[:, None])[:, 0]
    zero = torch.zeros_like(last)
    return (vals, wts, torch.where(some, last, zero),
            torch.where(some, svals[:, 0], zero))


def merge_summaries(vals: torch.Tensor, wts: torch.Tensor,
                    fmax: torch.Tensor, fmin: torch.Tensor,
                    max_bin: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked summaries ``[D, F, S]`` (and ``[D, F]`` maxima and minima)
    -> ``(cuts [F, max_bin], min_vals [F])`` (the JAX package's
    ``_merge_summaries``): ``max_bin - 1`` levels of the merged weighted
    CDF plus the sentinel ``max + max(1, |max|)``. The max and min are
    taken over every summary, empty ones' zeros included, as the JAX
    package takes them."""
    D, F, S = vals.shape
    v = vals.permute(1, 0, 2).reshape(F, D * S)
    w = wts.permute(1, 0, 2).reshape(F, D * S)
    sv, order = torch.sort(v, dim=1, stable=True)
    cdf = _cdf(torch.gather(w, 1, order)).contiguous()
    total = cdf[:, -1:]
    idx = torch.searchsorted(cdf, _levels(max_bin - 1, max_bin,
                                          total).contiguous(),
                             side="left").clamp(0, D * S - 1)
    interior = torch.gather(sv, 1, idx)
    gmax = fmax.amax(dim=0)
    seen = (wts.sum(dim=2) > 0).any(dim=0)
    gmin = torch.where(seen, fmin.amin(dim=0), torch.zeros_like(gmax))
    sentinel = gmax + torch.clamp(torch.abs(gmax), min=1.0)
    interior = torch.where(total > 0, interior, torch.zeros_like(interior))
    return torch.cat([interior, sentinel[:, None]], dim=1), gmin
