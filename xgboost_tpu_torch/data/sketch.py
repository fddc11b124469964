"""Fixed-size quantile summaries and their merge.

The port of ``_local_summary`` and ``_merge_summaries`` of the JAX
package's ``parallel/sketch.py`` (reference ``HostSketchContainer::
AllReduce``, quantile.cc:270), without the mesh: the streaming and
external-memory matrices (``iterator.py``, ``external.py``) summarize each
batch into ``S = OVERSAMPLE * max_bin`` weighted points per feature and
merge the batches' summaries into the cuts, as the JAX package merges
shards; ``parallel/sketch.py`` merges the ranks' summaries the same way.

The prefix sums are float32 sums in the association of the JAX
package's ``jnp.cumsum`` as XLA:CPU runs it (its reduce-window rewrite):
sequential within blocks of 16, the blocks' totals scanned the same way
recursively, and each block's exclusive prefix added once. So the cuts
match the JAX package bit for bit with any weights, not only where every
partial sum is exact in float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["OVERSAMPLE", "local_summary", "merge_summaries"]

OVERSAMPLE = 8

_FLT_MAX = float(np.finfo(np.float32).max)


#: the block length of XLA:CPU's cumulative-sum rewrite
_SCAN_BLOCK = 16


def _sequential(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 prefix sums along the last dim (torch's own
    cumsum accumulates in double on the CPU and in parallel on the
    card)."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def _cdf(sw: torch.Tensor) -> torch.Tensor:
    """[F, n] float32 prefix sums along dim 1, associated as XLA:CPU
    associates ``jnp.cumsum`` (see the module docstring)."""
    sw = sw.to(torch.float32)
    F, n = sw.shape
    if n <= _SCAN_BLOCK:
        return _sequential(sw) if n else sw
    blocks = torch.nn.functional.pad(sw, (0, -n % _SCAN_BLOCK)).reshape(
        F, -1, _SCAN_BLOCK)
    inner = _sequential(blocks)
    prefix = _cdf(inner[:, :, -1])
    before = torch.cat([torch.zeros_like(prefix[:, :1]), prefix[:, :-1]],
                       dim=1)
    return (inner + before[:, :, None]).reshape(F, -1)[:, :n]


def _per(total: torch.Tensor, div: int) -> torch.Tensor:
    """``total / div`` in float32 as XLA computes the JAX package's
    expression: the division by a constant folded into a product with its
    float32 reciprocal (for a power-of-two ``div``, the quotient
    exactly)."""
    return total * torch.tensor(1.0 / div, dtype=torch.float32,
                                device=total.device)


def _levels(count: int, div: int, total: torch.Tensor) -> torch.Tensor:
    """``arange(1, count+1) / div * total`` in float32 as XLA computes it:
    the division folded into a product with the float32 reciprocal,
    ``(k * (1/div)) * total``."""
    k = torch.arange(1, count + 1, dtype=torch.float32, device=total.device)
    return (k * torch.tensor(1.0 / div, dtype=torch.float32,
                             device=total.device)) * total


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
