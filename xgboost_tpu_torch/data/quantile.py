"""Weighted quantile sketch -> HistogramCuts -> binned matrix.

The port of the JAX package's ``data/quantile.py`` (reference
``src/common/quantile.{h,cc}``, ``hist_util.h:38`` SearchBin). Each
feature's cuts come from a full sort plus a weighted-CDF selection; bins are
``#{cuts[f] <= x}`` clipped to ``[0, B)``, and missing (NaN) gets bin ``B``.

Canonical cuts: the JAX package computes the CDF as a STRICT left-to-right
f32 sum (a reassociating cumsum flips near-tie cuts), and its cuts and bins
are the contract. Here the CDF is exact in that order: with unit weights
every partial sum is an integer (exact in f32 up to 2^24 rows), so a
float64 cumsum rounded to f32 gives the same bits on either device; with
row weights the sequential f32 sum runs on the host
(``numpy.add.accumulate`` is strictly sequential in its dtype).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["HistogramCuts", "compute_cuts", "bin_matrix", "storage_dtype",
           "BinnedMatrix"]

_FLT_MAX = float(np.finfo(np.float32).max)
# unit-weight partial sums stay exact in f32 up to this many rows
_EXACT_ROWS = 1 << 24


@dataclasses.dataclass
class HistogramCuts:
    """Per-feature cut thresholds, padded to a uniform ``max_bin`` width.
    ``values[f, b]`` is the upper-exclusive threshold of bin ``b``;
    ``min_vals`` is kept for model dumps. Both are host numpy float32, so
    cuts carry across from the JAX package as they are."""

    values: np.ndarray  # [n_features, max_bin] float32
    min_vals: np.ndarray  # [n_features] float32

    def __post_init__(self):
        self.values = np.ascontiguousarray(self.values, np.float32)
        self.min_vals = np.ascontiguousarray(self.min_vals, np.float32)

    @property
    def max_bin(self) -> int:
        return int(self.values.shape[1])


def _sequential_cdf(sw: torch.Tensor, unit_weights: bool) -> torch.Tensor:
    """[F, n] f32 prefix sums along rows with strict left-to-right f32
    association."""
    if unit_weights and sw.shape[1] <= _EXACT_ROWS:
        return torch.cumsum(sw.double(), dim=1).float()
    host = np.add.accumulate(sw.cpu().numpy(), axis=1, dtype=np.float32)
    return torch.from_numpy(host).to(sw.device)


def compute_cuts(X: torch.Tensor, max_bin: int = 256,
                 weights: Optional[torch.Tensor] = None) -> HistogramCuts:
    """[n, F] f32 (NaN missing) -> cuts, on ``X``'s device (the port of
    ``_cuts_kernel``): ``max_bin - 1`` weighted quantiles at k/B of the
    total weight plus a strict-upper sentinel cut.

    One step leaves the device: with row weights, or with more than 2^24
    rows, the strict f32 prefix sum (``_sequential_cdf``) copies the sorted
    ``[F, n]`` weights to the host, accumulates them there and copies the
    result back. A parallel scan on the card would reassociate the sum and
    move near-tie cuts away from the JAX package's. Unit weights at up to
    2^24 rows (the main path) stay on the device."""
    n = X.shape[0]
    unit = weights is None or weights.numel() == 0
    if unit:
        weights = torch.ones(n, dtype=torch.float32, device=X.device)
    Xt = X.t()
    valid = ~torch.isnan(Xt)
    keys = torch.where(valid, Xt, torch.full_like(Xt, _FLT_MAX))
    svals, order = torch.sort(keys, dim=1, stable=True)  # NaN sorts last
    w = torch.where(valid, weights.to(torch.float32)[None, :],
                    torch.zeros_like(Xt))
    sw = torch.gather(w, 1, order)
    cdf = _sequential_cdf(sw, unit).contiguous()
    total = cdf[:, -1:]
    levels = (torch.arange(1, max_bin, dtype=torch.float32, device=X.device)
              / max_bin) * total  # [F, B-1]
    idx = torch.searchsorted(cdf, levels.contiguous(), side="left")
    idx = idx.clamp(0, n - 1)
    interior = torch.gather(svals, 1, idx)
    n_valid = valid.sum(dim=1)
    has = n_valid > 0
    last = torch.gather(svals, 1, (n_valid - 1).clamp(min=0)[:, None])[:, 0]
    zero = torch.zeros_like(last)
    max_val = torch.where(has, last, zero)
    min_val = torch.where(has, svals[:, 0], zero)
    sentinel = max_val + torch.clamp(torch.abs(max_val), min=1.0)
    interior = torch.where(has[:, None], interior, torch.zeros_like(interior))
    cuts = torch.cat([interior, sentinel[:, None]], dim=1)
    return HistogramCuts(values=cuts.cpu().numpy(), min_vals=min_val.cpu().numpy())


def storage_dtype(max_bin: int) -> torch.dtype:
    """Narrowest storage dtype for bin ids ``0..max_bin`` (reference:
    runtime-selected bin storage, ``hist_util.h:180``)."""
    if max_bin + 1 <= 255:
        return torch.uint8
    if max_bin + 1 <= 32767:
        return torch.int16
    return torch.int32


def bin_matrix(X: torch.Tensor, cuts: HistogramCuts) -> torch.Tensor:
    """[n, F] f32 -> [n, F] narrow-int bins on ``X``'s device:
    searchsorted-right, clipped to ``B - 1``, NaN -> ``B``."""
    B = cuts.max_bin
    cv = torch.as_tensor(cuts.values, device=X.device)
    Xt = X.t().contiguous()
    b = torch.searchsorted(cv, Xt, right=True).clamp(0, B - 1)
    b = torch.where(torch.isnan(Xt), torch.full_like(b, B), b)
    return b.t().to(storage_dtype(B)).contiguous()


@dataclasses.dataclass
class BinnedMatrix:
    """The quantized training matrix: dense [n_rows, n_features] narrow-int
    bin ids on the device, missing encoded as ``cuts.max_bin``, plus the
    cut values on the same device."""

    cuts: HistogramCuts
    bins: torch.Tensor
    cut_values: torch.Tensor  # [F, B] f32, on the bins' device

    @property
    def n_features(self) -> int:
        return int(self.bins.shape[1])

    @classmethod
    def from_dense(cls, X: torch.Tensor, max_bin: int = 256,
                   weights: Optional[torch.Tensor] = None,
                   cuts: Optional[HistogramCuts] = None) -> "BinnedMatrix":
        if cuts is None:
            cuts = compute_cuts(X, max_bin=max_bin, weights=weights)
        return cls(cuts=cuts, bins=bin_matrix(X, cuts),
                   cut_values=torch.as_tensor(cuts.values, device=X.device))
