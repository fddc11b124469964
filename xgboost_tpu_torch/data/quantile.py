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
import hashlib
import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..observability import flight, trace
from ..resilience import chaos
from ..tree.hist_kernel import (build_onehot, feature_major, hoist_plan,
                                hoist_plan_synced, onehot_rows)
from .sketch import _levels

__all__ = ["HistogramCuts", "compute_cuts", "compute_exact_cuts",
           "bin_matrix", "storage_dtype", "BinnedMatrix",
           "apply_categorical_identity"]

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

    def digest(self) -> int:
        """A signed 64-bit hash of the thresholds and minima, by which ranks
        check that they bin against the same cuts."""
        h = hashlib.blake2b(self.values.tobytes(), digest_size=8)
        h.update(self.min_vals.tobytes())
        return int.from_bytes(h.digest(), "little", signed=True)


def apply_categorical_identity(values: np.ndarray, min_vals: np.ndarray,
                               categorical: Sequence[int]) -> None:
    """Overwrite categorical features' cuts with the identity thresholds
    ``[1..max_bin]``, so category code ``c`` lands in bin ``c``: one bin per
    category (reference ``hist_util.cc`` AddCutPoint, categorical path)."""
    ident = np.arange(1, values.shape[1] + 1, dtype=np.float32)
    for f in categorical:
        values[f] = ident
        min_vals[f] = 0.0


def _sequential_cdf(sw: torch.Tensor, unit_weights: bool) -> torch.Tensor:
    """[F, n] f32 prefix sums along rows with strict left-to-right f32
    association."""
    if unit_weights and sw.shape[1] <= _EXACT_ROWS:
        return torch.cumsum(sw.double(), dim=1).float()
    host = np.add.accumulate(sw.cpu().numpy(), axis=1, dtype=np.float32)
    return torch.from_numpy(host).to(sw.device)


def compute_cuts(X: torch.Tensor, max_bin: int = 256,
                 weights: Optional[torch.Tensor] = None,
                 categorical: Optional[Sequence[int]] = None
                 ) -> HistogramCuts:
    """[n, F] f32 (NaN missing) -> cuts, on ``X``'s device (the port of
    ``_cuts_kernel``): ``max_bin - 1`` weighted quantiles at k/B of the
    total weight plus a strict-upper sentinel cut. ``categorical``
    features get identity cuts instead (``apply_categorical_identity``).

    One step leaves the device: with row weights, or with more than 2^24
    rows, the strict f32 prefix sum (``_sequential_cdf``) copies the sorted
    ``[F, n]`` weights to the host, accumulates them there and copies the
    result back. A parallel scan on the card would reassociate the sum and
    move near-tie cuts away from the JAX package's. Unit weights at up to
    2^24 rows (the main path) stay on the device.

    The levels are ``(k * f32(1/B)) * total`` with the reciprocal formed
    explicitly (``sketch._levels``): XLA folds the JAX package's division
    by the constant ``max_bin`` into that product, so the cuts match it
    at every ``max_bin``, and the card and the CPU round alike.

    Traced as a ``sketch`` span, and charged to the flight recorder's
    ``sketch`` stage."""
    t0 = time.perf_counter()
    with trace.span("sketch", rows=int(X.shape[0]),
                    features=int(X.shape[1]), max_bin=max_bin):
        values, min_vals = _cuts(X, max_bin, weights)
    flight.note("sketch", time.perf_counter() - t0)
    if categorical:
        apply_categorical_identity(values, min_vals, categorical)
    return HistogramCuts(values=values, min_vals=min_vals)


def _cuts(X: torch.Tensor, max_bin: int, weights: Optional[torch.Tensor]
          ) -> Tuple[np.ndarray, np.ndarray]:
    """``compute_cuts``' host ``(values [F, max_bin], min_vals [F])``
    before the categorical identity."""
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
    levels = _levels(max_bin - 1, max_bin, total)  # [F, B-1]
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
    return cuts.cpu().numpy(), min_val.cpu().numpy()


def compute_exact_cuts(X, cap: int = 16384,
                       categorical: Optional[Sequence[int]] = None
                       ) -> HistogramCuts:
    """Cuts at every distinct finite value of each feature, the exact-greedy
    candidate set of ``tree_method="exact"`` (reference
    ``updater_colmaker.cc:367``; the JAX package's ``compute_exact_cuts``):
    the hist grower over these bins enumerates the splits the column scan
    would. ``X`` is [n, F] (numpy, or a tensor on any device: the distinct
    values are found on the host). The width is the widest feature's
    distinct count plus one (at least 2; a categorical feature counts its
    largest code plus one), shorter features padded with their sentinel
    ``max + max(1, |max|)`` (empty bins), an all-missing feature with
    ``1..B``. A feature of more than ``cap`` distinct values raises the
    JAX package's ValueError."""
    Xn = np.asarray(X.cpu() if torch.is_tensor(X) else X, np.float32)
    cat_set = frozenset(categorical or ())
    uniques = []
    widest = 0
    for f in range(Xn.shape[1]):
        col = Xn[:, f]
        u = np.unique(col[~np.isnan(col)])
        if len(u) > cap:
            raise ValueError(
                f"tree_method='exact': feature {f} has {len(u)} distinct "
                f"values (> cap {cap}); use tree_method='tpu_hist' for "
                "high-cardinality continuous data")
        if f in cat_set and len(u):
            # identity cuts need B above the largest code
            widest = max(widest, int(u[-1]) + 1)
        else:
            widest = max(widest, len(u))
        uniques.append(u)
    B = max(widest + 1, 2)
    values = np.empty((Xn.shape[1], B), np.float32)
    min_vals = np.zeros((Xn.shape[1],), np.float32)
    for f, u in enumerate(uniques):
        if len(u) == 0:
            values[f] = np.arange(1, B + 1, dtype=np.float32)
            continue
        values[f, :len(u)] = u
        values[f, len(u):] = u[-1] + max(1.0, abs(float(u[-1])))
        min_vals[f] = u[0]
    if categorical:
        apply_categorical_identity(values, min_vals, list(categorical))
    return HistogramCuts(values=values, min_vals=min_vals)


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
    searchsorted-right, clipped to ``B - 1``, NaN -> ``B``. Traced as a
    ``quantize`` span."""
    with trace.span("quantize", rows=int(X.shape[0]), max_bin=cuts.max_bin):
        return _bins(X, cuts)


def _bins(X: torch.Tensor, cuts: HistogramCuts) -> torch.Tensor:
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
    # feature ids binned as categorical (identity cuts)
    categorical: Tuple[int, ...] = ()
    # categories per categorical feature (aligned with ``categorical``):
    # max observed code + 1, or 1 for a column with no present value. Picks
    # one-hot or partition splits (max_cat_to_onehot).
    cat_counts: Tuple[int, ...] = ()
    # the resident one-hot of the hoisted route and the plan it was built
    # to (None until fused_onehot first runs)
    _onehot: Optional[torch.Tensor] = None
    _hoist_fh: Optional[int] = None
    _hoist_group: Optional[int] = None  # id() of the plan's row group
    # the construct route's feature-major bins (None until first asked for)
    _bins_t: Optional[torch.Tensor] = None
    _cuts_group: Optional[int] = None  # id() of the group check_cuts passed

    def check_cuts(self, group) -> None:
        """Under a row ``group``: that every rank bins against these cuts,
        by ``hoist_plan_synced``'s digest gather (ValueError where they
        differ), once per (matrix, group). The lossguide grower's check;
        the depthwise grower's is ``fused_onehot``'s plan gather."""
        if group is not None and self._cuts_group != id(group):
            hoist_plan_synced(0, group, cuts_digest=self.cuts.digest())
            self._cuts_group = id(group)

    @property
    def n_features(self) -> int:
        return int(self.bins.shape[1])

    def fused_onehot(self, group=None) -> Optional[torch.Tensor]:
        """The resident ``[Fh*B, n_pad]`` int8 one-hot of the first ``Fh``
        features for the hoisted level route, or None when the plan is 0
        (always on the CPU; ``tree/hist_kernel.py:hoist_plan``). Built once
        per matrix with ``build_onehot`` (kernel C on the card) and cached:
        the expansion is training-invariant, so every level of every tree
        streams the same array. The plan is frozen at the first call, so the
        resident one-hot itself never shrinks a later plan (the JAX
        package's ``fused_onehot``, ``data/quantile.py:454``). Under a row
        ``group`` the plan is the one agreed over its ranks
        (``hoist_plan_synced``; the JAX package's ``fused_onehot_mesh``),
        made once per (matrix, group); the same gather checks that every
        rank's cuts are these, and raises ValueError where they differ (a
        matrix binned on its own rank's rows, outside ``mesh_context``). A failed build raises: there is no
        degrade to the construct route. Making the plan passes the
        ``pallas`` chaos site (the kernel-launch site, on either device),
        where the JAX package hits it before its one-hot build; a fired hit
        raises."""
        key = None if group is None else id(group)
        if self._hoist_fh is None or self._hoist_group != key:
            from ..observability import kernelprof

            # the plan and the build: the round's ``onehot`` op on a
            # sampled or traced round
            step = kernelprof.round_seam(self.bins.device)
            if step is None:
                self._plan_onehot(group, key)
            else:
                step("onehot", -1, self._plan_onehot, group, key)
        return self._onehot

    def _plan_onehot(self, group, key) -> None:
        chaos.hit("pallas")
        n, F = self.bins.shape
        B = self.cuts.max_bin
        fh = hoist_plan_synced(hoist_plan(onehot_rows(n), F, B,
                                          self.bins.device), group,
                               cuts_digest=self.cuts.digest())
        if fh != self._hoist_fh:
            self._onehot = (build_onehot(self.bins, B=B, Fh=fh) if fh
                            else None)
        self._hoist_fh, self._hoist_group = fh, key

    def feature_major(self) -> torch.Tensor:
        """The bins feature-major (``tree/hist_kernel.py:feature_major``),
        made once per matrix and kept: kernel A reads every level's bins
        from it. n*F bin-sized elements, 1/B of the one-hot."""
        if self._bins_t is None:
            self._bins_t = feature_major(self.bins)
        return self._bins_t

    @classmethod
    def from_dense(cls, X: torch.Tensor, max_bin: int = 256,
                   weights: Optional[torch.Tensor] = None,
                   cuts: Optional[HistogramCuts] = None,
                   categorical: Optional[Sequence[int]] = None
                   ) -> "BinnedMatrix":
        t_ing = time.perf_counter()
        cat = tuple(categorical) if categorical else ()
        counts: Tuple[int, ...] = ()
        if cat:
            col = X[:, list(cat)]
            present = ~torch.isnan(col)
            top = torch.where(present, col, torch.full_like(col, -1.0))
            counts = tuple(int(m) + 1 if has else 1 for m, has in zip(
                top.amax(dim=0).tolist(), present.any(dim=0).tolist()))
        if cuts is None:
            cuts = compute_cuts(X, max_bin=max_bin, weights=weights,
                                categorical=cat)
        out = cls(cuts=cuts, bins=bin_matrix(X, cuts),
                  cut_values=torch.as_tensor(cuts.values, device=X.device),
                  categorical=cat, cat_counts=counts)
        # the matrix's construction time: the flight recorder's `ingest`
        flight.note("ingest", time.perf_counter() - t_ing)
        return out

    @classmethod
    def from_sparse(cls, storage, max_bin: int = 256,
                    weights: Optional[torch.Tensor] = None,
                    cuts: Optional[HistogramCuts] = None,
                    categorical: Optional[Sequence[int]] = None,
                    col_block: int = 16,
                    device: Union[str, torch.device] = "cpu"
                    ) -> "BinnedMatrix":
        """Quantize a ``CSRStorage`` without a dense float copy (the JAX
        package's ``from_sparse``, ``data/quantile.py:640``): NaN-filled
        column blocks of ``col_block`` features go to ``device`` and
        through ``compute_cuts`` and ``bin_matrix``, each feature's cuts
        and bins depending on its own column only, so both are bit for bit
        the dense path's on the same values. ``weights`` ([n] on
        ``device``) weight the sketch; None is unit weights (a vector of
        ones would send the prefix sum to the host, ``_sequential_cdf``)."""
        t_ing = time.perf_counter()
        n, F = storage.shape
        device = torch.device(device)
        cat = tuple(categorical) if categorical else ()
        blocks = [(f0, min(f0 + col_block, F)) for f0 in range(0, F, col_block)]

        own = cuts is None
        if own:
            cuts = HistogramCuts(values=np.empty((F, max_bin), np.float32),
                                 min_vals=np.empty((F,), np.float32))
        bins = torch.empty((n, F), dtype=storage_dtype(cuts.max_bin),
                           device=device)
        for f0, f1 in blocks:
            Xb = torch.as_tensor(storage.dense_cols(f0, f1), device=device)
            if own:  # each feature's cuts read its own column only
                c = compute_cuts(Xb, max_bin=max_bin, weights=weights,
                                 categorical=[f - f0 for f in cat
                                              if f0 <= f < f1])
                cuts.values[f0:f1], cuts.min_vals[f0:f1] = c.values, c.min_vals
            bins[:, f0:f1] = bin_matrix(Xb, HistogramCuts(
                values=cuts.values[f0:f1], min_vals=cuts.min_vals[f0:f1]))
        counts: Tuple[int, ...] = ()
        if cat:
            present = [v[~np.isnan(v)] for v in map(storage.column_values, cat)]
            counts = tuple(int(v.max()) + 1 if v.size else 1 for v in present)
        out = cls(cuts=cuts, bins=bins,
                  cut_values=torch.as_tensor(cuts.values, device=device),
                  categorical=cat, cat_counts=counts)
        flight.note("ingest", time.perf_counter() - t_ing)
        return out
