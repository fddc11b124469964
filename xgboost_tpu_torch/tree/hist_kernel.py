"""Fused partition + level histogram for the depthwise grower.

The port of the JAX package's ``tree/hist_kernel.py``. ``fused_level`` has
the contract of ``fused_level_xla`` (``hist_kernel.py:711``): route every
row through level ``d-1``'s decision table, then accumulate (g, h) per
(feature, node, bin) for level ``d``, missing excluded; it returns
``(pos [n, 1] int32, hist [F, 2K, B] float32)`` with g in rows ``[0, K)`` and
h in rows ``[K, 2K)``. The caller recovers missing as node total - sum.

Two routes to that contract, as on the TPU (``fused_level`` :801):

- the **hoisted** route, when the caller passes the resident int8 one-hot of
  the first ``Fh`` features (``build_onehot``, kernel C, ``csrc/onehot.cu``,
  replacing ``_build_onehot_pallas``; sized by ``hoist_plan``): every level
  is ``hoisted_level``, kernel D (``csrc/hoisted_level.cu``, replacing
  ``_hoisted_level_pallas``), an int8 tensor-core product over the one-hot,
  with features ``Fh..F-1`` built in the same launch;
- the **construct** route otherwise: kernel A (``csrc/hist_level.cu``,
  replacing ``_fused_level_pallas``) routes the rows once (writing each
  row's local node, ``_level_records_plain``) and reads the bins from a
  feature-major copy (``feature_major``, made once per training matrix).

On a CUDA tensor each wrapper launches its kernel (and counts it in its
``launches``); on a CPU tensor it runs the plain version beside it. All of
them accumulate the same fixed-point integers (``quantize_gradients``), so
every route and device gives the same int64 histogram bits, deterministic,
as the TPU kernels are. A failed build or launch raises; nothing degrades to
another route.

The decision table of level ``d-1`` is ``[>= Kp, 4]`` (is_split, feature,
bin, default_left) or, with categorical features, ``[>= Kp, 5+B]``: column
4 flags a categorical node and columns 5 on hold its right-going category
set (the two layouts of ``_partition_tile``). Every route reads both.

``partition_apply`` (the final routing step; XLA in the JAX package) and
``leaf_delta`` (a gather) are plain torch on every device.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build, collective

__all__ = ["QuantizedGradients", "quantize_gradients", "fused_level",
           "fused_level_int", "level_lanes", "feature_major",
           "hoisted_level", "build_onehot", "onehot_rows", "hoist_budget_bytes",
           "device_free_bytes", "hoist_plan", "hoist_plan_synced",
           "can_hoist", "partition_apply",
           "leaf_delta"]

# |q| <= 2^_QBITS, so n <= 2^32 rows cannot overflow the int64 sums
_QBITS = 30

#: bin storage types the kernels read, by their width in bytes
_BIN_BYTES = {torch.uint8: 1, torch.int16: 2}

# the one-hot's rows are padded to the int8 MMA's K step
_ONEHOT_ROW_STEP = 32


def _bin_bytes(bins: torch.Tensor, what: str) -> int:
    nb = _BIN_BYTES.get(bins.dtype)
    if nb is None:
        raise NotImplementedError(
            f"{what}: the CUDA kernels read uint8 or int16 bins "
            f"(max_bin <= 32766); got {bins.dtype}")
    return nb


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float64 ``2^e`` of integers ``e`` in [-1022, 1023], built from
    the exponent bits: ``torch.ldexp`` multiplies by ``torch.pow(2, e)``,
    which the card rounds (2^29 comes out one ulp low), so the quantised
    gradients, and with them the trees, would differ from the CPU's."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


class QuantizedGradients(NamedTuple):
    """Fixed-point (g, h): ``q[:, j] = rint(x[:, j] * 2^exp[j])`` with one
    power-of-two scale per lane, chosen so ``|q| <= 2^30``."""

    q: torch.Tensor  # [n, 2] int32
    exp: torch.Tensor  # [2] int32

    def dequantize(self, sums: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
        """int64 sums -> float32, lane[i] picking the scale of each sum
        (int64 -> double is exact below 2^53, and a power-of-two scale is
        exact, so the only rounding is the final cast)."""
        return (sums.double() * _pow2(-self.exp)[lane]).float()

    def totals(self, group=None) -> torch.Tensor:
        """[2] float32 (G, H) over all rows, from the same integers the
        histograms sum, so node totals and bin sums agree exactly. Under a
        row ``group`` (``parallel.RowGroup``) the int64 sums are
        all-reduced first: the totals over every rank's rows."""
        lanes = torch.arange(2, device=self.q.device)
        sums = collective.all_reduce(self.q.sum(dim=0, dtype=torch.int64),
                                     group, site="root_totals")
        return self.dequantize(sums, lanes)


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor, group=None
                       ) -> QuantizedGradients:
    """Per-lane power-of-two quantiser, computed on the device with no host
    sync: ``E = 30 - frexp_exponent(max|x|)``, ``q = rint(x * 2^E)``. Under
    a row ``group`` the ``max|x|`` is the largest over every rank (an
    all-reduce MAX), so all ranks quantise on one scale and their int64
    sums add up to the sums of one process over all the rows."""
    gh = torch.stack([grad, hess], dim=1).to(torch.float32)
    amax = (gh.abs().amax(dim=0) if gh.shape[0]
            else gh.new_zeros(2))
    _, e = torch.frexp(collective.all_reduce(amax, group, collective.Op.MAX,
                                             site="grad_scale"))
    exp = (_QBITS - e).to(torch.int32)
    scaled = gh.double() * _pow2(exp)
    return QuantizedGradients(q=torch.round(scaled).to(torch.int32), exp=exp)


def partition_apply(bins: torch.Tensor, pos: torch.Tensor, ptab: torch.Tensor,
                    *, Kp: int, B: int, d: int) -> torch.Tensor:
    """Route rows through level ``d-1``'s decisions ``ptab``: ``[Kp, 4]``
    (is_split, feature, bin, default_left), or ``[Kp, 5+B]`` with
    categorical features, where column 4 flags a categorical node and
    columns 5 on hold its right-going category set. The rule of
    ``partition_apply_xla``: a missing bin follows default_left; a present
    bin goes left iff ``bin <= split bin`` at a numerical node and iff it
    is not in the set at a categorical node. Rows at other nodes keep
    their position."""
    prev_offset = (1 << (d - 1)) - 1 if d > 0 else 0
    p = pos[:, 0]
    lp = p - prev_offset
    inb = (lp >= 0) & (lp < Kp)
    row = ptab[lp.clamp(0, max(Kp - 1, 0))]  # [n, W]
    f = row[:, 1].long()
    bv = torch.gather(bins, 1, f[:, None])[:, 0].long()
    present_left = bv <= row[:, 2].long()
    if ptab.shape[1] > 4:
        member = torch.gather(row, 1, 5 + bv.clamp(max=B - 1)[:, None])[:, 0]
        present_left = torch.where(row[:, 4] > 0.5, member <= 0.5,
                                   present_left)
    goleft = torch.where(bv >= B, row[:, 3] > 0.5, present_left)
    goes = inb & (row[:, 0] > 0.5)
    child = torch.where(goleft, 2 * p + 1, 2 * p + 2)
    return torch.where(goes, child, p)[:, None].to(torch.int32)


def _add_cells(hist, f, local, b, rows, q, K: int, B: int) -> None:
    """``hist`` [F*2K*B] int64 += q of ``rows`` at (feature, node, bin):
    g into rows [0, K) of the [2K, B] slab, h into rows [K, 2K)."""
    cell = (f * (2 * K) + local) * B + b
    hist.index_add_(0, cell, q[rows, 0])
    hist.index_add_(0, cell + K * B, q[rows, 1])


def _construct_plain(hist, bins, local, q, f0: int, K: int, B: int) -> None:
    """Add features ``f0..F-1`` of every row at a level node, read from the
    bins, missing excluded."""
    b = bins[:, f0:].long()
    keep = ((local >= 0) & (local < K))[:, None] & (b < B)
    rows, fi = torch.nonzero(keep, as_tuple=True)
    _add_cells(hist, fi + f0, local[rows], b[rows, fi], rows, q, K, B)


def _fused_level_plain(bins, pos, gq: QuantizedGradients, ptab, *, K, Kp, B,
                       d) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: gather partition + index_add_ over int64."""
    if Kp > 0:
        pos = partition_apply(bins, pos, ptab, Kp=Kp, B=B, d=d)
    F = bins.shape[1]
    local = pos[:, 0].long() - ((1 << d) - 1)
    hist = torch.zeros(F * 2 * K * B, dtype=torch.int64, device=bins.device)
    _construct_plain(hist, bins, local, gq.q.long(), 0, K, B)
    return pos, hist.view(F, 2 * K, B)


def _check_level_inputs(bins, pos, gq: QuantizedGradients, ptab, Kp: int,
                        B: int, what: str) -> int:
    """Check what the level kernels take; returns the bins' width in bytes.
    The decision table is ``[>= Kp, 4]`` or, with categorical features,
    ``[>= Kp, 5+B]``."""
    for t in (bins, pos, gq.q, ptab):
        _build.require_kernel_device(t, what)
    n = bins.shape[0]
    bin_bytes = _bin_bytes(bins, what)
    if pos.dtype != torch.int32 or tuple(pos.shape) != (n, 1):
        raise ValueError(f"{what}: pos must be int32 [{n}, 1]")
    if gq.q.dtype != torch.int32 or tuple(gq.q.shape) != (n, 2):
        raise ValueError(f"{what}: quantized gradients must be int32 [{n}, 2]")
    if ptab.dtype != torch.float32 or ptab.dim() != 2 \
            or ptab.shape[1] not in (4, 5 + B) or ptab.shape[0] < Kp:
        raise ValueError(f"{what}: ptab must be float32 [>= {Kp}, 4] or "
                         f"[>= {Kp}, {5 + B}]")
    return bin_bytes


def feature_major(bins: torch.Tensor) -> torch.Tensor:
    """The bins feature-major, ``[F, onehot_rows(n)]`` in their storage
    type: row ``f`` holds feature ``f`` of every row, then zeros. Kernel A
    reads its bins from this copy (``BinnedMatrix.feature_major`` keeps it
    once per training matrix). Plain torch, on the bins' device."""
    n, F = bins.shape
    out = torch.zeros((F, onehot_rows(n)), dtype=bins.dtype,
                      device=bins.device)
    out[:, :n] = bins.t()
    return out


def _level_records_plain(pos, *, K: int, d: int) -> torch.Tensor:
    """Kernel A's per-row record of a level, ``[n]`` int32: the row's local
    node ``pos - (2^d - 1)`` for rows at positions ``pos`` (already routed to
    level ``d``), or -1 when that is not in ``[0, K)``."""
    local = pos[:, 0] - ((1 << d) - 1)
    return torch.where((local >= 0) & (local < K), local,
                       torch.full_like(local, -1)).to(torch.int32)


def _level_inputs(bins, pos, gq: QuantizedGradients, ptab, *, K, Kp, B, d,
                  what):
    """Kernel A's routing launch, prepared once for both of its entry
    points: checks, contiguous inputs, the routed positions and the
    per-row records. Returns ``(pos_out, loc, held, args)``; ``held`` keeps
    the contiguous inputs alive until the launch is queued, ``args`` holds
    the C arguments ``(bins, bin_bytes, n, F)``, ``(pos, pos_out, q, ptab,
    W, Kp, prev_offset, K, offset)`` with ``W`` the table's width."""
    bin_bytes = _check_level_inputs(bins, pos, gq, ptab, Kp, B, what)
    n, F = bins.shape
    held = tuple(t.contiguous() for t in (bins, pos, gq.q, ptab))
    bins, pos, q, ptab = held
    pos_out = torch.empty_like(pos)
    loc = torch.empty(n, dtype=torch.int32, device=bins.device)
    prev_offset = (1 << (d - 1)) - 1 if d > 0 else 0
    args = ((bins.data_ptr(), bin_bytes, n, F),
            (pos.data_ptr(), pos_out.data_ptr(), q.data_ptr(), ptab.data_ptr(),
             ptab.shape[1], Kp, prev_offset, K, (1 << d) - 1))
    return pos_out, loc, held, args


def _level_records_cuda(bins, pos, gq: QuantizedGradients, ptab, *, K, Kp,
                        B, d):
    """Kernel A's first launch alone: ``(routed pos, per-row records)``, as
    ``_fused_level_cuda`` writes them before its histogram launch. Not
    counted in ``fused_level.launches``."""
    what = "fused_level"
    pos_out, loc, held, (head, (p, po, _, pt, *route)) = _level_inputs(
        bins, pos, gq, ptab, K=K, Kp=Kp, B=B, d=d, what=what)
    status = _build.library("hist_level").xgbt_level_route(
        *head, B, p, po, pt, *route, loc.data_ptr(),
        _build.stream_of(bins.device))
    _build.check_status(status, what)
    return pos_out, loc


def _fused_level_cuda(bins, pos, gq: QuantizedGradients, ptab, *, K, Kp, B,
                      d, bins_t=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel A (its routing launch, then its histogram launch) over
    ``bins_t``, the bins' ``feature_major`` copy (made here when None).
    Checks what the kernel takes and raises otherwise."""
    what = "fused_level"
    n, F = bins.shape
    if bins_t is None:
        bins_t = feature_major(bins)
    _build.require_kernel_device(bins_t, what)
    if bins_t.dtype != bins.dtype or bins_t.dim() != 2 \
            or bins_t.shape[0] != F or bins_t.shape[1] < n \
            or bins_t.stride(1) != 1 or bins_t.stride(0) % 4 \
            or bins_t.data_ptr() % 8:
        raise ValueError(f"{what}: the feature-major bins must be [{F}, >= "
                         f"{n}] {bins.dtype}, rows contiguous, a multiple of "
                         "4 apart and 8-byte aligned")
    pos_out, loc, held, (head, route) = _level_inputs(
        bins, pos, gq, ptab, K=K, Kp=Kp, B=B, d=d, what=what)
    hist = torch.zeros((F, 2 * K, B), dtype=torch.int64, device=bins.device)
    status = _build.library("hist_level").xgbt_fused_level(
        *head, B, *route, hist.data_ptr(), bins_t.data_ptr(), bins_t.stride(0),
        loc.data_ptr(), _build.stream_of(bins.device))
    _build.check_status(status, what)
    fused_level.launches += 1
    return pos_out, hist


# ---------------------------------------------------------------------------
# The hoisted route: a resident int8 one-hot of the first Fh features, built
# once per training matrix (kernel C), streamed by every level (kernel D).
# ---------------------------------------------------------------------------

_HOIST_BUDGET_ENV = "XGBTPU_HOIST_BUDGET_MB"

# Below this many hoisted features a partial hoist is not worth the resident
# memory: the construct tiles dominate either way (the JAX package's floor).
_MIN_HOIST_FEATURES = 4


def onehot_rows(n: int) -> int:
    """Row count of the one-hot: ``n`` padded to the int8 MMA's K step."""
    return -(-n // _ONEHOT_ROW_STEP) * _ONEHOT_ROW_STEP


def device_free_bytes(device) -> int:
    """Free memory on a CUDA ``device``, as the driver counts it."""
    return int(torch.cuda.mem_get_info(device)[0])


def hoist_budget_bytes(device) -> int:
    """Device-memory budget for the resident one-hot: the JAX package's rule
    (``hist_kernel.py:293``). ``XGBTPU_HOIST_BUDGET_MB`` wins when set (0
    disables hoisting); otherwise 8 GiB clamped to 60% of the device's free
    memory."""
    env = os.environ.get(_HOIST_BUDGET_ENV)
    if env is not None:
        try:
            return int(env) * 1024 * 1024
        except ValueError:
            pass
    return min(8192 * 1024 * 1024, int(device_free_bytes(device) * 0.6))


def hoist_plan(n_pad: int, F: int, B: int, device) -> int:
    """How many leading features to keep resident as a one-hot: the largest
    ``Fh <= F`` whose ``[Fh*B, n_pad]`` int8 expansion fits the budget.
    ``Fh == F`` is the full hoist; ``0 < Fh < F`` the partial hoist (kernel D
    builds the rest per level); 0 means the construct route (kernel A), and
    so does a partial plan below ``_MIN_HOIST_FEATURES``. Always 0 on the CPU,
    as the JAX plan is 0 off the TPU. The TPU's VMEM fit model and its
    allocation probe have no counterpart: kernel D's tiles are the same at
    every level and width."""
    if torch.device(device).type == "cpu" or B <= 0 or n_pad <= 0:
        return 0
    fh = min(F, hoist_budget_bytes(device) // (n_pad * B))
    if fh < F and fh < _MIN_HOIST_FEATURES:
        return 0
    return int(fh)


def hoist_plan_synced(fh: int, group=None, cuts_digest: int = 0) -> int:
    """This rank's plan ``fh`` (``hoist_plan``) agreed over a row ``group``:
    the smallest plan of any rank (the JAX package's
    ``hoist_plan_synced``), so every rank takes one route. Ranks sharing a
    card read different free memory. ``fh`` itself without a group. The
    same gather carries each rank's ``cuts_digest``
    (``HistogramCuts.digest``): ranks whose bins mean different values
    would sum histograms of different splits, so unequal digests raise
    ValueError."""
    if group is None:
        return fh
    got = collective.process_allgather(
        np.asarray([fh, cuts_digest], np.int64), site="hoist_plan",
        mesh=group)
    if (got[:, 1] != got[0, 1]).any():
        raise ValueError(
            "the ranks bin against different cuts: build each rank's "
            "matrix inside mesh_context (the distributed sketch), or bin "
            "every rank against shared cuts with QuantileDMatrix(ref=)")
    return int(got[:, 0].min())


def can_hoist(n_pad: int, F: int, B: int, device) -> bool:
    """Whether the FULL one-hot can be hoisted (see ``hoist_plan``)."""
    return hoist_plan(n_pad, F, B, device) == F


def _build_onehot_plain(bins, *, B: int, Fh: int) -> torch.Tensor:
    """The plain version: one comparison against ``arange(B)`` per feature,
    in kernel C's layout."""
    n = bins.shape[0]
    out = torch.zeros((Fh * B, onehot_rows(n)), dtype=torch.int8,
                      device=bins.device)
    iota = torch.arange(B, device=bins.device)[:, None]
    for f in range(Fh):
        out[f * B:(f + 1) * B, :n] = bins[:, f].long()[None, :] == iota
    return out


def _build_onehot_cuda(bins, *, B: int, Fh: int) -> torch.Tensor:
    """Launch kernel C. Checks what the kernel takes and raises otherwise."""
    what = "build_onehot"
    _build.require_kernel_device(bins, what)
    n, F = bins.shape
    bin_bytes = _bin_bytes(bins, what)
    if not 1 <= Fh <= F or B < 1:
        raise ValueError(f"{what}: need 1 <= Fh <= {F} and B >= 1")
    bins = bins.contiguous()
    n_pad = onehot_rows(n)
    out = torch.empty((Fh * B, n_pad), dtype=torch.int8, device=bins.device)
    status = _build.library("onehot").xgbt_build_onehot(
        bins.data_ptr(), bin_bytes, n, F, Fh, B, n_pad, out.data_ptr(),
        _build.stream_of(bins.device))
    _build.check_status(status, what)
    build_onehot.launches += 1
    return out


def build_onehot(bins: torch.Tensor, *, B: int, Fh: int) -> torch.Tensor:
    """``[n, F]`` bins -> the int8 one-hot of the first ``Fh`` features,
    feature-major ``[Fh*B, onehot_rows(n)]``: cell ``(f*B + b, r)`` is 1
    exactly where ``bins[r, f] == b``; the missing bin ``B`` and the padding
    rows are all zero. The JAX package keeps the same cells as ``[n, Fh*B]``
    (``build_onehot``, ``hist_kernel.py:400``). Kernel C on a CUDA tensor
    (``build_onehot.launches`` counts it), the plain version on a CPU
    tensor."""
    run = _build_onehot_plain if bins.device.type == "cpu" else _build_onehot_cuda
    return run(bins, B=B, Fh=Fh)


build_onehot.launches = 0


def _onehot_features(onehot, n: int, F: int, B: int, what: str) -> int:
    """Fh of a one-hot made by ``build_onehot`` for ``n`` rows of ``F``
    features; raises on any other tensor."""
    Fh = onehot.shape[0] // B if onehot.dim() == 2 else 0
    if onehot.dtype != torch.int8 or not 1 <= Fh <= F \
            or tuple(onehot.shape) != (Fh * B, onehot_rows(n)):
        raise ValueError(f"{what}: the one-hot must be int8 [Fh*{B}, "
                         f"{onehot_rows(n)}] with 1 <= Fh <= {F}")
    return Fh


def _hoisted_level_plain(bins, onehot, pos, gq: QuantizedGradients, ptab, *,
                         K, Kp, B, d) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: gather partition; the hoisted features' cells from
    the one-hot's non-zeros, the rest from the bins; index_add_ over int64."""
    if Kp > 0:
        pos = partition_apply(bins, pos, ptab, Kp=Kp, B=B, d=d)
    n, F = bins.shape
    Fh = _onehot_features(onehot, n, F, B, "hoisted_level")
    local = pos[:, 0].long() - ((1 << d) - 1)
    q = gq.q.long()
    hist = torch.zeros(F * 2 * K * B, dtype=torch.int64, device=bins.device)
    col, rows = torch.nonzero(onehot[:, :n], as_tuple=True)
    lr = local[rows]
    at_level = (lr >= 0) & (lr < K)
    col, rows, lr = col[at_level], rows[at_level], lr[at_level]
    _add_cells(hist, col // B, lr, col % B, rows, q, K, B)
    _construct_plain(hist, bins, local, q, Fh, K, B)
    return pos, hist.view(F, 2 * K, B)


def _channel_records_plain(pos, gq: QuantizedGradients, *, K: int,
                           d: int) -> torch.Tensor:
    """Kernel D's per-row channel records, ``[n, 4]`` int32, for rows at
    positions ``pos`` (already routed to level ``d``): the row's local node
    ``pos - (2^d - 1)``, or -1 when that is not in ``[0, K)``; then q_g and
    q_h, each as its four balanced base-256 digits ``d_k`` (``q = sum
    d_k 256^k``, ``d_0..d_2`` in ``[-128, 127]``), one byte each, digit 0 in
    the lowest byte; then 0."""
    local = pos[:, 0].long() - ((1 << d) - 1)
    local = torch.where((local >= 0) & (local < K), local, -1)
    words = []
    for lane in range(2):
        x = gq.q[:, lane].long()
        w = torch.zeros_like(x)
        for dg in range(4):
            digit = ((x + 128) & 0xff) - 128 if dg < 3 else x
            w |= (digit & 0xff) << (8 * dg)
            x = (x - digit) >> 8
        words.append(torch.where(w >= 1 << 31, w - (1 << 32), w))
    return torch.stack([local, *words, torch.zeros_like(local)],
                       dim=1).to(torch.int32)


def _route_scratch(bins, Fh: int, n_pad: int):
    """Kernel D's scratch: the channel records ``[n, 4]`` int32 and, for a
    partial hoist, the unhoisted bins feature-major ``[F-Fh, n_pad]``."""
    n, F = bins.shape
    rec = torch.empty((n, 4), dtype=torch.int32, device=bins.device)
    bins_t = (torch.empty((F - Fh, n_pad), dtype=bins.dtype, device=bins.device)
              if Fh < F else None)
    return rec, bins_t


def _route_inputs(bins, pos, gq: QuantizedGradients, ptab, *, K, Kp, B, d,
                  Fh, n_pad, what):
    """Kernel D's routing launch, prepared once for both of its entry
    points: checks the inputs, makes them contiguous and allocates the
    routed positions and the scratch (``_route_scratch``). Returns
    ``(pos_out, rec, bins_t, held, args)``; the caller keeps the tensors
    (``held``: the contiguous inputs) until its launch is queued. ``args``
    holds the C arguments in three runs, ``(bins, bin_bytes, n, F, B)``,
    ``(pos, pos_out, q, ptab, W, Kp, prev_offset, K, offset)`` with ``W``
    the table's width, and ``(rec, bins_t)``."""
    bin_bytes = _check_level_inputs(bins, pos, gq, ptab, Kp, B, what)
    n, F = bins.shape
    held = tuple(t.contiguous() for t in (bins, pos, gq.q, ptab))
    bins, pos, q, ptab = held
    pos_out = torch.empty_like(pos)
    rec, bins_t = _route_scratch(bins, Fh, n_pad)
    prev_offset = (1 << (d - 1)) - 1 if d > 0 else 0
    args = ((bins.data_ptr(), bin_bytes, n, F, B),
            (pos.data_ptr(), pos_out.data_ptr(), q.data_ptr(), ptab.data_ptr(),
             ptab.shape[1], Kp, prev_offset, K, (1 << d) - 1),
            (rec.data_ptr(), None if bins_t is None else bins_t.data_ptr()))
    return pos_out, rec, bins_t, held, args


def _channel_records_cuda(bins, pos, gq: QuantizedGradients, ptab, *, K, Kp,
                          B, d, Fh):
    """Kernel D's first launch alone: ``(routed pos, channel records, the
    unhoisted bins feature-major or None)``, as ``_hoisted_level_cuda``
    writes them before its histogram launch. Not counted in
    ``hoisted_level.launches``."""
    what = "hoisted_level"
    n_pad = onehot_rows(bins.shape[0])
    pos_out, rec, bins_t, held, (head, route, scratch) = _route_inputs(
        bins, pos, gq, ptab, K=K, Kp=Kp, B=B, d=d, Fh=Fh, n_pad=n_pad,
        what=what)
    status = _build.library("hoisted_level").xgbt_hoisted_route(
        *head, Fh, n_pad, *route, *scratch, _build.stream_of(bins.device))
    _build.check_status(status, what)
    return pos_out, rec, bins_t


def _hoisted_level_cuda(bins, onehot, pos, gq: QuantizedGradients, ptab, *,
                        K, Kp, B, d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel D (its routing launch, then its histogram launch).
    Checks what the kernel takes and raises otherwise."""
    what = "hoisted_level"
    _build.require_kernel_device(onehot, what)
    n, F = bins.shape
    Fh = _onehot_features(onehot, n, F, B, what)
    if not onehot.is_contiguous() or onehot.data_ptr() % 16:
        raise ValueError(f"{what}: the one-hot must be contiguous and "
                         "16-byte aligned")
    n_pad = onehot.shape[1]
    pos_out, rec, bins_t, held, (head, route, scratch) = _route_inputs(
        bins, pos, gq, ptab, K=K, Kp=Kp, B=B, d=d, Fh=Fh, n_pad=n_pad,
        what=what)
    hist = torch.zeros((F, 2 * K, B), dtype=torch.int64, device=bins.device)
    status = _build.library("hoisted_level").xgbt_hoisted_level(
        *head, onehot.data_ptr(), Fh, n_pad, *route, hist.data_ptr(),
        *scratch, _build.stream_of(bins.device))
    _build.check_status(status, what)
    hoisted_level.launches += 1
    return pos_out, hist


def hoisted_level(bins, onehot, pos, gq: QuantizedGradients, ptab, *, K: int,
                  Kp: int, B: int, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(new pos [n, 1] int32, hist [F, 2K, B] int64)`` of one level over
    the one-hot from ``build_onehot``: kernel D on a CUDA tensor
    (``hoisted_level.launches`` counts it), the plain version on a CPU
    tensor."""
    run = (_hoisted_level_plain if bins.device.type == "cpu"
           else _hoisted_level_cuda)
    return run(bins, onehot, pos, gq, ptab, K=K, Kp=Kp, B=B, d=d)


hoisted_level.launches = 0


def fused_level_int(bins, pos, gq: QuantizedGradients, ptab, *, K: int,
                    Kp: int, B: int, d: int,
                    onehot: Optional[torch.Tensor] = None,
                    bins_t: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_level`` before the scale: ``(new pos [n, 1] int32, hist
    [F, 2K, B] int64)`` in the units of ``gq``. Histograms of row blocks
    quantised with one shared scale (``QuantizedGradients`` sliced by rows)
    add up exactly to the whole's."""
    if onehot is not None:
        return hoisted_level(bins, onehot, pos, gq, ptab, K=K, Kp=Kp, B=B,
                             d=d)
    if bins.device.type == "cpu":
        return _fused_level_plain(bins, pos, gq, ptab, K=K, Kp=Kp, B=B, d=d)
    return _fused_level_cuda(bins, pos, gq, ptab, K=K, Kp=Kp, B=B, d=d,
                             bins_t=bins_t)


def level_lanes(K: int, device) -> torch.Tensor:
    """The lane of each of a level histogram's ``2K`` rows (g, then h),
    shaped to broadcast over ``[F, 2K, B]``."""
    return (torch.arange(2 * K, device=device) >= K).long()[None, :, None]


def fused_level(bins, pos, gq: QuantizedGradients, ptab, *, K: int, Kp: int,
                B: int, d: int, onehot: Optional[torch.Tensor] = None,
                bins_t: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(new pos [n, 1] int32, hist [F, 2K, B] float32)``, missing
    excluded. With a one-hot, the hoisted route (``hoisted_level``);
    without, the construct route: kernel A on a CUDA tensor (over
    ``bins_t``, the bins' ``feature_major`` copy, made per call when not
    given), the plain version on a CPU tensor. ``fused_level.launches``
    counts kernel A's launches."""
    pos, hq = fused_level_int(bins, pos, gq, ptab, K=K, Kp=Kp, B=B, d=d,
                              onehot=onehot, bins_t=bins_t)
    return pos, gq.dequantize(hq, level_lanes(K, hq.device))


fused_level.launches = 0


def leaf_delta(pos: torch.Tensor, leaf_values: torch.Tensor) -> torch.Tensor:
    """Prediction-cache delta: ``leaf_values[pos]`` for every row (the JAX
    package's non-TPU route; exact)."""
    return leaf_values[pos[:, 0].long().clamp(0, leaf_values.shape[0] - 1)]
