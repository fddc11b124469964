"""Fused partition + level histogram for the depthwise grower.

The port of the JAX package's ``tree/hist_kernel.py``. ``fused_level`` has
the contract of ``fused_level_xla`` (``hist_kernel.py:711``): route every
row through level ``d-1``'s decision table, then accumulate (g, h) per
(feature, node, bin) for level ``d``, missing excluded; it returns
``(pos [n, 1] int32, hist [F, 2K, B] float32)`` with g in rows ``[0, K)`` and
h in rows ``[K, 2K)``. The caller recovers missing as node total - sum.

On a CUDA tensor it launches kernel A (``csrc/hist_level.cu``, replacing
the TPU kernel ``_fused_level_pallas`` and the hoisted route to the same
contract, ``_build_onehot_pallas`` + ``_hoisted_level_pallas``, which the
TPU takes at ``max_bin`` 64); on a CPU tensor it runs the plain
version below. Both accumulate the same fixed-point integers
(``quantize_gradients``), so they agree bit for bit, and both are
deterministic, as the TPU kernel is.

``partition_apply`` (the final routing step; XLA in the JAX package) and
``leaf_delta`` (a gather) are plain torch on every device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import _build

__all__ = ["QuantizedGradients", "quantize_gradients", "fused_level",
           "partition_apply", "leaf_delta"]

# |q| <= 2^_QBITS, so n <= 2^32 rows cannot overflow the int64 sums
_QBITS = 30


class QuantizedGradients(NamedTuple):
    """Fixed-point (g, h): ``q[:, j] = rint(x[:, j] * 2^exp[j])`` with one
    power-of-two scale per lane, chosen so ``|q| <= 2^30``."""

    q: torch.Tensor  # [n, 2] int32
    exp: torch.Tensor  # [2] int32

    def dequantize(self, sums: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
        """int64 sums -> float32, lane[i] picking the scale of each sum
        (int64 -> double is exact below 2^53, and a power-of-two scale is
        exact, so the only rounding is the final cast)."""
        scale = torch.ldexp(torch.ones(2, dtype=torch.float64,
                                       device=sums.device), -self.exp)
        return (sums.double() * scale[lane]).float()

    def totals(self) -> torch.Tensor:
        """[2] float32 (G, H) over all rows, from the same integers the
        histograms sum, so node totals and bin sums agree exactly."""
        lanes = torch.arange(2, device=self.q.device)
        return self.dequantize(self.q.sum(dim=0, dtype=torch.int64), lanes)


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor
                       ) -> QuantizedGradients:
    """Per-lane power-of-two quantiser, computed on the device with no host
    sync: ``E = 30 - frexp_exponent(max|x|)``, ``q = rint(x * 2^E)``."""
    gh = torch.stack([grad, hess], dim=1).to(torch.float32)
    _, e = torch.frexp(gh.abs().amax(dim=0))
    exp = (_QBITS - e).to(torch.int32)
    scaled = torch.ldexp(gh.double(), exp.double())
    return QuantizedGradients(q=torch.round(scaled).to(torch.int32), exp=exp)


def partition_apply(bins: torch.Tensor, pos: torch.Tensor, ptab: torch.Tensor,
                    *, Kp: int, B: int, d: int) -> torch.Tensor:
    """Route rows through level ``d-1``'s decisions ``ptab`` [Kp, 4]
    (is_split, feature, bin, default_left): the rule of
    ``partition_apply_xla``. Rows at other nodes keep their position."""
    prev_offset = (1 << (d - 1)) - 1 if d > 0 else 0
    p = pos[:, 0]
    lp = p - prev_offset
    inb = (lp >= 0) & (lp < Kp)
    row = ptab[lp.clamp(0, max(Kp - 1, 0))]  # [n, 4]
    f = row[:, 1].long()
    bv = torch.gather(bins, 1, f[:, None])[:, 0].long()
    goleft = torch.where(bv >= B, row[:, 3] > 0.5, bv <= row[:, 2].long())
    goes = inb & (row[:, 0] > 0.5)
    child = torch.where(goleft, 2 * p + 1, 2 * p + 2)
    return torch.where(goes, child, p)[:, None].to(torch.int32)


def _fused_level_plain(bins, pos, gq: QuantizedGradients, ptab, *, K, Kp, B,
                       d) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: gather partition + index_add_ over int64."""
    if Kp > 0:
        pos = partition_apply(bins, pos, ptab, Kp=Kp, B=B, d=d)
    n, F = bins.shape
    local = pos[:, 0].long() - ((1 << d) - 1)
    b = bins.long()
    keep = ((local >= 0) & (local < K))[:, None] & (b < B)  # [n, F]
    feat = torch.arange(F, device=bins.device)[None, :]
    cell = (feat * (2 * K) + local[:, None]) * B + b  # g cell; h is + K*B
    cell = cell[keep]
    rows = torch.nonzero(keep)[:, 0]
    q = gq.q.long()
    hist = torch.zeros(F * 2 * K * B, dtype=torch.int64, device=bins.device)
    hist.index_add_(0, cell, q[rows, 0])
    hist.index_add_(0, cell + K * B, q[rows, 1])
    return pos, hist.view(F, 2 * K, B)


def _fused_level_cuda(bins, pos, gq: QuantizedGradients, ptab, *, K, Kp, B,
                      d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel A. Checks what the kernel takes and raises otherwise."""
    what = "fused_level"
    for t in (bins, pos, gq.q, ptab):
        _build.require_kernel_device(t, what)
    n, F = bins.shape
    if bins.dtype != torch.uint8:
        raise NotImplementedError(
            f"{what}: the CUDA kernel reads uint8 bins (max_bin <= 254); "
            f"got {bins.dtype}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (n, 1):
        raise ValueError(f"{what}: pos must be int32 [{n}, 1]")
    if gq.q.dtype != torch.int32 or tuple(gq.q.shape) != (n, 2):
        raise ValueError(f"{what}: quantized gradients must be int32 [{n}, 2]")
    if ptab.dtype != torch.float32 or ptab.dim() != 2 or ptab.shape[1] != 4 \
            or ptab.shape[0] < Kp:
        raise ValueError(f"{what}: ptab must be float32 [>= {Kp}, 4]")
    bins, pos, q, ptab = (t.contiguous() for t in (bins, pos, gq.q, ptab))
    pos_out = torch.empty_like(pos)
    hist = torch.zeros((F, 2 * K, B), dtype=torch.int64, device=bins.device)
    prev_offset = (1 << (d - 1)) - 1 if d > 0 else 0
    lib = _build.library("hist_level")
    status = lib.xgbt_fused_level(
        bins.data_ptr(), n, F, B, pos.data_ptr(), pos_out.data_ptr(),
        q.data_ptr(), ptab.data_ptr(), Kp, prev_offset, K, (1 << d) - 1,
        hist.data_ptr(), _build.stream_of(bins.device))
    _build.check_status(status, what)
    fused_level.launches += 1
    return pos_out, hist


def fused_level(bins, pos, gq: QuantizedGradients, ptab, *, K: int, Kp: int,
                B: int, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(new pos [n, 1] int32, hist [F, 2K, B] float32)``, missing
    excluded: kernel A on a CUDA tensor, the plain version on a CPU tensor.
    ``fused_level.launches`` counts kernel A's launches."""
    run = _fused_level_plain if bins.device.type == "cpu" else _fused_level_cuda
    pos, hq = run(bins, pos, gq, ptab, K=K, Kp=Kp, B=B, d=d)
    lane = (torch.arange(2 * K, device=hq.device) >= K).long()
    return pos, gq.dequantize(hq, lane[None, :, None])


fused_level.launches = 0


def leaf_delta(pos: torch.Tensor, leaf_values: torch.Tensor) -> torch.Tensor:
    """Prediction-cache delta: ``leaf_values[pos]`` for every row (the JAX
    package's non-TPU route; exact)."""
    return leaf_values[pos[:, 0].long().clamp(0, leaf_values.shape[0] - 1)]
