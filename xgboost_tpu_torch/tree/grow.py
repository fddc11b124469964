"""Split evaluation for the depthwise grower.

The port of the numerical branch of the JAX package's ``tree/grow.py``
(reference ``hist/evaluate_splits.h:61``, ``gpu_hist/evaluate_splits.cu``):
cumulative G/H over bins for both missing-direction hypotheses, the
min_child_weight and feature masks, and a first-maximum argmax of loss_chg
per node over the flattened ``[2, F, B]`` scores (missing-right first).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .param import SplitParams, calc_gain, calc_weight

__all__ = ["GrowParams", "SplitDecision", "seq_cumsum", "eval_splits"]


@dataclasses.dataclass(frozen=True)
class GrowParams:
    """Static hyper-parameters of the depthwise grower (numerical, no
    constraints, no sampling: those raise earlier, in the booster)."""

    max_depth: int = 6
    split: SplitParams = SplitParams()

    @property
    def max_nodes(self) -> int:
        return (1 << (self.max_depth + 1)) - 1


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis with STRICT left-to-right f32
    association (((0+x0)+x1)+...), the order of the JAX package's
    ``seq_cumsum``. ``torch.cumsum`` accumulates f32 in double on the CPU
    and as a parallel scan on CUDA, so neither may stand in for it."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for b in range(x.shape[-1]):
        acc = acc + x[..., b]
        out[..., b] = acc
    return out


class SplitDecision(NamedTuple):
    """Best split per node row (all [K])."""

    loss: torch.Tensor  # loss_chg of the winner (-inf if none valid)
    dir: torch.Tensor  # 1 = missing goes left
    f: torch.Tensor
    b: torch.Tensor
    GL: torch.Tensor  # left-child stats of the winner (missing per dir)
    HL: torch.Tensor
    w_node: torch.Tensor


def eval_splits(hist: torch.Tensor, Gtot: torch.Tensor, Htot: torch.Tensor,
                p: SplitParams, node_fmask: torch.Tensor, B: int
                ) -> SplitDecision:
    """``hist`` [K, F, B+1, 2] (bin B = missing) -> the best split per node."""
    K, F = hist.shape[0], hist.shape[1]
    g_b, h_b = hist[:, :, :B, 0], hist[:, :, :B, 1]
    g_miss, h_miss = hist[:, :, B, 0], hist[:, :, B, 1]
    GL, HL = seq_cumsum(torch.stack([g_b, h_b]))
    # dir 0: missing goes right (default_left=False); dir 1: missing left
    GLd = torch.stack([GL, GL + g_miss[..., None]], dim=1)  # [K, 2, F, B]
    HLd = torch.stack([HL, HL + h_miss[..., None]], dim=1)
    GRd = Gtot[:, None, None, None] - GLd
    HRd = Htot[:, None, None, None] - HLd
    gain = calc_gain(GLd, HLd, p) + calc_gain(GRd, HRd, p)
    w_node = calc_weight(Gtot, Htot, p)
    parent_gain = calc_gain(Gtot, Htot, p)
    chg = gain - parent_gain[:, None, None, None]
    valid = (HLd >= p.min_child_weight) & (HRd >= p.min_child_weight)
    valid = valid & node_fmask[:, None, :, None]
    score = torch.where(valid, chg, torch.full_like(chg, float("-inf")))
    flat = score.reshape(K, -1)
    best_idx = torch.argmax(flat, dim=1)  # first maximum, as jnp.argmax

    def pick(a):
        return torch.gather(a.reshape(K, -1), 1, best_idx[:, None])[:, 0]

    FB = F * B
    return SplitDecision(
        loss=pick(score),
        dir=(best_idx // FB).to(torch.int32),
        f=((best_idx % FB) // B).to(torch.int32),
        b=((best_idx % FB) % B).to(torch.int32),
        GL=pick(GLd),
        HL=pick(HLd),
        w_node=w_node,
    )
