"""Split gain / leaf weight math (reference ``src/tree/param.h:228-275``).

- ``threshold_l1(w, alpha)`` soft-threshold for L1 regularization
- ``calc_weight`` = -ThresholdL1(G)/(H+lambda), clamped by max_delta_step
- ``calc_gain``  = ThresholdL1(G)^2/(H+lambda) (max_delta_step == 0 path),
  else -(2*G*w + (H+lambda)*w^2) with the clamped weight
- ``calc_gain_given_weight`` = -(2*G*w + (H+lambda)*w^2) for a given ``w``
  (the monotone-constrained gain, reference param.h CalcGainGivenWeight)

Plain elementwise torch, the same operations in the same order as the JAX
package's ``tree/param.py``, so they vectorize over [nodes, features, bins].
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["RT_EPS", "SplitParams", "threshold_l1", "calc_weight", "calc_gain",
           "calc_gain_given_weight"]

# reference: kRtEps in src/common/math.h — minimum loss_chg to accept a split
RT_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SplitParams:
    reg_lambda: float = 1.0
    reg_alpha: float = 0.0
    max_delta_step: float = 0.0
    min_child_weight: float = 1.0
    min_split_loss: float = 0.0


def threshold_l1(g: torch.Tensor, alpha: float) -> torch.Tensor:
    if alpha == 0.0:
        return g
    return torch.sign(g) * torch.clamp(torch.abs(g) - alpha, min=0.0)


def calc_weight(G: torch.Tensor, H: torch.Tensor, p: SplitParams) -> torch.Tensor:
    # a node whose hessian mass is below min_child_weight (or non-positive)
    # gets weight 0 (reference param.h:249)
    denom = H + p.reg_lambda
    w = torch.where(denom > 0.0,
                    -threshold_l1(G, p.reg_alpha) / torch.clamp(denom, min=1e-38),
                    torch.zeros_like(G))
    if p.max_delta_step > 0.0:
        w = torch.clamp(w, -p.max_delta_step, p.max_delta_step)
    return torch.where((H < p.min_child_weight) | (H <= 0.0), torch.zeros_like(w), w)


def calc_gain(G: torch.Tensor, H: torch.Tensor, p: SplitParams) -> torch.Tensor:
    # gain is 0 below min_child_weight (reference param.h:262)
    denom = H + p.reg_lambda
    if p.max_delta_step == 0.0:
        t = threshold_l1(G, p.reg_alpha)
        g = torch.where(denom > 0.0, t * t / torch.clamp(denom, min=1e-38),
                        torch.zeros_like(G))
    else:
        w = calc_weight(G, H, p)
        g = -(2.0 * G * w + denom * w * w)
    return torch.where(H < p.min_child_weight, torch.zeros_like(g), g)


def calc_gain_given_weight(G: torch.Tensor, H: torch.Tensor, w: torch.Tensor,
                           p: SplitParams) -> torch.Tensor:
    denom = H + p.reg_lambda
    return -(2.0 * G * w + denom * w * w)
