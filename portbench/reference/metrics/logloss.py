"""``logloss`` of one output: the mean of ``-(y log p + (1 - y) log(1 - p))``
in float64, ``p = sigmoid(margin)`` rounded to the margin's type and
clipped to ``[1e-7, 1 - 1e-7]`` in that type. In float32, 1 - 1e-7 is
1 - 2**-23, so a row whose probability rounds to 1 against its label
loses 23 log 2, not log 1e7."""

from __future__ import annotations

import torch

F64 = torch.float64


def logloss(p: torch.Tensor, y: torch.Tensor) -> float:
    q = torch.clamp(p, 1e-7, 1.0 - 1e-7).to(F64)
    yy = y.to(F64)
    return float((-(yy * torch.log(q) + (1.0 - yy) * torch.log(1.0 - q))).mean())


def evaluate(margin: torch.Tensor, y: torch.Tensor, sizes, arg) -> float:
    m = margin[:, 0]
    return logloss(torch.sigmoid(m.to(F64)).to(m.dtype), y)
