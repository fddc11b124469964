"""``binary:logistic``: one output; ``p = sigmoid(margin)``, ``g = p - y``,
``h = max(p (1 - p), 1e-16)``, in float64. Rows start from the logit of
``base_score`` (0.5 unless the configuration sets it)."""

from __future__ import annotations

import math

import torch

from portbench.work import Work

F64 = torch.float64


def outputs(params: dict) -> int:
    return 1


def base_margin(params: dict) -> float:
    b = float(params.get("base_score", 0.5))
    return math.log(b / (1.0 - b))


def logistic(margin: torch.Tensor, y: torch.Tensor):
    p = torch.sigmoid(margin.to(F64))
    return p - y.to(F64), torch.clamp(p * (1.0 - p), min=1e-16)


def gradient(margin: torch.Tensor, y: torch.Tensor, sizes, iteration: int):
    """``(g, h)`` [n, 1] float64 at the margins ``margin`` [n, 1]."""
    g, h = logistic(margin[:, 0], y)
    return g[:, None], h[:, None]


def work(n: int, groups: int) -> Work:
    """Reads a margin and a label, writes (g, h): 16 bytes and 6
    operations a row."""
    return Work(16 * n, 6 * n)
