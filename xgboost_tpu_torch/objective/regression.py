"""Regression / binary objectives (reference
``src/objective/regression_obj.cu``; the JAX package's
``objective/regression.py``)."""

from __future__ import annotations

import math

import torch

from .base import ObjFunction, apply_weight, register

__all__ = ["SquaredError", "BinaryLogistic"]

_EPS = 1e-16


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """f32 sigmoid evaluated in float64 and rounded once, so the card and
    the CPU get the same bits (their f32 kernels differ in the last ulp).
    Identical gradients make the grown trees independent of the device,
    down to the ties broken by rounding."""
    return torch.sigmoid(x.double()).to(x.dtype)


@register("reg:squarederror", "reg:linear")
class SquaredError(ObjFunction):
    def get_gradient(self, margin, label, weight, iteration=0):
        grad = margin - label
        hess = torch.ones_like(margin)
        return apply_weight(grad, hess, weight)

    def default_metric(self):
        return "rmse"


@register("binary:logistic")
class BinaryLogistic(ObjFunction):
    def get_gradient(self, margin, label, weight, iteration=0):
        p = _sigmoid(margin)
        grad = p - label
        hess = torch.clamp(p * (1.0 - p), min=_EPS)
        spw = getattr(self.params, "scale_pos_weight", 1.0) if self.params else 1.0
        if spw != 1.0:
            w = torch.where(label == 1.0, spw, 1.0).to(grad.dtype)
            grad, hess = grad * w, hess * w
        return apply_weight(grad, hess, weight)

    def prob_to_margin(self, base_score):
        base_score = min(max(base_score, 1e-7), 1 - 1e-7)
        return -math.log(1.0 / base_score - 1.0)

    def pred_transform(self, margin):
        return _sigmoid(margin)

    def default_metric(self):
        return "logloss"
