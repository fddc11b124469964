"""Elementwise metrics (reference ``src/metric/elementwise_metric.cu``)."""

from __future__ import annotations

import math

import torch

from .base import ElementwiseMetric, register

__all__ = ["RMSE", "LogLoss", "BinaryError"]


@register("rmse")
class RMSE(ElementwiseMetric):
    name = "rmse"

    def loss(self, p, y):
        return (p - y) ** 2

    def finalize(self, s, w):
        return math.sqrt(s if w == 0 else s / w)


@register("logloss")
class LogLoss(ElementwiseMetric):
    name = "logloss"

    def loss(self, p, y):
        # the product form with an f32-representable clamp (1 - 1e-16 would
        # round to 1.0 in f32 and 0 * log(0) = nan)
        eps = 1e-7
        p = torch.clamp(p, eps, 1.0 - eps)
        return -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))


@register("error")
class BinaryError(ElementwiseMetric):
    name = "error"

    def __init__(self, threshold: float = 0.5):
        self.t = threshold

    def loss(self, p, y):
        return ((p > self.t) != (y > 0.5)).to(torch.float32)
