"""Elementwise metrics (reference ``src/metric/elementwise_metric.cu``,
registrations at :386-426; the JAX package's ``metric/elementwise.py``)."""

from __future__ import annotations

import math

import torch

from .base import ElementwiseMetric, register

__all__ = ["RMSE", "RMSLE", "MAE", "MAPE", "MPHE", "LogLoss", "BinaryError",
           "PoissonNLogLik", "GammaDeviance", "GammaNLogLik",
           "TweedieNLogLik"]

_EPS = 1e-16


@register("rmse")
class RMSE(ElementwiseMetric):
    name = "rmse"

    def loss(self, p, y):
        return (p - y) ** 2

    def finalize(self, s, w):
        return math.sqrt(s if w == 0 else s / w)


@register("rmsle")
class RMSLE(RMSE):
    name = "rmsle"

    def loss(self, p, y):
        d = torch.log1p(torch.clamp(p, min=-1 + 1e-6)) - torch.log1p(y)
        return d * d


@register("mae")
class MAE(ElementwiseMetric):
    name = "mae"

    def loss(self, p, y):
        return torch.abs(p - y)


@register("mape")
class MAPE(ElementwiseMetric):
    name = "mape"

    def loss(self, p, y):
        return torch.abs((y - p) / torch.clamp(torch.abs(y), min=_EPS))


@register("mphe")
class MPHE(ElementwiseMetric):
    name = "mphe"

    def loss(self, p, y):
        z = p - y
        return torch.sqrt(1.0 + z * z) - 1.0


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


@register("error@")
class BinaryErrorAt(BinaryError):
    def __init__(self, arg: str, full_name: str = ""):
        super().__init__(float(arg))
        self.name = full_name or f"error@{arg}"


@register("poisson-nloglik")
class PoissonNLogLik(ElementwiseMetric):
    name = "poisson-nloglik"

    def loss(self, p, y):
        p = torch.clamp(p, min=_EPS)
        return p - y * torch.log(p) + torch.lgamma(y + 1.0)


@register("gamma-deviance")
class GammaDeviance(ElementwiseMetric):
    name = "gamma-deviance"

    def loss(self, p, y):
        e = _EPS
        return torch.log(p + e) - torch.log(y + e) + y / (p + e) - 1.0

    def finalize(self, s, w):
        return 2.0 * (s if w == 0 else s / w)


@register("gamma-nloglik")
class GammaNLogLik(ElementwiseMetric):
    name = "gamma-nloglik"

    def loss(self, p, y):
        # shape psi = 1 (elementwise_metric.cu EvalGammaNLogLik): theta =
        # -1/p, b(theta) = log p, c(y, 1) = 0, so nloglik = y/p + log(p)
        p = torch.clamp(p, min=_EPS)
        return y / p + torch.log(p)


@register("tweedie-nloglik@", "tweedie-nloglik")
class TweedieNLogLik(ElementwiseMetric):
    def __init__(self, arg: str = "1.5", full_name: str = ""):
        self.rho = float(arg)
        self.name = full_name or f"tweedie-nloglik@{arg}"

    def loss(self, p, y):
        rho = self.rho
        p = torch.clamp(p, min=_EPS)
        a = y * torch.pow(p, 1.0 - rho) / (1.0 - rho)
        b = torch.pow(p, 2.0 - rho) / (2.0 - rho)
        return -a + b
