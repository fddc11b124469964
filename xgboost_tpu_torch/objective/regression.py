"""Regression, binary and count objectives (reference
``src/objective/regression_obj.cu``, ``regression_loss.h``, ``hinge.cu``;
the JAX package's ``objective/regression.py``). Transcendentals and
square roots run in float64 and round once (``base.f64``, ``base.sqrt``),
quotients by a
number through ``base.div``, the rest in float32 in the JAX package's
order of operations."""

from __future__ import annotations

import math

import torch

from .base import ObjFunction, apply_weight, div, f64, param, register, sqrt

__all__ = ["SquaredError", "SquaredLogError", "PseudoHuber", "BinaryLogistic",
           "RegLogistic", "LogitRaw", "Hinge", "Poisson", "GammaDeviance",
           "Tweedie"]

_EPS = 1e-16
_HESS_EPS = 1e-6


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """f32 sigmoid evaluated in float64 and rounded once, so the card and
    the CPU get the same bits (their f32 kernels differ in the last ulp).
    Identical gradients make the grown trees independent of the device,
    down to the ties broken by rounding."""
    return f64(torch.sigmoid, x)


def _exp(x: torch.Tensor) -> torch.Tensor:
    return f64(torch.exp, x)


def _log_margin(base_score: float) -> float:
    return math.log(max(base_score, 1e-16))


@register("reg:squarederror", "reg:linear")
class SquaredError(ObjFunction):
    def get_gradient(self, margin, label, weight, iteration=0, **kw):
        grad = margin - label
        hess = torch.ones_like(margin)
        return apply_weight(grad, hess, weight)

    def default_metric(self):
        return "rmse"


@register("reg:squaredlogerror")
class SquaredLogError(ObjFunction):
    def get_gradient(self, margin, label, weight, iteration=0, **kw):
        p = torch.clamp(margin, min=-1 + 1e-6)
        d = f64(torch.log1p, p) - f64(torch.log1p, label)
        p1 = p + 1.0
        grad = d / p1
        hess = torch.clamp((-d + 1.0) / (p1 * p1), min=_HESS_EPS)
        return apply_weight(grad, hess, weight)

    def default_metric(self):
        return "rmsle"


@register("reg:pseudohubererror")
class PseudoHuber(ObjFunction):
    def get_gradient(self, margin, label, weight, iteration=0, **kw):
        slope = param(self.params, "huber_slope", 1.0)
        z = margin - label
        t = div(z, slope)
        scale = 1.0 + t * t
        sqrt_s = sqrt(scale)
        grad = z / sqrt_s
        hess = div(1.0, scale * sqrt_s)
        return apply_weight(grad, hess, weight)

    def default_metric(self):
        return "mphe"


class _LogisticBase(ObjFunction):
    """The logistic gradient shared by ``binary:logistic``,
    ``reg:logistic`` and ``binary:logitraw``."""

    def get_gradient(self, margin, label, weight, iteration=0, **kw):
        p = _sigmoid(margin)
        grad = p - label
        hess = torch.clamp(p * (1.0 - p), min=_EPS)
        spw = param(self.params, "scale_pos_weight", 1.0)
        if spw != 1.0:
            w = torch.where(label == 1.0, spw, 1.0).to(grad.dtype)
            grad, hess = grad * w, hess * w
        return apply_weight(grad, hess, weight)

    def prob_to_margin(self, base_score):
        base_score = min(max(base_score, 1e-7), 1 - 1e-7)
        return -math.log(1.0 / base_score - 1.0)

    def pred_transform(self, margin):
        return _sigmoid(margin)


@register("binary:logistic")
class BinaryLogistic(_LogisticBase):
    def default_metric(self):
        return "logloss"


@register("reg:logistic")
class RegLogistic(_LogisticBase):
    def default_metric(self):
        return "rmse"


@register("binary:logitraw")
class LogitRaw(_LogisticBase):
    def pred_transform(self, margin):
        return margin

    def default_metric(self):
        return "logloss"


@register("binary:hinge")
class Hinge(ObjFunction):
    def get_gradient(self, margin, label, weight, iteration=0, **kw):
        y = 2.0 * label - 1.0
        active = y * margin < 1.0
        grad = torch.where(active, -y, torch.zeros_like(y))
        hess = torch.where(active, torch.ones_like(y),
                           torch.full_like(y, _HESS_EPS))
        return apply_weight(grad, hess, weight)

    def pred_transform(self, margin):
        return (margin > 0.0).to(torch.float32)

    def default_metric(self):
        return "error"


@register("count:poisson")
class Poisson(ObjFunction):
    def _max_delta_step(self) -> float:
        """The objective's own ``max_delta_step`` (regression_obj.cu:197:
        default 0.7, fed from the same key as the tree parameter's): a
        value the caller set wins, 0 included."""
        p = self.params
        if p is not None:
            v = getattr(p, "max_delta_step", None)
            if v is not None and (not hasattr(p, "is_explicit")
                                  or p.is_explicit("max_delta_step")):
                return float(v)
        return 0.7

    def get_gradient(self, margin, label, weight, iteration=0, **kw):
        grad = _exp(margin) - label
        # exp(p + max_delta_step): the capped step's hessian inflation
        # (regression_obj.cu:249)
        hess = _exp(margin + self._max_delta_step())
        return apply_weight(grad, hess, weight)

    def pred_transform(self, margin):
        return _exp(margin)

    def prob_to_margin(self, base_score):
        return _log_margin(base_score)

    def default_metric(self):
        return "poisson-nloglik"


@register("reg:gamma")
class GammaDeviance(ObjFunction):
    def get_gradient(self, margin, label, weight, iteration=0, **kw):
        expm = _exp(-margin)
        grad = 1.0 - label * expm
        hess = torch.clamp(label * expm, min=_EPS)
        return apply_weight(grad, hess, weight)

    def pred_transform(self, margin):
        return _exp(margin)

    def prob_to_margin(self, base_score):
        return _log_margin(base_score)

    def default_metric(self):
        return "gamma-nloglik"


@register("reg:tweedie")
class Tweedie(ObjFunction):
    def _rho(self) -> float:
        return param(self.params, "tweedie_variance_power", 1.5)

    def get_gradient(self, margin, label, weight, iteration=0, **kw):
        rho = self._rho()
        e1 = _exp((1.0 - rho) * margin)
        e2 = _exp((2.0 - rho) * margin)
        grad = -label * e1 + e2
        hess = torch.clamp(-label * (1.0 - rho) * e1 + (2.0 - rho) * e2,
                           min=_EPS)
        return apply_weight(grad, hess, weight)

    def pred_transform(self, margin):
        return _exp(margin)

    def prob_to_margin(self, base_score):
        return _log_margin(base_score)

    def default_metric(self):
        return f"tweedie-nloglik@{self._rho()}"


# every objective here is elementwise (the JAX package's scan-safe set)
for _cls in (SquaredError, SquaredLogError, PseudoHuber, BinaryLogistic,
             RegLogistic, LogitRaw, Hinge, Poisson, GammaDeviance, Tweedie):
    _cls.scan_safe = True
del _cls
