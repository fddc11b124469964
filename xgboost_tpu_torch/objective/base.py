"""ObjFunction base class (reference: ``include/xgboost/objective.h``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import torch

__all__ = ["ObjFunction", "create_objective", "apply_weight", "register"]

_REGISTRY: Dict[str, Type["ObjFunction"]] = {}


def register(*names: str):
    def deco(cls):
        for n in names:
            _REGISTRY[n] = cls
        return cls
    return deco


class ObjFunction:
    """Gradient/hessian provider. Shapes: margin [n]."""

    name: str = ""

    def __init__(self, params=None):
        self.params = params

    def n_targets(self) -> int:
        return 1

    def get_gradient(self, margin: torch.Tensor, label: torch.Tensor,
                     weight: Optional[torch.Tensor], iteration: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    # margin -> user-facing prediction (reference: PredTransform)
    def pred_transform(self, margin: torch.Tensor) -> torch.Tensor:
        return margin

    def eval_transform(self, margin: torch.Tensor) -> torch.Tensor:
        return self.pred_transform(margin)

    # base_score (prob space) -> initial margin (reference: ProbToMargin)
    def prob_to_margin(self, base_score: float) -> float:
        return base_score

    def default_base_score(self) -> float:
        return 0.5

    def default_metric(self) -> str:
        return "rmse"


def create_objective(name: str, params=None) -> ObjFunction:
    cls = _REGISTRY.get(name)
    if cls is None:
        raise NotImplementedError(
            f"objective {name!r} is not ported yet; the port has "
            f"{sorted(_REGISTRY)}")
    obj = cls(params)
    obj.name = name
    return obj


def apply_weight(grad: torch.Tensor, hess: torch.Tensor,
                 weight: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    if weight is None:
        return grad, hess
    return grad * weight, hess * weight
