from . import multiclass, ranking, regression, survival  # noqa: F401  (registers)
from .base import ObjFunction, create_objective

__all__ = ["ObjFunction", "create_objective"]
