from . import regression  # noqa: F401  (registers the objectives)
from .base import ObjFunction, create_objective

__all__ = ["ObjFunction", "create_objective"]
