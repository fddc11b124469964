from . import auc, elementwise, multiclass, rank, survival  # noqa: F401  (registers)
from .base import Metric, create_metric

__all__ = ["Metric", "create_metric"]
