from . import auc, elementwise  # noqa: F401  (registers the metrics)
from .base import Metric, create_metric

__all__ = ["Metric", "create_metric"]
