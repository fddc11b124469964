"""Ms of the held-out rows' metrics a round in the binary cells (round_detail)."""

from portbench.round_detail import eval_metric_ms as read  # noqa: F401
