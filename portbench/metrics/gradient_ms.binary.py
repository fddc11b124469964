"""Ms of the round's gradient in the binary cells (round_detail)."""

from portbench.round_detail import gradient_ms as read  # noqa: F401
