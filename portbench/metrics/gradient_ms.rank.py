"""Ms of the round's gradient in the ranking cells (round_detail)."""

from portbench.round_detail import gradient_ms as read  # noqa: F401
