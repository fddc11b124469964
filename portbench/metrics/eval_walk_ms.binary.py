"""Ms of the held-out rows' walk (kernel B) a round in the binary cells (round_detail)."""

from portbench.round_detail import eval_walk_ms as read  # noqa: F401
