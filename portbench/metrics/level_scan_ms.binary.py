"""Host ms of the strict-order scans in _level_update a round in the binary cells (round_detail)."""

from portbench.round_detail import level_scan_ms as read  # noqa: F401
