"""Host-blocked ms of _level_update a round in the ranking cells (the grow profiler's spans)."""

from portbench.readers import level_update_ms as read  # noqa: F401
