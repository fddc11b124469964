"""Round time of the ranking cells (host clock): the window over its rounds, ms."""

from portbench.readers import round_ms as read  # noqa: F401
