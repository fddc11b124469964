"""Seconds from the process's start to the window's opening (host clock)."""

from portbench.readers import setup_s as read  # noqa: F401
