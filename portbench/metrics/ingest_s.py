"""Seconds to build both QuantileDMatrix objects, ending in a synchronize (host clock)."""

from portbench.readers import ingest_s as read  # noqa: F401
