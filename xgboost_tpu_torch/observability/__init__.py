"""Telemetry: span tracing, the metrics registry, collective accounting and
the flight recorder (the port of the JAX package's ``observability``).

- ``trace``: ``span("build_tree", iteration=i)`` context managers writing a
  Chrome trace-event timeline (Perfetto, ``chrome://tracing``), on with
  ``XGBTPU_TRACE=<path>`` or ``set_config(trace_path=...)``;
- ``metrics``: the process-wide ``REGISTRY`` of counters, gauges and
  histograms, with Prometheus text exposition and JSON snapshots
  (``utils.timer.Monitor`` feeds it);
- ``comms``: operations and bytes of every collective per call site and
  kind (``collective.py``), the port's one record of them;
- ``flight``: the always-on per-round flight recorder (ring buffer, the
  ``run_dir/obs/rank<k>/`` sink, black-box dumps, the profiling window).

A call site costs an environment read and a dict get when tracing is off,
and nothing here reads a tensor: no span or record synchronizes the
device.
"""

from . import comms, metrics, trace  # noqa: F401
from . import flight  # noqa: F401  (after trace/metrics: it builds on both)
from .flight import RECORDER  # noqa: F401
from .metrics import REGISTRY, MetricsRegistry, get_registry  # noqa: F401
from .trace import (emit, enabled, flush, instant, load_trace,  # noqa: F401
                    span, trace_path)

__all__ = [
    "trace", "metrics", "comms", "flight",
    "span", "instant", "emit", "enabled", "flush", "trace_path",
    "load_trace",
    "REGISTRY", "MetricsRegistry", "get_registry", "RECORDER",
]
