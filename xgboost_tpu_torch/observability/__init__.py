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
  ``run_dir/obs/rank<k>/`` sink, black-box dumps, the profiling window);
- ``kernelprof``: the per-level grow profiler on sampled rounds
  (``XGBTPU_KERNEL_PROF``) and the ``grow-report`` renderer;
- ``ledger``: the banked perf ledger (``BENCH_r*.json``, schema
  ``bench-bank-v1``) and the ``perf-report`` renderer.

``kernelprof`` and ``ledger`` import only the standard library at module
scope; the profiler loads torch and the tree machinery at its first
sampled round.

A call site costs an environment read and a dict get when tracing is off,
and nothing here reads a tensor: no span or record synchronizes the
device.
"""

from . import comms, metrics, trace  # noqa: F401
from . import flight  # noqa: F401  (after trace/metrics: it builds on both)
from . import kernelprof, ledger  # noqa: F401  (standard library only)
from .flight import RECORDER  # noqa: F401
from .metrics import REGISTRY, MetricsRegistry, get_registry  # noqa: F401
from .trace import (emit, enabled, flush, instant, load_trace,  # noqa: F401
                    span, trace_path)

__all__ = [
    "trace", "metrics", "comms", "flight", "kernelprof", "ledger",
    "span", "instant", "emit", "enabled", "flush", "trace_path",
    "load_trace",
    "REGISTRY", "MetricsRegistry", "get_registry", "RECORDER",
]
