"""Structured span tracing: host-side timeline -> Chrome trace-event JSONL.

The port of the JAX package's ``observability/trace.py``: a
``span("build_tree", iteration=i)`` context manager records a Chrome
trace-event "X" (complete) event, viewable in Perfetto or
``chrome://tracing``, into an in-memory ring buffer, flushed to the path
named by ``XGBTPU_TRACE=<path>`` or ``set_config(trace_path=...)``. The
span names, the nesting and the file format are the JAX package's, so one
reader serves both packages' traces.

- **Near-zero cost when disabled**: ``span()`` performs one enabled check
  (an environment read and a thread-local dict get) and returns a shared
  no-op context manager: no allocation, no clock read.
- **Host-side only**: a span reads the host clock at its two ends and
  nothing else. It never synchronizes the device and launches nothing, so
  a traced run issues the same kernels and device operations as an
  untraced one; what a span measures is the host's view (argument
  preparation, launches, and the waits that the code itself makes).
  Device time is ``torch.profiler``'s (``utils.timer.profiler_context``,
  the flight recorder's ``XGBTPU_PROFILE`` window).
- **Ring buffered**: the newest ``XGBTPU_TRACE_BUFFER`` (default 65536)
  events are kept; older ones are dropped and counted in the
  ``trace_events_dropped_total`` metric. ``flush()`` drains the buffer to
  disk (appending), and runs at interpreter exit.

File format: a Chrome trace-event JSON array written one event per line
(the spec's trailing-``]``-optional form, which Perfetto and
``chrome://tracing`` load), so the file doubles as JSONL: each event line
(less its trailing comma) is a JSON object, and ``load_trace`` parses any
prefix of a partly written file. A run of several processes writes one
file per rank (``<path>.rank<r>``, the rank from ``collective.get_rank()``),
with the rank as the Chrome ``pid``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "span", "instant", "emit", "emit_async", "emit_async_track",
    "enabled", "trace_path", "flush", "reset", "load_trace",
    "clock_base", "set_sink",
]

_ENV_PATH = "XGBTPU_TRACE"
_ENV_BUFFER = "XGBTPU_TRACE_BUFFER"

_lock = threading.RLock()
_buffer: "collections.deque[Dict[str, Any]]" = collections.deque(
    maxlen=max(int(os.environ.get(_ENV_BUFFER, "65536") or 65536), 16))
_dropped = 0
_headers_written: set = set()
_tid_map: Dict[int, int] = {}
_sink: Optional[str] = None  # the flight recorder's sink (flight.py)
_config_state = None  # config._state, bound by the first trace_path()
# the two clock reads are adjacent on purpose: _EPOCH_UNIX_NS is the
# wall-clock instant at which event timestamps are 0, the per-rank clock
# base a cross-rank merge aligns on
_EPOCH_NS = time.perf_counter_ns()
_EPOCH_UNIX_NS = time.time_ns()


def clock_base() -> Dict[str, Any]:
    """The mapping from this process's event timestamps to wall-clock
    time: an event's ``ts`` (microseconds) is relative to ``unix_ns``.
    The flight recorder keeps it per rank (``obs/rank<k>/clock.json``)."""
    return {"unix_ns": _EPOCH_UNIX_NS, "ts_unit": "us"}


def set_sink(path: Optional[str]) -> None:
    """Install (or clear) a process-wide fallback trace destination, the
    flight recorder's per-rank ``trace.jsonl``. Explicit choices
    (``XGBTPU_TRACE``, ``set_config(trace_path=...)``) still win, and a
    sink path is written as it is (no ``.rank<r>`` suffix: the sink is
    already per rank)."""
    global _sink
    with _lock:
        _sink = path


def trace_path() -> Optional[str]:
    """The active trace destination, or None when tracing is off. The
    ``XGBTPU_TRACE`` environment variable wins; otherwise the
    (thread-local) ``set_config(trace_path=...)`` value, then the sink."""
    global _config_state
    p = os.environ.get(_ENV_PATH)
    if p:
        return p
    if _config_state is None:
        # bound once; a direct read of the state: no per-span dict copy
        from ..config import _state as _config_state
    return _config_state().get("trace_path") or _sink or None


def enabled() -> bool:
    return trace_path() is not None


def _rank_world() -> tuple:
    """(rank, world) of the initialised ``torch.distributed`` world, (0, 1)
    without one (a dictionary read: no collective)."""
    from .. import collective

    return collective.get_rank(), collective.get_world_size()


def _tid() -> int:
    ident = threading.get_ident()
    t = _tid_map.get(ident)
    if t is None:
        with _lock:
            t = _tid_map.setdefault(ident, len(_tid_map))
    return t


def _record(ev: Dict[str, Any]) -> None:
    global _dropped
    with _lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
            from .metrics import REGISTRY

            REGISTRY.counter(
                "trace_events_dropped_total",
                "Trace events evicted from the ring buffer before flush",
            ).inc()
        _buffer.append(ev)


class _Span:
    """An open span; records one Chrome 'X' (complete) event on exit."""

    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        ev = {
            "name": self.name,
            "ph": "X",
            "ts": (self._t0 - _EPOCH_NS) // 1000,
            "dur": max((t1 - self._t0) // 1000, 1),
            "tid": _tid(),
        }
        if self.args:
            ev["args"] = self.args
        _record(ev)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP = _NoopSpan()


def span(name: str, **args: Any):
    """Context manager timing a host-side phase. ``args`` become the
    event's Chrome ``args`` payload (keep them JSON scalars, never tensor
    values: reading one would synchronize the device). Disabled, it
    returns a shared no-op."""
    if not enabled():
        return _NOOP
    return _Span(name, args)


def emit(name: str, start_ns: int, end_ns: int, cat: Optional[str] = None,
         **args: Any) -> None:
    """Record a complete event from a measured ``perf_counter_ns``
    interval, for instrumentation that owns its clock reads
    (``utils.timer.Monitor``). ``cat`` becomes the Chrome category."""
    if not enabled():
        return
    ev = {
        "name": name,
        "ph": "X",
        "ts": (start_ns - _EPOCH_NS) // 1000,
        "dur": max((end_ns - start_ns) // 1000, 1),
        "tid": _tid(),
    }
    if cat:
        ev["cat"] = cat
    if args:
        ev["args"] = args
    _record(ev)


def emit_async(name: str, track: str, start_ns: int, end_ns: int,
               cat: str = "serving", **args: Any) -> None:
    """Record one nestable-async span (Chrome phases 'b'/'e') on the track
    keyed ``(cat, track)``: Perfetto draws every event sharing that key as
    one async lane, whichever thread recorded it."""
    emit_async_track(track, [(name, start_ns, end_ns, args or None)],
                     cat=cat)


def emit_async_track(track: str, spans: List[tuple],
                     cat: str = "serving") -> None:
    """Batched :func:`emit_async`: every ``(name, start_ns, end_ns,
    args-or-None)`` of ``spans`` lands on the ``(cat, track)`` lane with
    one enabled check and one lock acquisition."""
    if not spans or not enabled():
        return
    tid = _tid()
    sid = str(track)
    epoch = _EPOCH_NS
    events: List[Dict[str, Any]] = []
    push = events.append
    for name, start_ns, end_ns, args in spans:
        ts0 = (start_ns - epoch) // 1000
        ts1 = (end_ns - epoch) // 1000
        begin: Dict[str, Any] = {"name": name, "ph": "b", "cat": cat,
                                 "id": sid, "ts": ts0, "tid": tid}
        if args:
            begin["args"] = args
        push(begin)
        push({"name": name, "ph": "e", "cat": cat, "id": sid,
              "ts": ts1 if ts1 > ts0 else ts0 + 1, "tid": tid})
    global _dropped
    dropped = 0
    with _lock:
        for ev in events:
            if len(_buffer) == _buffer.maxlen:
                dropped += 1
            _buffer.append(ev)
        _dropped += dropped
    if dropped:
        from .metrics import REGISTRY

        REGISTRY.counter(
            "trace_events_dropped_total",
            "Trace events evicted from the ring buffer before flush",
        ).inc(dropped)


def instant(name: str, **args: Any) -> None:
    """A zero-duration marker event (Chrome phase 'i')."""
    if not enabled():
        return
    ev = {
        "name": name,
        "ph": "i",
        "s": "t",
        "ts": (time.perf_counter_ns() - _EPOCH_NS) // 1000,
        "tid": _tid(),
    }
    if args:
        ev["args"] = args
    _record(ev)


def _out_path(path: str) -> str:
    if path == _sink:
        return path  # the sink is already a per-rank destination
    rank, world = _rank_world()
    return f"{path}.rank{rank}" if world > 1 else path


def flush(path: Optional[str] = None) -> Optional[str]:
    """Drain the ring buffer to ``path`` (default: the active trace path),
    appending to earlier flushes. Returns the written path, or None when
    tracing is off and no path was given."""
    path = path or trace_path()
    if path is None:
        return None
    path = _out_path(path)
    with _lock:
        events = list(_buffer)
        _buffer.clear()
        need_header = path not in _headers_written
        _headers_written.add(path)
    if need_header:
        try:
            need_header = os.path.getsize(path) == 0
        except OSError:
            need_header = True
    rank, _ = _rank_world()
    with open(path, "a") as f:
        if need_header:
            f.write("[\n")
            meta = {
                "name": "process_name", "ph": "M", "pid": rank, "tid": 0,
                "args": {"name": f"xgboost_tpu_torch rank {rank}"},
            }
            f.write(json.dumps(meta) + ",\n")
        for ev in events:
            ev.setdefault("pid", rank)
            f.write(json.dumps(ev) + ",\n")
    return path


def reset() -> None:
    """Clear buffered events and per-path header state (tests)."""
    global _dropped
    with _lock:
        _buffer.clear()
        _headers_written.clear()
        _dropped = 0


def dropped_count() -> int:
    return _dropped


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Parse a trace file written by ``flush`` (or any Chrome trace-event
    JSON: a complete array, a trailing-comma or unterminated array, JSONL,
    or a ``{"traceEvents": [...]}`` wrapper) into a list of event dicts."""
    with open(path) as f:
        text = f.read().strip()
    if not text:
        return []
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if doc is None and text.startswith("["):
        # the spec's unterminated-array form: close it
        doc = json.loads(text.rstrip().rstrip(",") + "\n]")
    if isinstance(doc, dict):
        doc = doc.get("traceEvents", [])
    if doc is None:
        # JSONL: one event object per line
        doc = [json.loads(ln.rstrip(",")) for ln in text.splitlines()
               if ln.strip() and ln.strip() not in ("[", "]")]
    if not isinstance(doc, list) or not all(
            isinstance(e, dict) for e in doc):
        raise ValueError(f"{path}: not a Chrome trace event file")
    return doc


import atexit  # noqa: E402

atexit.register(lambda: flush() if enabled() and len(_buffer) else None)
