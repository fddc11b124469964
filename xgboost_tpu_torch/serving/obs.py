"""Request-scope serving observability: traces, access log, flight ring,
SLO ledger (the port of the JAX package's ``serving/obs.py``, over the
port's ``observability.{flight,trace,metrics}``).

Between ``ModelServer.predict_async`` and the resolved future a request
crosses admission, the bounded queue, the coalescing window and one
batched dispatch; when it is shed or slow, the operator needs *that
request's* record. One :class:`ServingRecorder` per server holds:

- **request records**: every request carries an id (caller-supplied or
  generated) from admission to completion. Completion emits one
  **access-log** JSON line (id, model@version, rows, route, per-stage
  waits, outcome ok/shed/error, shed reason, deadline) and, when tracing
  is live, one nestable-async Chrome track per request (queue_wait ->
  batch_wait -> dispatch) plus the dispatch's own span linking the
  coalesced ids. The request path pays the completion stamps and one
  enqueue; serialization, file I/O and spans run on a writer thread
  (``drain()`` is the read barrier, taken by ``stats`` and ``close``).
- **dispatch flight ring**: per-dispatch records (rows, coalesced
  request count, bucket, route, seconds, arena bytes, queue depth; no
  program-cache counts: nothing is compiled), black-box dumped on server
  close or exit.
- **SLO ledger**: stage histograms
  (``serving_{queue_wait,batch_wait,dispatch}_seconds``, per model and
  per tenant), deadline hit/miss counters, a rolling **error-budget
  burn** gauge (miss rate over the last ``XGBTPU_SLO_WINDOW`` deadlined
  requests, relative to the ``XGBTPU_SLO_TARGET`` budget) and the top-K
  slowest requests as **exemplars**.
- **durable sink**: with a server ``run_dir`` (or ``XGBTPU_SERVE_DIR``)
  everything persists under ``run_dir/obs/server/`` in the JAX package's
  layout: ``access.jsonl``, ``flight.jsonl``, ``trace.jsonl`` (span
  sink), ``clock.json``, ``metrics.json``, ``blackbox.json``.

``XGBTPU_FLIGHT=0`` disables the ring and the sink; the ledger's registry
metrics stay on, and spans follow ``trace.enabled()``.
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..observability import flight as _flight
from ..observability import trace as _trace
from ..observability.metrics import REGISTRY

__all__ = ["RequestRecord", "SLOLedger", "ServingRecorder",
           "next_request_id", "SERVE_FORMAT"]

SERVE_FORMAT = "xgbtpu-serve-v1"

_ENV_DIR = "XGBTPU_SERVE_DIR"
_ENV_SLO_TARGET = "XGBTPU_SLO_TARGET"
_ENV_SLO_WINDOW = "XGBTPU_SLO_WINDOW"
_ENV_EXEMPLARS = "XGBTPU_SLO_EXEMPLARS"

# serving stages run from ~10us to seconds: the fine ladder of
# predict_latency_seconds
_STAGE_BUCKETS = (
    0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025,
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_STAGES = ("queue_wait", "batch_wait", "dispatch")

_id_seq = itertools.count()
_WRITER_STOP = object()


def next_request_id() -> str:
    """A process-unique request id (callers may supply their own)."""
    return f"{os.getpid():x}-{next(_id_seq):x}"


def _env_num(name: str, default: float, conv=float):
    try:
        return conv(os.environ.get(name, str(default)))
    except ValueError:
        return default


class RequestRecord:
    """One request's trace state, stamped as it crosses the server.

    Timestamps are ``perf_counter_ns`` (0 = stage never reached), so
    stage durations and span emission share the trace module's clock.
    The record is written exactly once, at :meth:`ServingRecorder.finish`.
    """

    __slots__ = ("id", "model", "rows", "deadline_ms", "unix_ms",
                 "t_submit", "t_dequeue", "t_dispatch0", "t_dispatch1",
                 "t_done", "route", "bucket", "coalesced", "outcome",
                 "shed_reason", "error", "tenant")

    def __init__(self, request_id: Optional[str],
                 deadline_ms: Optional[float]) -> None:
        self.id = str(request_id) if request_id is not None \
            else next_request_id()
        self.model = ""
        self.tenant = ""
        self.rows = 0
        self.deadline_ms = deadline_ms
        self.unix_ms = time.time() * 1e3
        self.t_submit = time.perf_counter_ns()
        self.t_dequeue = 0
        self.t_dispatch0 = 0
        self.t_dispatch1 = 0
        self.t_done = 0
        self.route = ""
        self.bucket = 0
        self.coalesced = 0
        self.outcome = ""
        self.shed_reason = ""
        self.error = ""

    # ------------------------------------------------------------------
    def mark_dequeued(self) -> None:
        self.t_dequeue = time.perf_counter_ns()

    def stage_seconds(self) -> Dict[str, float]:
        """queue_wait / batch_wait / dispatch / total, from whatever
        stages the request actually reached (a shed at admit has only
        ``total_s``)."""
        out: Dict[str, float] = {}
        if self.t_dequeue:
            out["queue_wait_s"] = (self.t_dequeue - self.t_submit) / 1e9
        if self.t_dispatch0 and self.t_dequeue:
            out["batch_wait_s"] = (self.t_dispatch0 - self.t_dequeue) / 1e9
        if self.t_dispatch1 and self.t_dispatch0:
            out["dispatch_s"] = (self.t_dispatch1 - self.t_dispatch0) / 1e9
        end = self.t_done or time.perf_counter_ns()
        out["total_s"] = (end - self.t_submit) / 1e9
        return out

    def access_line(self, stages: Optional[Dict[str, float]] = None
                    ) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "t": "req", "id": self.id, "unix_ms": round(self.unix_ms, 3),
            "model": self.model, "rows": self.rows, "outcome": self.outcome,
        }
        for k, v in (stages if stages is not None
                     else self.stage_seconds()).items():
            doc[k] = round(v, 9)
        if self.tenant:
            doc["tenant"] = self.tenant
        if self.route:
            doc["route"] = self.route
        if self.deadline_ms is not None:
            doc["deadline_ms"] = self.deadline_ms
        if self.shed_reason:
            doc["shed"] = self.shed_reason
        if self.error:
            doc["error"] = self.error
        if self.coalesced:
            doc["coalesced"] = self.coalesced
        if self.bucket:
            doc["bucket"] = self.bucket
        return doc


class SLOLedger:
    """Stage histograms, deadline accounting, error-budget burn and
    worst-request exemplars. Histogram/counter series live in the process
    ``REGISTRY`` (scrapeable); the burn window and exemplar heap are
    per-ledger (one per server)."""

    def __init__(self) -> None:
        self.target = min(max(_env_num(_ENV_SLO_TARGET, 0.99), 0.0),
                          0.999999)
        self.top_k = max(int(_env_num(_ENV_EXEMPLARS, 8, int)), 1)
        self._window = max(int(_env_num(_ENV_SLO_WINDOW, 512, int)), 8)
        self._lock = threading.Lock()
        self._outcomes: "deque[int]" = deque()  # 1 = SLO miss, windowed
        self._misses_in_window = 0
        self._exemplars: List[Any] = []  # min-heap of (total_s, seq, doc)
        self._seq = itertools.count()
        self._hists = {
            stage: REGISTRY.histogram(
                f"serving_{stage}_seconds",
                f"Per-request {stage.replace('_', ' ')} time through the "
                "model server", buckets=_STAGE_BUCKETS)
            for stage in _STAGES
        }
        # hot-path children resolved once: ``labels()`` pays a sort + a
        # family lock per call, and observe() runs per request
        self._unlabelled = {stage: fam.labels()
                            for stage, fam in self._hists.items()}
        self._per_model: Dict[Any, Any] = {}
        self._deadline = REGISTRY.counter(
            "serving_deadline_total",
            "Requests that carried a deadline, by hit/miss outcome")
        self._hit = self._deadline.labels(outcome="hit")
        self._miss = self._deadline.labels(outcome="miss")
        self._burn = REGISTRY.gauge(
            "serving_error_budget_burn",
            "Rolling SLO error-budget burn: deadline-miss rate over the "
            "last window relative to the allowed (1 - target) budget; "
            ">1 means the budget is burning faster than it refills")
        self._burn_child = self._burn.labels()
        self._requests = REGISTRY.counter(
            "serving_requests_total", "Requests completed, by outcome")
        self._by_outcome = {o: self._requests.labels(outcome=o)
                            for o in ("ok", "shed", "error", "abandoned")}
        self._burn.set(0.0)

    def _child(self, stage: str, **labels):
        """Cached labelled child (per-model / per-tenant) — ``labels()``
        pays a sort + family lock per call and observe() runs per
        request."""
        key = (stage, tuple(sorted(labels.items())))
        child = self._per_model.get(key)
        if child is None:
            child = self._per_model[key] = \
                self._hists[stage].labels(**labels)
        return child

    # ------------------------------------------------------------------
    def observe(self, rec: RequestRecord,
                stages: Optional[Dict[str, float]] = None,
                line: Optional[Dict[str, Any]] = None) -> None:
        """Feed one sealed request. ``stages``/``line`` let the recorder
        pass its already-computed values (one computation per request)."""
        if stages is None:
            stages = rec.stage_seconds()
        for stage in _STAGES:
            v = stages.get(f"{stage}_s")
            if v is None:
                continue
            self._unlabelled[stage].observe(v)
            if rec.model:
                self._child(stage, model=rec.model).observe(v)
            if rec.tenant:
                # per-tenant SLO children: a hot tenant's tail
                # must be visible separately from the light tenant it
                # could be starving
                self._child(stage, tenant=rec.tenant).observe(v)
        self._by_outcome.get(rec.outcome, self._by_outcome["error"]).inc()
        if rec.deadline_ms is not None:
            missed = rec.outcome != "ok" \
                or stages["total_s"] * 1e3 > rec.deadline_ms
            (self._miss if missed else self._hit).inc()
            with self._lock:
                self._outcomes.append(1 if missed else 0)
                self._misses_in_window += missed
                if len(self._outcomes) > self._window:
                    self._misses_in_window -= self._outcomes.popleft()
                burn = (self._misses_in_window / len(self._outcomes)) \
                    / max(1.0 - self.target, 1e-9)
            self._burn_child.set(burn)
        total = stages["total_s"]
        with self._lock:
            if len(self._exemplars) < self.top_k:
                heapq.heappush(self._exemplars, (
                    total, next(self._seq),
                    line if line is not None else rec.access_line(stages)))
            elif total > self._exemplars[0][0]:
                heapq.heapreplace(self._exemplars, (
                    total, next(self._seq),
                    line if line is not None else rec.access_line(stages)))

    # ------------------------------------------------------------------
    def burn(self) -> float:
        return self._burn.value

    def exemplars(self) -> List[Dict[str, Any]]:
        """Worst retained requests, slowest first, with stage breakdown."""
        with self._lock:
            worst = sorted(self._exemplars, key=lambda e: -e[0])
        return [doc for _, _, doc in worst]

    def summary(self) -> Dict[str, Any]:
        """The ``stats``-op view of the ledger: stage p50/p99 (overall
        and per model), deadline accounting, current burn."""
        stages: Dict[str, Any] = {}
        per_model: Dict[str, Dict[str, float]] = {}
        per_tenant: Dict[str, Dict[str, float]] = {}
        for stage in _STAGES:
            for labels, qs in REGISTRY.quantiles(
                    f"serving_{stage}_seconds"):
                model = labels.get("model")
                tenant = labels.get("tenant")
                if model:
                    per_model.setdefault(model, {}).update(
                        {f"{stage}_{k}_s": round(v, 9)
                         for k, v in qs.items() if v is not None})
                elif tenant:
                    per_tenant.setdefault(tenant, {}).update(
                        {f"{stage}_{k}_s": round(v, 9)
                         for k, v in qs.items() if v is not None})
                elif not labels:
                    stages[stage] = {k: round(v, 9)
                                     for k, v in qs.items()
                                     if v is not None}
        return {
            "target": self.target,
            "error_budget_burn": round(self.burn(), 4),
            "deadline": {
                "hit": self._deadline.labels(outcome="hit").value,
                "miss": self._deadline.labels(outcome="miss").value,
            },
            "stages": stages,
            "per_model": per_model,
            "per_tenant": per_tenant,
            "exemplars": self.exemplars(),
        }


class ServingRecorder:
    """The server's flight recorder: request finishing, the per-dispatch
    ring, fleet-style events, and the durable ``run_dir/obs/server/``
    sink. Thread-safe (submitter threads shed, the batcher worker
    dispatches, swap threads emit events)."""

    def __init__(self, run_dir: Optional[str] = None) -> None:
        try:
            maxlen = int(os.environ.get("XGBTPU_FLIGHT_BUFFER", "4096")
                         or 4096)
        except ValueError:
            maxlen = 4096
        self._lock = threading.RLock()
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=max(maxlen, 16))
        self.ledger = SLOLedger()
        self._dispatch_seq = itertools.count()
        self._dir: Optional[str] = None
        self._access_file = None
        self._flight_file = None
        self._owns_sink = False
        self._closed = False
        self._n_requests = 0
        run_dir = run_dir or os.environ.get(_ENV_DIR)
        if run_dir and _flight.enabled():
            self._configure(run_dir)
        # sealed records drain to a writer thread: the request path pays
        # only the completion stamps + one enqueue, while serialization,
        # the access-log write and span emission happen behind it
        self._wq: "deque[Any]" = deque()
        self._wq_max = max(maxlen, 16)  # backpressure bound (ring-sized)
        self._wcv = threading.Condition()
        self._wclosed = False
        self._writer = threading.Thread(
            target=self._writer_loop, name="xgbtpu-serve-obs", daemon=True)
        self._writer.start()

    # ------------------------------------------------------------------
    # sink
    # ------------------------------------------------------------------
    @property
    def run_dir(self) -> Optional[str]:
        return self._dir

    def _configure(self, run_dir: str) -> None:
        d = os.path.join(run_dir, "obs", "server")
        try:
            os.makedirs(d, exist_ok=True)
            self._access_file = open(os.path.join(d, "access.jsonl"), "a")
            self._flight_file = open(os.path.join(d, "flight.jsonl"), "a")
        except OSError:
            self._access_file = self._flight_file = None
            return
        self._dir = d
        meta = {"t": "meta", "format": SERVE_FORMAT, "pid": os.getpid(),
                "unix_ms": time.time() * 1e3,
                "clock": _trace.clock_base()}
        self._write(self._flight_file, meta)
        self._write(self._access_file, meta)
        try:
            with open(os.path.join(d, "clock.json"), "w") as f:
                json.dump(_trace.clock_base(), f)
        except OSError:
            pass
        # request spans flow to the server's own trace.jsonl unless the
        # user pointed XGBTPU_TRACE / set_config somewhere explicit
        _trace.set_sink(os.path.join(d, "trace.jsonl"))
        self._owns_sink = True
        import atexit

        atexit.register(self._atexit_dump)

    def _atexit_dump(self) -> None:
        # crash/exit black box: a server never close()d still leaves its
        # ring + metrics on disk (the training recorder's abort analog)
        if not self._closed and self._dir is not None:
            self.drain(2.0)
            self.dump("atexit")

    def _write(self, fh, doc: Dict[str, Any], flush: bool = True) -> None:
        if fh is None:
            return
        try:
            fh.write(json.dumps(doc) + "\n")
            if flush:
                fh.flush()
        except (OSError, ValueError):
            pass

    def _refresh_metrics(self) -> None:
        if self._dir is None:
            return
        try:
            _flight.atomic_write_json(
                os.path.join(self._dir, "metrics.json"),
                REGISTRY.snapshot())
        except Exception:
            pass

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------
    def start_request(self, request_id: Optional[str],
                      deadline_ms: Optional[float]) -> RequestRecord:
        return RequestRecord(request_id, deadline_ms)

    def finish(self, rec: RequestRecord, outcome: str, *,
               shed_reason: str = "", error: str = "") -> None:
        """Seal one request: stamp completion and hand the record to the
        writer thread (SLO ledger, access-log line, async span track).
        The caller pays only the stamps + one enqueue; :meth:`drain` is
        the barrier for readers. Idempotence
        guard: a record finishes once (the close() drain path can race a
        worker resolving the same future)."""
        self.finish_many((rec,), outcome, shed_reason=shed_reason,
                         error=error)

    def finish_many(self, recs, outcome: str, *, shed_reason: str = "",
                    error: str = "") -> None:
        """:meth:`finish` for the requests of one coalesced dispatch: one
        enqueue and one writer wake-up for all of them."""
        now = time.perf_counter_ns()
        sealed = []
        for rec in recs:
            if rec.outcome:
                continue
            rec.t_done = now
            rec.outcome = outcome
            rec.shed_reason = shed_reason
            if error:
                rec.error = error[:200]
            sealed.append(rec)
        if not sealed:
            return
        with self._wcv:
            # bounded queue: a wedged sink (hung disk) must degrade to
            # synchronous writes on the caller, not grow memory forever
            if not self._wclosed and len(self._wq) < self._wq_max:
                self._wq.extend(sealed)
                self._wcv.notify()
                return
        for rec in sealed:  # writer gone/backlogged: inline
            self._process(rec)

    def _process(self, rec: RequestRecord) -> None:
        """Writer-side half of :meth:`finish`: everything downstream of
        the completion stamps, computed once per request."""
        try:
            stages = rec.stage_seconds()
            line = rec.access_line(stages)
            self.ledger.observe(rec, stages, line)
            with self._lock:
                self._n_requests += 1
                # access lines flush in small batches (sheds/errors —
                # the interesting tail — immediately); drain()/close()
                # flush the rest, so post-run line counts stay exact
                self._write(self._access_file, line,
                            flush=rec.outcome != "ok"
                            or self._n_requests % 16 == 0)
            args: Dict[str, Any] = {"model": rec.model, "rows": rec.rows,
                                    "outcome": rec.outcome}
            if rec.shed_reason:
                args["shed"] = rec.shed_reason
            spans = [("request", rec.t_submit, rec.t_done, args)]
            if rec.t_dequeue:
                spans.append(("queue_wait", rec.t_submit, rec.t_dequeue,
                              None))
                if rec.t_dispatch0:
                    spans.append(("batch_wait", rec.t_dequeue,
                                  rec.t_dispatch0, None))
                    if rec.t_dispatch1:
                        spans.append(("dispatch", rec.t_dispatch0,
                                      rec.t_dispatch1, None))
            _trace.emit_async_track(rec.id, spans)
        except Exception:  # noqa: BLE001 — observability must not throw
            pass

    def _writer_loop(self) -> None:
        while True:
            with self._wcv:
                while not self._wq:
                    self._wcv.wait()
                item = self._wq.popleft()
            if item is _WRITER_STOP:
                return
            if isinstance(item, threading.Event):
                with self._lock:  # barrier: batched lines reach disk
                    if self._access_file is not None:
                        try:
                            self._access_file.flush()
                        except OSError:
                            pass
                item.set()
                continue
            self._process(item)

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every record finished before this call has been
        written (ledger fed, access line on disk). The consistency
        barrier for ``stats``/``serve-report``-on-a-live-dir readers."""
        marker = threading.Event()
        with self._wcv:
            if self._wclosed:
                return True
            self._wq.append(marker)
            self._wcv.notify()
        return marker.wait(timeout)

    # ------------------------------------------------------------------
    # dispatch ring
    # ------------------------------------------------------------------
    def dispatch(self, recs: List[RequestRecord], *, model: str, rows: int,
                 bucket: int, route: str, queue_depth: int,
                 t0_ns: int, t1_ns: int) -> None:
        """Record one coalesced dispatch (called by the batcher worker
        right after the predict returns, before futures resolve)."""
        if not _flight.enabled():
            return
        arena = REGISTRY.get("serving_arena_bytes")
        rec = {
            "t": "dispatch", "seq": next(self._dispatch_seq),
            "unix_ms": round(time.time() * 1e3, 3),
            "model": model, "rows": rows, "reqs": len(recs),
            "bucket": bucket, "route": route,
            "queue_depth": queue_depth,
            "arena_bytes": int(arena.value) if arena is not None else 0,
            "dispatch_s": round((t1_ns - t0_ns) / 1e9, 9),
            "request_ids": [r.id for r in recs],
        }
        with self._lock:
            self._ring.append(rec)
            self._write(self._flight_file, rec)
            refresh = rec["seq"] % 20 == 0
        _trace.emit("serving_dispatch", t0_ns, t1_ns, cat="serving",
                    model=model, rows=rows, bucket=bucket, route=route,
                    requests=[r.id for r in recs])
        if refresh:
            self._refresh_metrics()
            try:
                if _trace.enabled():
                    _trace.flush()
            except Exception:
                pass

    def event(self, name: str, **args: Any) -> None:
        """A serving-plane event (model_load / model_swap / model_evict /
        model_fault_in / server_close): ring + sink, so ``serve-report``
        can place it on the request timeline. No live trace instant —
        the merge re-synthesizes flight events as instants (same
        contract as the training recorder), so emitting one here would
        double every marker in the merged trace."""
        if not _flight.enabled():
            return
        rec: Dict[str, Any] = {"t": "event", "name": name,
                               "unix_ms": round(time.time() * 1e3, 3)}
        if args:
            rec["args"] = dict(args)
        with self._lock:
            self._ring.append(rec)
            self._write(self._flight_file, rec)

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    # ------------------------------------------------------------------
    # black box
    # ------------------------------------------------------------------
    def dump(self, reason: str) -> Optional[str]:
        """Ring + SLO summary + registry snapshot, atomically, to
        ``blackbox.json``. Best effort; None without a sink."""
        if self._dir is None or not _flight.enabled():
            return None
        with self._lock:
            doc = {
                "format": SERVE_FORMAT, "reason": reason,
                "pid": os.getpid(), "unix_ms": time.time() * 1e3,
                "clock": _trace.clock_base(),
                "requests": self._n_requests,
                "slo": None, "records": list(self._ring),
            }
        try:
            doc["slo"] = self.ledger.summary()
        except Exception:
            pass
        try:
            doc["metrics"] = REGISTRY.snapshot()
        except Exception:
            doc["metrics"] = {}
        path = os.path.join(self._dir, "blackbox.json")
        if not _flight.atomic_write_json(path, doc):
            return None
        with self._lock:  # batched access lines reach disk with the dump
            for fh in (self._access_file, self._flight_file):
                if fh is not None:
                    try:
                        fh.flush()
                    except OSError:
                        pass
        self._refresh_metrics()
        return path

    def close(self) -> None:
        """Drain + stop the writer, then final event + black box +
        sidecars, then release files and the trace sink (env/config
        trace destinations are unaffected)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # FIFO stop: everything enqueued before this line is processed
        # first, so the close-time black box counts every request
        with self._wcv:
            self._wq.append(_WRITER_STOP)
            self._wcv.notify()
        self._writer.join(timeout=30)
        with self._wcv:
            self._wclosed = True
            leftovers = list(self._wq)
            self._wq.clear()
        for item in leftovers:  # raced the stop marker: best effort
            if isinstance(item, RequestRecord):
                self._process(item)
            elif isinstance(item, threading.Event):
                item.set()  # release a drain() that raced the close
        self.event("server_close", requests=self._n_requests)
        self.dump("close")
        try:
            if _trace.enabled():
                _trace.flush()
        except Exception:
            pass
        with self._lock:
            for fh in (self._access_file, self._flight_file):
                if fh is not None:
                    try:
                        fh.close()
                    except OSError:
                        pass
            self._access_file = self._flight_file = None
        if self._owns_sink:
            _trace.set_sink(None)
        import atexit

        try:  # a closed recorder must not stay pinned by the exit hook
            atexit.unregister(self._atexit_dump)
        except Exception:
            pass
