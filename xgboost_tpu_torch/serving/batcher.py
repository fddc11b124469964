"""Async micro-batcher: many small concurrent requests, one dispatch (the
port of the JAX package's ``serving/batcher.py``).

Callers submit requests and get ``concurrent.futures.Future``s back; one
worker thread drains the bounded queue, coalesces compatible requests
(same model snapshot, same predict options) into one concatenated matrix,
runs ONE dispatch (``Booster.inplace_predict``: one host-to-device copy,
one kernel B launch on the card, one device-to-host copy) and slices the
result back per caller. 64 concurrent 1-row requests become a handful of
kernel launches instead of 64.

Knobs (env, read at construction):

- ``XGBTPU_BATCH_WAIT_US`` (default 1000): after the first request of a
  cycle arrives, how long the worker waits for more traffic to coalesce.
  0 = dispatch immediately, coalescing only what is already queued.
- ``XGBTPU_BATCH_MAX_ROWS`` (default 4096): rows per drain cycle; a full
  cycle dispatches without waiting out the window.
- ``XGBTPU_MAX_REQUEST_ROWS`` (default 65536): per-request row cap;
  larger payloads are rejected at admission (reason ``invalid``).
- ``XGBTPU_BATCHER_WATCHDOG`` (default 60, seconds; 0 disables): how long
  one dispatch may block the worker before the watchdog declares it
  wedged, fails its in-flight futures with a typed
  :class:`~xgboost_tpu_torch.serving.faults.RequestError` and respawns
  the worker (crash-only: the queue and every waiting caller survive).

The worker is the thread that does the CUDA work: it makes the server's
device current before its first launch, launches on that thread's
current stream (what ``_build.stream_of`` reads), and the one
device-to-host copy of each coalesced dispatch is its only
synchronisation.

Fairness: the queue is a
:class:`~xgboost_tpu_torch.serving.tenancy.TenantFairQueue`, per-tenant
lanes dequeued in weighted-fair order (``XGBTPU_TENANT_WEIGHTS``; service
cost = rows), and each tenant's occupancy is bounded at admission by
``XGBTPU_TENANT_QUOTA``. Requests of different tenants for the same model
still coalesce: fairness decides *order*, not batching.

Correctness: rows walk independently, so a coalesced result is
bit-identical to the same request served alone; requests that cannot
coalesce (sparse inputs, explicit base margins) ride the same queue but
dispatch as their own group. Dispatch-time deadline re-checks shed
requests that aged out while queued, and futures a caller cancelled are
skipped at assembly and counted as
``serving_requests_total{outcome="abandoned"}``.

Failure handling (``serving/faults.py``): a failed coalesced dispatch is
classified; transients get one bounded same-batch retry, anything
persistent is bisected until the poison member(s) alone fail with a
typed ``RequestError`` while innocent co-batched requests succeed.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability.metrics import REGISTRY
from ..predictor.serving import bucket_rows, last_route
from ..resilience import chaos, policy
from . import faults
from .admission import AdmissionController, RequestShed
from .obs import RequestRecord, ServingRecorder
from .tenancy import (
    OVERFLOW_TENANT, QUEUE_STOP, SHADOW_TENANT, ModelEntry,
    TenantFairQueue,
)

__all__ = ["MicroBatcher"]

_STOP = QUEUE_STOP


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


class _Request:
    __slots__ = ("entry", "X", "n", "group_key", "predict_type",
                 "iteration_range", "missing", "base_margin", "deadline",
                 "future", "rec", "fp", "tenant")

    def __init__(self, entry: ModelEntry, X, n: int, group_key: Tuple,
                 predict_type: str, iteration_range, missing, base_margin,
                 deadline: Optional[float],
                 rec: Optional[RequestRecord],
                 fp: Optional[int] = None, tenant: str = "") -> None:
        self.entry = entry
        self.X = X
        self.n = n
        self.group_key = group_key
        self.predict_type = predict_type
        self.iteration_range = iteration_range
        self.missing = missing
        self.base_margin = base_margin
        self.deadline = deadline
        self.rec = rec
        self.fp = fp
        self.tenant = tenant
        self.future: "Future" = Future()
        if rec is not None:
            # the response side of request tracing: every future carries
            # the id its access-log line and trace track were written under
            self.future.request_id = rec.id


class MicroBatcher:
    """The queue + worker thread. One per
    :class:`~xgboost_tpu_torch.serving.ModelServer`; admission decisions
    (queue bound, deadline shed, breaker/quarantine sheds) are delegated
    to the attached :class:`AdmissionController`, whose fault domain also
    drives the isolation machinery here. ``device`` is the server's: the
    worker makes it current before its first launch."""

    def __init__(self, admission: Optional[AdmissionController] = None,
                 *, obs: Optional[ServingRecorder] = None,
                 max_wait_us: Optional[int] = None,
                 max_batch_rows: Optional[int] = None,
                 tenant_weights=None, device=None) -> None:
        self.admission = admission or AdmissionController()
        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type == "cuda" \
                and self.device.index is None:
            # the creating thread's card: a new thread starts on card 0
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.obs = obs
        if max_wait_us is None:
            max_wait_us = _env_int("XGBTPU_BATCH_WAIT_US", 1000)
        if max_batch_rows is None:
            max_batch_rows = _env_int("XGBTPU_BATCH_MAX_ROWS", 4096)
        self.max_wait_s = max(0, max_wait_us) / 1e6
        self.max_batch_rows = max(1, max_batch_rows)
        self.max_request_rows = max(
            1, _env_int("XGBTPU_MAX_REQUEST_ROWS", 65536))
        self.watchdog_s = max(0.0, _env_float("XGBTPU_BATCHER_WATCHDOG",
                                              60.0))
        self._q = TenantFairQueue(tenant_weights)
        # wire-supplied tenant names must not grow per-tenant state
        # (labelled metric children, ledger caches, fair-queue lanes)
        # without bound: past XGBTPU_TENANT_MAX distinct tenants, new
        # names share the OVERFLOW_TENANT lane/label
        self._tenant_cap = max(1, _env_int("XGBTPU_TENANT_MAX", 64))
        self._tenants_seen: set = set()
        self._tenant_overflow = REGISTRY.counter(
            "serving_tenant_overflow_total",
            "Requests whose tenant was folded into the shared overflow "
            "lane because the distinct-tenant cap was reached")
        self._tenant_rows = REGISTRY.counter(
            "serving_tenant_dequeued_rows_total",
            "Rows dequeued from the batcher per request tenant — the "
            "weighted-fair dispatch-share ledger")
        self._depth = REGISTRY.gauge(
            "serving_queue_depth", "Requests waiting in the batcher queue")
        self._dispatches = REGISTRY.counter(
            "serving_dispatches_total",
            "Coalesced program dispatches issued by the micro-batcher")
        self._batched = REGISTRY.counter(
            "serving_requests_batched_total",
            "Requests served through the micro-batcher")
        self._rows = REGISTRY.counter(
            "serving_rows_total", "Rows served through the micro-batcher")
        self._respawns = REGISTRY.counter(
            "serving_worker_respawns_total",
            "Batcher worker threads respawned by the wedge watchdog")
        self._fastpath = REGISTRY.counter(
            "serving_batch_fastpath_total",
            "Dispatches that skipped (part of) the coalescing window "
            "because every admitted request was already in the batch "
            "(idle fast-path)")
        # admitted-but-unresolved requests (queued + in the open batch):
        # the idle fast-path's signal. A request leaves the count when its
        # future reaches ANY terminal state (result, typed error, cancel)
        # via the done-callback attached at submit.
        self._outstanding = 0
        self._depth.set(0)
        self._dispatches.inc(0)
        self._batched.inc(0)
        self._respawns.inc(0)
        self._closed = False
        self._lock = threading.Lock()
        # worker generation: the watchdog bumps it when it declares the
        # current worker wedged; a stale worker sees the bump and exits
        # without touching queue or futures (crash-only respawn)
        self._gen = 0
        self._inflight: List[_Request] = []
        self._busy_since = 0.0
        self._worker = threading.Thread(
            target=self._loop, args=(0,),
            name="xgbtpu-serving-batcher", daemon=True)
        self._worker.start()
        if self.watchdog_s > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop,
                name="xgbtpu-batcher-watchdog", daemon=True)
            self._watchdog.start()

    # ------------------------------------------------------------------
    def submit(self, entry: ModelEntry, data, *,
               predict_type: str = "value", iteration_range=None,
               missing: float = np.nan, base_margin=None,
               deadline: Optional[float] = None,
               rec: Optional[RequestRecord] = None,
               tenant: str = "") -> "Future":
        """Enqueue one predict request against a pinned model entry.
        Returns a Future resolving to the prediction array (rows in input
        order), or raising :class:`~xgboost_tpu_torch.serving.RequestShed` /
        a typed dispatch error. ``deadline`` is absolute
        ``time.monotonic()``; ``rec`` is the server's request-trace
        record — sealed here on a shed/refusal, by the dispatch path
        otherwise; ``tenant`` picks the fair-queue lane (and quota) the
        request rides."""
        try:
            return self._submit(entry, data, predict_type=predict_type,
                                iteration_range=iteration_range,
                                missing=missing, base_margin=base_margin,
                                deadline=deadline, rec=rec, tenant=tenant)
        except BaseException as e:
            if self.obs is not None and rec is not None:
                if isinstance(e, RequestShed):
                    self.obs.finish(rec, "shed", shed_reason=e.reason)
                else:
                    self.obs.finish(rec, "error",
                                    error=f"{type(e).__name__}: {e}")
                # sheds never produce a future, so the id rides the
                # exception — shed responses still carry their request_id
                e.request_id = rec.id
            raise

    def _intern_tenant(self, tenant: str) -> str:
        """Clamp an untrusted tenant name: length-capped, and folded into
        the shared overflow lane once XGBTPU_TENANT_MAX distinct tenants
        exist — per-tenant state stays bounded no matter what the wire
        sends."""
        if not tenant:
            return ""
        tenant = str(tenant)[:64]
        with self._lock:
            if tenant in self._tenants_seen:
                return tenant
            if len(self._tenants_seen) < self._tenant_cap:
                self._tenants_seen.add(tenant)
                return tenant
        self._tenant_overflow.inc()
        return OVERFLOW_TENANT

    def _submit(self, entry: ModelEntry, data, *, predict_type,
                iteration_range, missing, base_margin, deadline,
                rec: Optional[RequestRecord], tenant: str = "") -> "Future":
        tenant = self._intern_tenant(tenant)
        if iteration_range is not None \
                and tuple(iteration_range) == (0, 0):
            iteration_range = None
        if hasattr(data, "tocsr") and hasattr(data, "nnz"):
            # scipy sparse: ride the queue un-normalized (the serving
            # entry consumes CSR directly), dispatched as its own group
            X, coalescible = data, False
        else:
            X = entry.booster._inplace_normalize(data, missing)
            if X is None:
                raise TypeError(
                    "micro-batcher inputs must be 2-D arrays or scipy "
                    f"sparse matrices, got {type(data).__name__}")
            missing = np.nan  # sentinel already folded into NaN
            coalescible = base_margin is None
        # structural validation BEFORE the queue: a malformed dense payload
        # is rejected with a typed error at admission, not thrown inside
        # the coalesced dispatch where it would fail co-batched callers
        # (reason "invalid" on requests_shed_total)
        n = int(X.shape[0])
        nf = entry.booster.num_features()
        if nf and int(X.shape[1]) != int(nf):
            raise self.admission.invalid(
                f"payload width {X.shape[1]} != model features {nf} "
                f"for {entry.label}")
        if n == 0:
            raise self.admission.invalid("empty payload (0 rows)")
        if n > self.max_request_rows:
            raise self.admission.invalid(
                f"payload rows {n} > XGBTPU_MAX_REQUEST_ROWS="
                f"{self.max_request_rows}")
        vals = X.data if not coalescible and hasattr(X, "data") \
            and not isinstance(X, np.ndarray) else X
        if np.isinf(np.asarray(vals)).any():
            raise self.admission.invalid(
                "non-finite (inf) values in payload (use NaN for "
                "missing)")
        fp = faults.fingerprint(X) if coalescible else None
        if rec is not None:
            rec.rows = int(n)
            rec.tenant = tenant
        rkey = None if iteration_range is None else tuple(iteration_range)
        with self._lock:
            if self._closed:
                raise RuntimeError("model server is closed")
            # qsize is exact under the lock only for submitters; the
            # worker draining concurrently just makes admission lenient
            self.admission.admit(self._q.qsize(), deadline,
                                 model=entry.label, fingerprint=fp,
                                 tenant=tenant,
                                 tenant_depth=self._q.depth(tenant))
            req = _Request(
                entry, X, n,
                # sparse / base-margin requests get an identity key: they
                # ride the drain cycle but dispatch as their own group
                (id(entry), predict_type, rkey, X.shape[1])
                if coalescible else (object(),),
                predict_type, iteration_range, missing, base_margin,
                deadline, rec, fp, tenant)
            entry.acquire()
            self._outstanding += 1
            self._q.put(req, tenant=tenant, cost=float(n))
            self._depth.set(self._q.qsize())
        # attached OUTSIDE the lock: done-callbacks run synchronously on
        # whichever thread resolves (or cancels) the future, and must
        # never fire while this thread holds the batcher lock
        req.future.add_done_callback(self._on_request_done)
        return req.future

    def _on_request_done(self, _fut) -> None:
        with self._lock:
            if self._outstanding > 0:
                self._outstanding -= 1

    # ------------------------------------------------------------------
    def _note_dequeue(self, req: "_Request") -> None:
        if req.rec is not None:
            req.rec.mark_dequeued()
        if req.tenant:
            self._tenant_rows.labels(tenant=req.tenant).inc(req.n)

    def _bind_device(self) -> None:
        """Make the server's CUDA device current on this worker thread."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _loop(self, gen: int) -> None:
        self._bind_device()
        while True:
            with self._lock:
                if self._gen != gen \
                        or self._closed and self._q.qsize() == 0:
                    return
            item = self._q.get()
            if item is _STOP:
                break
            self._note_dequeue(item)
            batch = [item]
            rows = item.n
            # idle fast path: the coalescing window gathers requests in
            # flight toward the queue, but when every admitted request is
            # already in this batch (queue empty, outstanding ==
            # len(batch)), nothing can arrive until these futures
            # resolve: closed-loop clients are all blocked on THIS batch,
            # and holding the window would only stall the dispatch. A
            # flood (more outstanding than batched) keeps the window.
            window_end = time.monotonic() + self.max_wait_s
            while rows < self.max_batch_rows:
                with self._lock:
                    drained = (self._q.qsize() == 0
                               and self._outstanding <= len(batch))
                if drained:
                    self._fastpath.inc()
                    break
                remaining = window_end - time.monotonic()
                try:
                    nxt = self._q.get(timeout=max(0.0, remaining)) \
                        if remaining > 0 else self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    break  # the stop flag is sticky: exit after this batch
                self._note_dequeue(nxt)
                batch.append(nxt)
                rows += nxt.n
            self._depth.set(self._q.qsize())
            with self._lock:
                if self._gen != gen:
                    # replaced while assembling: hand the batch to the
                    # error path (we must not race the live worker)
                    stale_batch = batch
                else:
                    stale_batch = None
                    self._inflight = batch
                    self._busy_since = time.monotonic()
            if stale_batch is not None:
                for req in stale_batch:
                    self._resolve_err(req, faults.RequestError(
                        "batcher_wedge", policy.TRANSIENT,
                        "batcher worker replaced mid-assembly"))
                return
            try:
                self._run_batch(batch, gen)
            finally:
                with self._lock:
                    if self._gen == gen:
                        self._inflight = []
                        self._busy_since = 0.0

    def _watchdog_loop(self) -> None:
        """Detect a wedged worker: a dispatch that has blocked the worker
        thread past ``XGBTPU_BATCHER_WATCHDOG`` seconds gets its in-flight
        futures failed (typed, site ``batcher_wedge``) and a fresh worker
        spawned — queued requests behind the wedge keep being served.
        The wedged thread itself is abandoned (its generation is stale;
        anything it eventually returns is discarded)."""
        interval = max(0.02, min(1.0, self.watchdog_s / 4))
        while True:
            time.sleep(interval)
            with self._lock:
                if self._closed:
                    return
                busy = self._busy_since
                if not busy or (time.monotonic() - busy) < self.watchdog_s:
                    continue
                batch = self._inflight
                self._inflight = []
                self._busy_since = 0.0
                self._gen += 1
                gen = self._gen
                self._worker = threading.Thread(
                    target=self._loop, args=(gen,),
                    name=f"xgbtpu-serving-batcher-{gen}", daemon=True)
                self._worker.start()
            faults.record_serving_fault(
                "batcher_wedge", kind=policy.TRANSIENT)
            self._respawns.inc()
            if self.obs is not None:
                self.obs.event("batcher_respawn", inflight=len(batch),
                               deadline_s=self.watchdog_s)
            for req in batch:
                rid = req.rec.id if req.rec is not None else None
                self._resolve_err(req, faults.RequestError(
                    "batcher_wedge", policy.TRANSIENT,
                    f"batcher worker wedged > {self.watchdog_s}s; "
                    "in-flight futures failed, worker respawned",
                    request_id=rid))

    def _run_batch(self, batch: List[_Request], gen: int) -> None:
        try:
            chaos.hit("batcher_wedge")
        except chaos.ChaosError:
            # scripted wedge: park (GIL-friendly) until the watchdog
            # replaces this worker or the batcher closes: the testable
            # analog of a dispatch stuck in a kernel
            while True:
                with self._lock:
                    if self._gen != gen or self._closed:
                        return
                time.sleep(0.02)
        groups: "Dict[Tuple, List[_Request]]" = {}
        now = time.monotonic()
        for req in batch:
            if not self._claim(req):
                self._abandon(req)
                continue
            if req.deadline is not None and now >= req.deadline:
                self._resolve_err(req, self.admission.shed_at_dispatch())
                continue
            groups.setdefault(req.group_key, []).append(req)
        for grp in groups.values():
            self._dispatch_group(grp, gen)

    def _dispatch_group(self, grp: List[_Request], gen: int) -> None:
        first = grp[0]
        domain = self.admission.faults
        # shadow-canary isolation (serving/delivery.py): an all-shadow
        # group must not feed the live fault plane — its failures belong
        # to the CANARY verdict (attach_shadow observes them), not to the
        # model's NAME-keyed breaker or the payload quarantine, or a bad
        # candidate in shadow mode ("zero user impact") could shed live
        # traffic / quarantine a live request's fingerprint. Shadow
        # requests target the candidate entry, so they never coalesce
        # with incumbent-bound live traffic.
        shadow = all(r.tenant == SHADOW_TENANT for r in grp)
        rows = sum(r.n for r in grp)
        t0 = time.perf_counter_ns()

        def dispatch(sub: List[_Request]):
            chaos.hit("serving_dispatch")
            X = sub[0].X if len(sub) == 1 else \
                np.concatenate([r.X for r in sub], axis=0)
            faults.check_poison(X)
            faults.check_model_poison(first.entry.label)
            return first.entry.predict(
                X, predict_type=first.predict_type,
                iteration_range=first.iteration_range,
                missing=first.missing, base_margin=first.base_margin)

        # the isolation ladder (faults.py): clean traffic costs exactly
        # one dispatch() call; classification/retry/bisection only run
        # once a failure has already happened
        ok, failed = faults.isolate_dispatch(
            grp, dispatch, domain=None if shadow else domain,
            model=first.entry.name)
        t1 = time.perf_counter_ns()
        if not shadow:
            domain.breaker(first.entry.name).record(
                ok=not failed, latency_s=(t1 - t0) / 1e9)
        with self._lock:
            if self._gen != gen:
                return  # watchdog already failed this batch's futures
        if ok:
            self._dispatches.inc()
            self._batched.inc(len(ok))
            self._rows.inc(sum(r.n for r, _ in ok))
        route = last_route()  # this thread ran the dispatch: exact
        bucket = bucket_rows(rows)
        ok_reqs = [r for r, _ in ok]
        recs = [r.rec for r in ok_reqs if r.rec is not None]
        for req in ok_reqs:
            if req.rec is not None:
                req.rec.t_dispatch0 = t0
                req.rec.t_dispatch1 = t1
                req.rec.route = route
                req.rec.bucket = bucket
                req.rec.coalesced = len(grp)
        if self.obs is not None and ok:
            self.obs.dispatch(
                recs, model=first.entry.label,
                rows=sum(r.n for r, _ in ok), bucket=bucket,
                route=route, queue_depth=self._q.qsize(), t0_ns=t0, t1_ns=t1)
            self.obs.finish_many(recs, "ok")
        for req, out in ok:
            req.entry.release()
            self._set_result(req.future, out)
        for req, exc in failed:
            rid = req.rec.id if req.rec is not None else None
            self._resolve_err(req, faults.RequestError(
                faults.DISPATCH_SITE, policy.classify(exc),
                f"{type(exc).__name__}: {exc}", request_id=rid))

    # ------------------------------------------------------------------
    @staticmethod
    def _claim(req: _Request) -> bool:
        """Move the future to RUNNING; False = the caller cancelled it
        (the request is abandoned and must be skipped, not dispatched)."""
        try:
            return req.future.set_running_or_notify_cancel()
        except InvalidStateError:
            return True  # already claimed (close() racing the worker)

    def _abandon(self, req: _Request) -> None:
        """A cancelled future skipped at dispatch-assembly time: release
        its model pin and count it — the caller went away, so nothing
        else will."""
        req.entry.release()
        if self.obs is not None and req.rec is not None:
            self.obs.finish(req.rec, "abandoned")
        else:
            REGISTRY.counter(
                "serving_requests_total",
                "Requests completed, by outcome",
            ).labels(outcome="abandoned").inc()

    @staticmethod
    def _set_result(fut: "Future", value) -> None:
        try:
            fut.set_result(value)
        except InvalidStateError:
            pass  # cancelled/failed concurrently: result has no taker

    def _resolve_err(self, req: _Request, exc: BaseException) -> None:
        req.entry.release()
        if self.obs is not None and req.rec is not None:
            if isinstance(exc, RequestShed):
                self.obs.finish(req.rec, "shed", shed_reason=exc.reason)
            else:
                self.obs.finish(req.rec, "error",
                                error=f"{type(exc).__name__}: {exc}")
        try:
            req.future.set_exception(exc)
        except InvalidStateError:
            pass  # cancelled/resolved concurrently (watchdog vs worker)

    # ------------------------------------------------------------------
    def queue_depth(self) -> int:
        return self._q.qsize()

    def close(self, drain: bool = True,
              deadline_s: Optional[float] = None) -> None:
        """Stop the worker. ``drain=True`` serves everything already
        queued first (bounded by ``deadline_s``, default 60 /
        ``XGBTPU_DRAIN_DEADLINE_S``); either way, requests that slip in
        after the stop marker fail with a closed-server error instead of
        hanging."""
        if deadline_s is None:
            deadline_s = _env_float("XGBTPU_DRAIN_DEADLINE_S", 60.0)
        with self._lock:
            if self._closed:
                return
            self._closed = True
            worker = self._worker
            self._q.stop()  # sticky: get() drains the backlog, then STOP
        worker.join(timeout=max(0.1, deadline_s))
        leftovers = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                break
            leftovers.append(item)
        if drain and leftovers:
            self._bind_device()  # this thread dispatches them
        for req in leftovers:
            if not self._claim(req):
                self._abandon(req)
            elif drain:
                # close() raced the worker's exit: serve rather than drop
                self._dispatch_group([req], self._gen)
            else:
                self._resolve_err(
                    req, RuntimeError("model server closed before dispatch"))
