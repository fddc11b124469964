"""SLO-aware admission: shed early (the port of the JAX package's
``serving/admission.py``).

A serving front end that accepts every request fails them all at once
when traffic exceeds capacity. This module is the decision layer in front
of the micro-batcher:

- **deadline**: a request may carry one (``deadline_ms``). A request
  whose deadline already passed, or whose *estimated* completion (queue
  depth x the p99 of ``predict_latency_seconds``) overshoots it, is shed
  at submit time with a typed :class:`RequestShed`. The batcher re-checks
  at dispatch, so a request that aged out while queued is shed, not
  walked.
- **queue bound**: ``XGBTPU_SERVING_QUEUE`` (default 1024); overflow
  sheds with reason ``queue_full``.
- **tenant quota**: each request tenant's *queue occupancy* is bounded by
  ``XGBTPU_TENANT_QUOTA`` (``name=N,*=M`` or a bare int; unset =
  unbounded); a tenant at its quota sheds with reason ``tenant_quota``
  while every other tenant keeps admitting.
- **fault-plane sheds** (``serving/faults.py``): a request for a model
  whose circuit breaker is OPEN sheds with reason ``breaker`` (the
  half-open probe excepted); a quarantined payload fingerprint with
  ``quarantine``; a structurally invalid payload (wrong width, oversized,
  inf values) with ``invalid`` before it can throw inside a coalesced
  dispatch; a draining server (SIGTERM) sheds new arrivals with
  ``draining`` while queued requests finish.

No degrade routing. The JAX package sends dispatches to its native CPU
walker while its device walk is marked unhealthy; here that would be a
fallback that hides the kernel, so a faulting kernel B launch goes
through the fault ladder (``faults.isolate_dispatch``) instead.
``serving_degraded_routes_total`` stays registered at 0 so the
exposition keeps its name.

Every decision is observable: ``requests_shed_total{reason=...}``,
``serving_admitted_total``, ``serving_degraded_routes_total``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from ..observability.metrics import REGISTRY
from .faults import FaultDomain
from .tenancy import tenant_quotas

__all__ = ["RequestShed", "AdmissionController"]

#: shed reasons (the ``reason`` label on ``requests_shed_total``)
QUEUE_FULL = "queue_full"
DEADLINE = "deadline"  # already past due at decision time
SLO = "slo"  # projected completion overshoots the deadline
BREAKER = "breaker"  # the model's circuit breaker is OPEN
QUARANTINE = "quarantine"  # repeat poison offender fingerprint
INVALID = "invalid"  # malformed payload rejected at admission
DRAINING = "draining"  # SIGTERM drain in progress
TENANT_QUOTA = "tenant_quota"  # the tenant's queue-occupancy cap is hit

#: p99 prior (seconds) used before the latency histogram has samples: a
#: generous whole-bucket-walk estimate so a cold server does not shed its
#: warm-up traffic on a fantasy backlog
_COLD_P99_S = 0.050


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


class RequestShed(RuntimeError):
    """A request the server declined to serve (admission or dispatch-time
    shed). ``reason`` is one of ``queue_full`` / ``deadline`` / ``slo``."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"request shed ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


class AdmissionController:
    """Stateless-per-request decisions over shared observable state (queue
    depth from the batcher, p99 from the metrics registry, breakers and
    quarantine from the fault domain). One instance per
    :class:`~xgboost_tpu_torch.serving.ModelServer`."""

    def __init__(self, max_queue: Optional[int] = None,
                 faults: Optional[FaultDomain] = None):
        self.max_queue = max(1, max_queue if max_queue is not None
                             else _env_int("XGBTPU_SERVING_QUEUE", 1024))
        #: the server's fault domain (breakers + quarantine); a bare
        #: controller owns a private one so direct MicroBatcher users
        #: still get isolation/quarantine/breaker behavior
        self.faults = faults if faults is not None else FaultDomain()
        #: SIGTERM drain flag (set via the owning server's begin_drain)
        self.draining = False
        #: XGBTPU_TENANT_QUOTA, parsed ONCE (admit runs per request)
        self.quotas = tenant_quotas()
        # pre-create the families so a healthy server's exposition still
        # documents the shed/admit surface (scrapers see zeros, not gaps)
        self._shed = REGISTRY.counter(
            "requests_shed_total",
            "Requests declined by SLO-aware admission, by reason")
        for reason in (QUEUE_FULL, DEADLINE, SLO, BREAKER, QUARANTINE,
                       INVALID, DRAINING, TENANT_QUOTA):
            self._shed.labels(reason=reason)
        self._admitted = REGISTRY.counter(
            "serving_admitted_total", "Requests admitted into the batcher")
        self._degraded_routes = REGISTRY.counter(
            "serving_degraded_routes_total",
            "Dispatches routed to a host walker because the device "
            "predict path is degraded (never, in the PyTorch port)")
        self._admitted.inc(0)
        self._degraded_routes.inc(0)

    # ------------------------------------------------------------------
    def p99_s(self, model: str = "") -> float:
        """Current p99 of the serving latency series. With a ``model``
        label (``name@vN``), the per-model child of
        ``predict_latency_seconds`` wins whenever it has samples — a slow
        tenant must not be judged by a fast fleet-wide tail (nor the
        reverse); a cold model (no labelled samples yet) falls back to
        the unlabelled process-wide aggregate, and a cold server to the
        prior."""
        if model:
            q = REGISTRY.quantile("predict_latency_seconds", 0.99,
                                  model=model)
            if q is not None:
                return max(q, 1e-6)
        q = REGISTRY.quantile("predict_latency_seconds", 0.99)
        return _COLD_P99_S if q is None else max(q, 1e-6)

    def invalid(self, detail: str) -> RequestShed:
        """Count and build the typed rejection for a structurally
        malformed payload (the batcher raises it BEFORE the request can
        reach the queue — satellite: malformed dense payloads must not
        throw inside a coalesced dispatch)."""
        self._shed.labels(reason=INVALID).inc()
        return RequestShed(INVALID, detail)

    def admit(self, queue_depth: int,
              deadline: Optional[float] = None,
              model: str = "",
              fingerprint: Optional[int] = None,
              tenant: str = "",
              tenant_depth: int = 0) -> None:
        """Raise :class:`RequestShed` if the request should not enter the
        queue; record the admission otherwise. ``deadline`` is an absolute
        ``time.monotonic()`` instant (None = no SLO); ``model`` scopes
        the p99 estimate to the model being requested; ``fingerprint``
        is the payload's quarantine key (None = not fingerprintable);
        ``tenant_depth`` is the requesting tenant's current queue
        occupancy, judged against its ``XGBTPU_TENANT_QUOTA``."""
        if self.draining:
            self._shed.labels(reason=DRAINING).inc()
            raise RequestShed(DRAINING, "server is draining (SIGTERM)")
        quota = self.quotas.get(tenant, self.quotas.get("*"))
        if quota is not None and tenant_depth >= quota:
            self._shed.labels(reason=TENANT_QUOTA).inc()
            raise RequestShed(
                TENANT_QUOTA,
                f"tenant {tenant or 'default'!r} has {tenant_depth} "
                f"queued >= quota {quota}")
        if self.faults.quarantine.quarantined(fingerprint):
            self._shed.labels(reason=QUARANTINE).inc()
            raise RequestShed(
                QUARANTINE,
                f"input fingerprint {fingerprint:08x} is a repeat "
                "poison offender")
        if queue_depth >= self.max_queue:
            self._shed.labels(reason=QUEUE_FULL).inc()
            raise RequestShed(
                QUEUE_FULL, f"queue depth {queue_depth} >= {self.max_queue}")
        if deadline is not None:
            now = time.monotonic()
            if now >= deadline:
                self._shed.labels(reason=DEADLINE).inc()
                raise RequestShed(DEADLINE, "deadline already past at admit")
            # projected completion: everything ahead of us plus our own
            # dispatch, each at the observed tail latency
            p99 = self.p99_s(model)
            eta = (queue_depth + 1) * p99
            if now + eta > deadline:
                self._shed.labels(reason=SLO).inc()
                raise RequestShed(
                    SLO, f"projected wait {eta * 1e3:.1f}ms past deadline "
                         f"(queue depth {queue_depth}, "
                         f"p99 {p99 * 1e3:.2f}ms"
                         + (f" for {model}" if model else "") + ")")
        # breaker LAST: an admitted half-open probe must actually reach
        # dispatch, so it only burns its slot after every cheaper check
        # has passed (a probe shed on queue_full would wedge recovery)
        if model:
            name = model.split("@", 1)[0]
            if not self.faults.breaker(name).allow():
                self._shed.labels(reason=BREAKER).inc()
                raise RequestShed(
                    BREAKER, f"circuit breaker for {name!r} is open")
        self._admitted.inc()

    def shed_at_dispatch(self, reason: str = DEADLINE) -> RequestShed:
        """Count and build the exception for a queued request that aged
        out before its dispatch (the batcher resolves its future with it)."""
        self._shed.labels(reason=reason).inc()
        return RequestShed(reason, "deadline passed while queued")
