"""Self-healing serving plane: fault isolation, breakers, quarantine (the
port of the JAX package's ``serving/faults.py``, over the port's
``resilience.policy`` and ``chaos``).

Any exception inside a coalesced dispatch would fail *every* co-batched
caller. This module gives the serving plane the training plane's
treatment: classification, bounded retry, quarantine, crash-only recovery.

- **batch fault isolation** (:func:`isolate_dispatch`): a failed
  coalesced dispatch is classified through ``resilience.policy``;
  transients get ONE bounded same-batch retry (``XGBTPU_RETRY`` site
  ``serving_dispatch``, default 1), persistent failures trigger
  **bisection re-dispatch**: the batch is split and re-dispatched until
  the poison member(s) are isolated. Exactly those members fail (with a
  typed :class:`RequestError` carrying the ``request_id``); innocent
  co-batched requests succeed with the bits they would get alone (rows
  walk independently). A fault at kernel B's launch site (the ``pallas``
  chaos site, which ``predict_margin`` passes on either device) takes
  this ladder too: no walk on the host ever serves it.
- **quarantine** (:class:`Quarantine`): repeat offenders, keyed by a cheap
  input :func:`fingerprint`, are shed at admission
  (``requests_shed_total{reason="quarantine"}``) after
  ``XGBTPU_QUARANTINE_AFTER`` isolated offenses (default 2).
- **per-model circuit breakers** (:class:`CircuitBreaker`): a model whose
  dispatches keep failing trips CLOSED -> OPEN and its requests shed at
  admission (``requests_shed_total{reason="breaker"}``) for
  ``XGBTPU_BREAKER_OPEN_S``; then HALF_OPEN admits one probe request:
  success closes the breaker, failure re-opens it. State is a gauge
  (``serving_breaker_state{model=}``), every transition a counter, a
  trace instant and a serving-recorder timeline event.
- **poison payload injection**: with ``XGBTPU_CHAOS_POISON=<float>``
  armed, any dense dispatch whose rows contain exactly that value raises
  a PERMANENT chaos fault at site ``serving_dispatch``; the poison rides
  the member's rows, so it drives the bisection path like a real poison
  input. ``XGBTPU_CHAOS_MODEL`` does the same for model versions.

Every failure is counted twice: ``faults_total{site,kind}`` (the
process-wide resilience series, ``policy.record_failure``) and
``serving_faults_total{site,kind}`` (the serving plane's slice).

This module is the one place on the serving dispatch path that catches
broad exceptions.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..observability import trace
from ..observability.metrics import REGISTRY
from ..resilience import chaos, policy

__all__ = [
    "RequestError", "CircuitBreaker", "Quarantine", "FaultDomain",
    "CLOSED", "OPEN", "HALF_OPEN", "BREAKER_STATE_NAMES",
    "record_serving_fault", "isolate_dispatch", "fingerprint",
    "check_poison", "check_model_poison",
]

_ENV_POISON = "XGBTPU_CHAOS_POISON"
_ENV_MODEL_POISON = "XGBTPU_CHAOS_MODEL"
_ENV_QUARANTINE_AFTER = "XGBTPU_QUARANTINE_AFTER"
_ENV_BREAKER_WINDOW = "XGBTPU_BREAKER_WINDOW"
_ENV_BREAKER_THRESHOLD = "XGBTPU_BREAKER_THRESHOLD"
_ENV_BREAKER_MIN = "XGBTPU_BREAKER_MIN"
_ENV_BREAKER_OPEN_S = "XGBTPU_BREAKER_OPEN_S"
_ENV_BREAKER_LATENCY_MS = "XGBTPU_BREAKER_LATENCY_MS"

DISPATCH_SITE = "serving_dispatch"


def _env_num(name: str, default, conv=float):
    try:
        return conv(os.environ.get(name, str(default)))
    except ValueError:
        return default


class RequestError(RuntimeError):
    """The typed per-request failure of the isolation machinery: exactly
    the poison member(s) of a coalesced dispatch receive it (innocent
    co-batched requests succeed). Carries the ``request_id`` its access
    log line / trace track were written under, the fault ``site`` and
    the classified ``kind``."""

    def __init__(self, site: str, kind: str, detail: str,
                 request_id: Optional[str] = None):
        super().__init__(
            f"request failed at {site} ({kind}): {detail}")
        self.site = site
        self.kind = kind
        self.request_id = request_id


def record_serving_fault(site: str, exc: Optional[BaseException] = None,
                         kind: Optional[str] = None) -> str:
    """Classify and account one serving-plane failure: the process-wide
    ``faults_total{site,kind}`` (+ trace instant, via the resilience
    policy) AND the serving slice ``serving_faults_total{site,kind}``.
    Returns the classified kind."""
    kind = policy.record_failure(site, exc, kind=kind)
    REGISTRY.counter(
        "serving_faults_total",
        "Failures observed on the serving plane, by site and kind",
    ).labels(site=site, kind=kind).inc()
    return kind


# ---------------------------------------------------------------------------
# input fingerprinting + poison payloads
# ---------------------------------------------------------------------------

#: fingerprint at most this many payload bytes (cheap by construction:
#: serving requests are small; a colliding prefix only makes quarantine
#: slightly over-eager, never incorrect — it is a shed, not an answer)
_FP_CAP_BYTES = 1 << 16


def fingerprint(X) -> Optional[int]:
    """A cheap, deterministic fingerprint of a dense request payload
    (shape + a CRC of at most 64 KiB of its bytes). None for inputs we
    do not fingerprint (sparse rides its own dispatch group)."""
    if not isinstance(X, np.ndarray):
        return None
    a = np.ascontiguousarray(X)
    view = a.view(np.uint8).reshape(-1)[:_FP_CAP_BYTES]
    return zlib.crc32(repr(a.shape).encode()
                      + view.tobytes()) & 0xFFFFFFFF


class _PoisonError(chaos.ChaosPermanent):
    """A poison-payload hit: PERMANENT (sticky per member — re-dispatch
    cannot fix it), so isolation bisects instead of retrying."""

    def __init__(self, site: str, value: float):
        # ChaosError.__init__(site, hit_index) — hit index is meaningless
        # for payload-keyed poison; reuse 0 and override the message
        super().__init__(site, 0)
        self.args = (f"chaos: poison payload (value {value!r}) "
                     f"at site={site!r}",)


def check_poison(X, site: str = DISPATCH_SITE) -> None:
    """Raise a PERMANENT chaos fault if the armed poison sentinel value
    (``XGBTPU_CHAOS_POISON``) appears in this dense payload. One dict
    lookup when unarmed — production cost is nil."""
    raw = os.environ.get(_ENV_POISON)
    if not raw:
        return
    try:
        value = float(raw)
    except ValueError:
        return
    if isinstance(X, np.ndarray) and bool(np.any(X == np.float32(value))):
        raise _PoisonError(site, value)


class _ModelPoisonError(chaos.ChaosPermanent):
    """A model-version poison hit: PERMANENT and sticky per label, the
    scripted analog of a bad model version reaching production. Drives
    the delivery controller's breaker-trip -> auto-rollback path
    deterministically."""

    def __init__(self, site: str, label: str):
        super().__init__(site, 0)
        self.args = (f"chaos: poisoned model version {label!r} "
                     f"at site={site!r}",)


def check_model_poison(label: str, site: str = DISPATCH_SITE) -> None:
    """Raise a PERMANENT chaos fault when this dispatch's model label
    (``name@vN``) is named by ``XGBTPU_CHAOS_MODEL`` (comma-separated
    labels). Re-read per dispatch, so a test or an operator can arm it AFTER
    a promotion lands — a regression that only the promoted version
    exhibits. One dict lookup when unarmed."""
    raw = os.environ.get(_ENV_MODEL_POISON)
    if not raw:
        return
    if label in {p.strip() for p in raw.split(",") if p.strip()}:
        raise _ModelPoisonError(site, label)


# ---------------------------------------------------------------------------
# quarantine: repeat offenders stopped at admission
# ---------------------------------------------------------------------------


class Quarantine:
    """Offense ledger keyed by input fingerprint. The first
    ``after - 1`` isolated failures of a payload cost a bisection each;
    from offense ``after`` on, the admission layer sheds the payload
    before it reaches the batcher. LRU-capped so a high-cardinality
    attack cannot grow the ledger without bound."""

    def __init__(self, after: Optional[int] = None, cap: int = 1024):
        if after is None:
            after = _env_num(_ENV_QUARANTINE_AFTER, 2, int)
        self.after = max(1, int(after))
        self.cap = max(8, int(cap))
        self._lock = threading.Lock()
        self._offenses: "OrderedDict[int, int]" = OrderedDict()
        self._g = REGISTRY.gauge(
            "serving_quarantined_inputs",
            "Input fingerprints currently quarantined at admission")
        self._shed_q = REGISTRY.counter(
            "serving_quarantine_offenses_total",
            "Poison-request offenses recorded against input fingerprints")
        self._g.set(0)

    def note(self, fp: Optional[int]) -> bool:
        """Record one isolated offense. True if the fingerprint is now
        quarantined."""
        if fp is None:
            return False
        with self._lock:
            n = self._offenses.pop(fp, 0) + 1
            self._offenses[fp] = n
            while len(self._offenses) > self.cap:
                self._offenses.popitem(last=False)
            self._publish_locked()
        self._shed_q.inc()
        return n >= self.after

    def quarantined(self, fp: Optional[int]) -> bool:
        if fp is None:
            return False
        with self._lock:
            n = self._offenses.get(fp)
            if n is not None:
                self._offenses.move_to_end(fp)
            return n is not None and n >= self.after

    def _publish_locked(self) -> None:
        self._g.set(sum(1 for n in self._offenses.values()
                        if n >= self.after))


# ---------------------------------------------------------------------------
# per-model circuit breakers
# ---------------------------------------------------------------------------

CLOSED = 0
OPEN = 1
HALF_OPEN = 2
BREAKER_STATE_NAMES = {CLOSED: "closed", OPEN: "open",
                       HALF_OPEN: "half_open"}


class CircuitBreaker:
    """Error-rate/latency breaker for one model name (versions share it:
    a bad swap trips the name, the half-open probe recovers it).

    CLOSED: outcomes feed a rolling window (``XGBTPU_BREAKER_WINDOW``,
    default 32); once at least ``XGBTPU_BREAKER_MIN`` (default 8)
    outcomes are in the window and the failure rate reaches
    ``XGBTPU_BREAKER_THRESHOLD`` (default 0.5), the breaker OPENs.
    A dispatch also counts as a failure when it is slower than
    ``XGBTPU_BREAKER_LATENCY_MS`` (default 0 = latency tripping off).

    OPEN: :meth:`allow` answers False (admission sheds with reason
    ``breaker``) until ``XGBTPU_BREAKER_OPEN_S`` (default 5) elapses.

    HALF_OPEN: exactly one probe request is admitted; its dispatch
    outcome closes (success) or re-opens (failure) the breaker. A probe
    that never reports back (shed downstream, client gone) is given up
    on after another open-interval, releasing the probe slot.
    """

    def __init__(self, model: str, *, window: Optional[int] = None,
                 threshold: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 open_s: Optional[float] = None,
                 latency_ms: Optional[float] = None,
                 on_event: Optional[Callable] = None):
        self.model = model
        self.window = max(2, window if window is not None
                          else _env_num(_ENV_BREAKER_WINDOW, 32, int))
        self.threshold = min(max(
            threshold if threshold is not None
            else _env_num(_ENV_BREAKER_THRESHOLD, 0.5), 0.01), 1.0)
        self.min_samples = max(1, min_samples if min_samples is not None
                               else _env_num(_ENV_BREAKER_MIN, 8, int))
        self.open_s = max(0.001, open_s if open_s is not None
                          else _env_num(_ENV_BREAKER_OPEN_S, 5.0))
        self.latency_ms = max(0.0, latency_ms if latency_ms is not None
                              else _env_num(_ENV_BREAKER_LATENCY_MS, 0.0))
        self._on_event = on_event
        self._lock = threading.Lock()
        self._state = CLOSED
        self._outcomes: "deque[int]" = deque(maxlen=self.window)  # 1=fail
        self._opened_at = 0.0
        self._probing = False
        self._probe_at = 0.0
        self._gauge = REGISTRY.gauge(
            "serving_breaker_state",
            "Per-model circuit breaker: 0 closed, 1 open, 2 half_open",
        ).labels(model=model)
        self._transitions = REGISTRY.counter(
            "serving_breaker_transitions_total",
            "Circuit breaker state transitions, by model and target state")
        self._shed_total = REGISTRY.counter(
            "requests_shed_total",
            "Requests declined by SLO-aware admission, by reason")
        self._gauge.set(CLOSED)

    # ------------------------------------------------------------------
    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """The admission verdict for one request against this model.
        False = shed with reason ``breaker`` (the caller counts it)."""
        transition = None
        with self._lock:
            if self._state == CLOSED:
                return True
            now = time.monotonic()
            if self._state == OPEN:
                if now - self._opened_at < self.open_s:
                    return False
                transition = (OPEN, HALF_OPEN, "cooldown expired")
                self._set_locked(HALF_OPEN)
                self._probing = True
                self._probe_at = now
                out = True  # this request IS the probe
            else:  # HALF_OPEN
                if self._probing and now - self._probe_at < self.open_s:
                    return False  # a probe is already in flight
                self._probing = True  # prior probe vanished: replace it
                self._probe_at = now
                out = True
        if transition is not None:
            self._announce(*transition)
        return out

    def record(self, ok: bool, latency_s: float = 0.0) -> None:
        """Feed one dispatch outcome (the batcher calls this once per
        coalesced dispatch group)."""
        fail = (not ok) or (self.latency_ms > 0
                            and latency_s * 1e3 > self.latency_ms)
        transition = None
        with self._lock:
            if self._state == HALF_OPEN:
                self._probing = False
                if fail:
                    transition = (HALF_OPEN, OPEN, "probe failed")
                    self._set_locked(OPEN)
                    self._opened_at = time.monotonic()
                else:
                    transition = (HALF_OPEN, CLOSED, "probe succeeded")
                    self._set_locked(CLOSED)
                    self._outcomes.clear()
            elif self._state == CLOSED:
                self._outcomes.append(1 if fail else 0)
                n = len(self._outcomes)
                if n >= self.min_samples:
                    rate = sum(self._outcomes) / n
                    if rate >= self.threshold:
                        transition = (
                            CLOSED, OPEN,
                            f"failure rate {rate:.2f} >= "
                            f"{self.threshold:.2f} over {n}")
                        self._set_locked(OPEN)
                        self._opened_at = time.monotonic()
            # OPEN: outcomes of already-in-flight dispatches are ignored
        if transition is not None:
            self._announce(*transition)

    # ------------------------------------------------------------------
    def _set_locked(self, state: int) -> None:
        self._state = state
        self._gauge.set(state)

    def _announce(self, old: int, new: int, detail: str) -> None:
        self._transitions.labels(
            model=self.model, to=BREAKER_STATE_NAMES[new]).inc()
        trace.instant("breaker_transition", model=self.model,
                      frm=BREAKER_STATE_NAMES[old],
                      to=BREAKER_STATE_NAMES[new], detail=detail)
        if self._on_event is not None:
            self._on_event("breaker_transition", model=self.model,
                           frm=BREAKER_STATE_NAMES[old],
                           to=BREAKER_STATE_NAMES[new], detail=detail)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"model": self.model,
                    "state": BREAKER_STATE_NAMES[self._state],
                    "window_failures": sum(self._outcomes),
                    "window": len(self._outcomes)}

    def reset(self) -> None:
        with self._lock:
            self._set_locked(CLOSED)
            self._outcomes.clear()
            self._probing = False


# ---------------------------------------------------------------------------
# the per-server fault domain
# ---------------------------------------------------------------------------


class FaultDomain:
    """One server's fault-handling state: per-model breakers + the
    quarantine ledger, sharing the serving recorder's timeline hook so
    breaker trips and quarantines land next to the latency cliff they
    explain in ``serve-report``."""

    def __init__(self, on_event: Optional[Callable] = None):
        self.on_event = on_event or (lambda name, **args: None)
        self.quarantine = Quarantine()
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def breaker(self, model_name: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(model_name)
            if b is None:
                b = self._breakers[model_name] = CircuitBreaker(
                    model_name, on_event=self.on_event)
            return b

    def note_offender(self, fp: Optional[int], model: str = "") -> None:
        """Record one isolated poison offense; emits the quarantine
        timeline event on the offense that crosses the threshold."""
        if self.quarantine.note(fp):
            self.on_event("quarantine", model=model,
                          fingerprint=f"{fp:08x}" if fp is not None else "")

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            breakers = {n: b.snapshot() for n, b in self._breakers.items()}
        return {"breakers": breakers,
                "quarantine_after": self.quarantine.after}


# ---------------------------------------------------------------------------
# batch fault isolation
# ---------------------------------------------------------------------------


def isolate_dispatch(grp: List[Any], dispatch: Callable[[List[Any]], Any],
                     *, domain: Optional[FaultDomain] = None,
                     model: str = "", site: str = DISPATCH_SITE
                     ) -> Tuple[List[Tuple[Any, np.ndarray]],
                                List[Tuple[Any, BaseException]]]:
    """Run one coalesced dispatch with fault isolation.

    ``grp`` is the batcher's request list (each item exposes ``.n`` rows
    and ``.fp`` fingerprint); ``dispatch(sub)`` runs the actual predict
    for a sub-list and returns the stacked output rows. Returns
    ``(ok, failed)``: ``ok`` pairs each served request with its own
    output rows; ``failed`` pairs each poison request with the exception
    that condemned it (the batcher wraps it in :class:`RequestError`).

    Fault ladder (the off-the-hot-path guarantee: a clean dispatch costs
    exactly one ``dispatch()`` call and no classification work):

    1. dispatch the whole group; success -> done.
    2. classify the failure. TRANSIENT gets one bounded same-batch
       retry (``XGBTPU_RETRY`` site ``serving_dispatch``, default 1).
    3. still failing: bisect — split the group, re-dispatch each half
       (no further same-batch retries), recurse. A failing singleton is
       the poison member: it alone fails, and its fingerprint is
       recorded against the quarantine threshold.
    """
    ok: List[Tuple[Any, np.ndarray]] = []
    failed: List[Tuple[Any, BaseException]] = []
    env_budget = policy.retry_budget(site)
    retries = 1 if env_budget is None else max(0, int(env_budget))

    def _slice(sub: List[Any], out) -> None:
        off = 0
        for req in sub:
            ok.append((req, np.asarray(out[off: off + req.n])))
            off += req.n

    def _run(sub: List[Any], allow_retry: bool) -> None:
        try:
            out = dispatch(sub)
        except Exception as e:
            kind = record_serving_fault(site, e)
            if kind == policy.TRANSIENT and allow_retry and retries > 0:
                REGISTRY.counter(
                    "serving_batch_retries_total",
                    "Same-batch retries of a transiently failed "
                    "coalesced dispatch").inc()
                try:
                    out = dispatch(sub)
                except Exception as e2:
                    record_serving_fault(site, e2)
                    _split(sub, e2)
                    return
            else:
                _split(sub, e)
                return
        _slice(sub, out)

    def _split(sub: List[Any], exc: BaseException) -> None:
        if len(sub) == 1:
            req = sub[0]
            REGISTRY.counter(
                "serving_poison_requests_total",
                "Requests isolated as the poison member of a failed "
                "coalesced dispatch").inc()
            if domain is not None:
                domain.note_offender(getattr(req, "fp", None), model=model)
            failed.append((req, exc))
            return
        REGISTRY.counter(
            "serving_bisect_dispatches_total",
            "Bisection re-dispatches issued to isolate poison batch "
            "members").inc()
        mid = len(sub) // 2
        _run(sub[:mid], False)
        _run(sub[mid:], False)

    _run(grp, True)
    return ok, failed
