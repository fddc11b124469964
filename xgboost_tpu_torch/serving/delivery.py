"""Continuous train-to-serve delivery: watch, publish, canary, gate,
promote, auto-rollback (the port of the JAX package's
``serving/delivery.py``).

- **watch**: a :class:`DeliveryController` polls a training ``run_dir``
  (``XGBTPU_DELIVERY_POLL_S``) through the verified checkpoint readers
  (``resilience/checkpoint.py``). A torn or bit-flipped checkpoint is
  skipped and counted (``delivery_checkpoints_skipped_total{reason=
  "corrupt"}``) while the old version keeps serving; a quarantined round
  is never picked up again (``reason="quarantined"``).
- **publish**: the newest verified new checkpoint becomes ``name@vN``
  (resident, warm, not live) and the manifest is rewritten (chaos site
  ``delivery_publish``).
- **canary**: *shadow* (``XGBTPU_CANARY_MODE``, default) duplicates a
  deterministic ``request_id``-hash sample of live requests
  (``XGBTPU_CANARY_FRACTION``) to the candidate and diffs the outputs
  (chaos site ``canary_diff``) without touching responses; *fraction*
  serves the sampled requests from the candidate. Candidate and
  incumbent are pinned against arena eviction for the whole window.
- **gate**: over at least ``XGBTPU_CANARY_MIN_REQUESTS`` candidate
  observations, the candidate's live p99 (per-model
  ``predict_latency_seconds``) within ``XGBTPU_PROMOTE_P99_RATIO`` of the
  incumbent's, its error rate no worse, and, with held-out data, its AUC
  (the port's ``metric.create_metric("auc")``) no worse by more than
  ``XGBTPU_PROMOTE_DAUC``.
- **promote**: the warm hot swap (``swap.promote_live``).
- **auto-rollback**: for ``XGBTPU_DELIVERY_BAKE_S`` after the flip the
  controller watches the model's NAME-keyed circuit breaker; a trip
  re-swaps to the last-good version (still pinned, so warm),
  **quarantines** the bad version in the manifest and resets the breaker.

Every step lands on the serving recorder's timeline (checkpoint_seen /
checkpoint_skipped / model_published / canary_start / canary_rejected /
model_promoted / model_rolled_back / model_quarantined).
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability.metrics import REGISTRY
from ..resilience import chaos, checkpoint as _ckpt
from . import faults

__all__ = ["CanaryState", "CanaryRouter", "DeliveryController",
           "attach_shadow", "shadow_diff"]

#: controller fault-classification sites (``faults_total{site=}`` /
#: ``serving_faults_total{site=}``); the first two are chaos-injectable
PUBLISH_SITE = "delivery_publish"
DIFF_SITE = "canary_diff"
WATCH_SITE = "delivery_watch"
SHADOW_SITE = "canary_shadow"

#: the tenant lane shadow traffic rides (kept out of real tenants' fair
#: shares, visibly separate in access logs / per-tenant rollups, and
#: recognized by the batcher to keep shadow failures out of the live
#: breaker/quarantine plane) — defined in tenancy.py next to the other
#: reserved lanes
from .tenancy import SHADOW_TENANT  # noqa: E402  (re-export)

_ENV_FRACTION = "XGBTPU_CANARY_FRACTION"
_ENV_MODE = "XGBTPU_CANARY_MODE"
_ENV_MIN_REQUESTS = "XGBTPU_CANARY_MIN_REQUESTS"
_ENV_CANARY_DEADLINE = "XGBTPU_CANARY_DEADLINE_S"
_ENV_DAUC = "XGBTPU_PROMOTE_DAUC"
_ENV_P99_RATIO = "XGBTPU_PROMOTE_P99_RATIO"
_ENV_POLL = "XGBTPU_DELIVERY_POLL_S"
_ENV_BAKE = "XGBTPU_DELIVERY_BAKE_S"

#: delivery_state{model=} gauge values
IDLE, CANARY, BAKE = 0, 1, 2


#: the serving package's shared env parser (faults.py owns it)
_env_num = faults._env_num


def _hash_unit(request_id: str) -> float:
    """Deterministic [0, 1) from a request id — the canary split is a
    pure function of the id, so the same request replayed lands on the
    same arm (and tests can pick ids per arm)."""
    return (zlib.crc32(str(request_id).encode("utf-8", "replace"))
            % 1_000_000) / 1e6


# ---------------------------------------------------------------------------
# canary state + the server-side router
# ---------------------------------------------------------------------------


class CanaryState:
    """One active canary: candidate vs incumbent accounting for a model
    name. Thread-safe — request threads observe outcomes, the batcher
    worker runs shadow diffs, the controller reads the gate inputs."""

    def __init__(self, name: str, version: int, incumbent_version: int,
                 *, mode: str = "shadow", fraction: float = 0.25) -> None:
        if mode not in ("shadow", "fraction"):
            raise ValueError(f"unknown canary mode: {mode!r}")
        self.name = name
        self.version = int(version)
        self.incumbent_version = int(incumbent_version)
        self.mode = mode
        self.fraction = min(max(float(fraction), 0.0), 1.0)
        self.candidate_label = f"{name}@v{version}"
        self.incumbent_label = f"{name}@v{incumbent_version}"
        self.started_unix = time.time()
        self._lock = threading.Lock()
        self.requests = {"candidate": 0, "incumbent": 0}
        self.errors = {"candidate": 0, "incumbent": 0}
        self.diffs = 0
        self.max_diff = 0.0
        self.sum_diff = 0.0
        self.shadow_dropped = 0
        self._c_requests = REGISTRY.counter(
            "delivery_canary_requests_total",
            "Requests observed by an active canary, by model and arm")
        self._c_diffs = REGISTRY.counter(
            "delivery_canary_diffs_total",
            "Shadow-mode output diffs computed between canary and "
            "incumbent")

    # -- request arms ---------------------------------------------------
    def route_version(self, request_id: str) -> Optional[int]:
        """Fraction mode only: the candidate version when this request's
        hash falls in the canary fraction, else None (incumbent)."""
        if self.mode == "fraction" \
                and _hash_unit(request_id) < self.fraction:
            return self.version
        return None

    def should_shadow(self, request_id: str) -> bool:
        """Shadow mode only: duplicate this request to the candidate?"""
        return self.mode == "shadow" \
            and _hash_unit(request_id) < self.fraction

    def watch_future(self, fut, which: str) -> None:
        """Observe one request's outcome when its future resolves (the
        callback runs on the resolving thread — counter bumps only).
        Latency is NOT tracked per-arm here: the p99 gate reads the
        per-model ``predict_latency_seconds`` histogram instead."""

        def _cb(f) -> None:
            try:
                exc = f.exception()
            except BaseException:  # cancelled — counts as not-ok
                exc = True
            self.observe(which, exc is None)

        fut.add_done_callback(_cb)

    def observe(self, which: str, ok: bool) -> None:
        with self._lock:
            self.requests[which] += 1
            if not ok:
                self.errors[which] += 1
        self._c_requests.labels(model=self.name, arm=which).inc()

    def note_diff(self, diff: float) -> None:
        with self._lock:
            self.diffs += 1
            self.max_diff = max(self.max_diff, diff)
            self.sum_diff += diff
        self._c_diffs.inc()

    def note_shadow_dropped(self) -> None:
        """A shadow duplicate the server declined to enqueue (shed /
        submit failure): not an arm outcome — the candidate never saw
        it — just visibility."""
        with self._lock:
            self.shadow_dropped += 1

    # -- reads ----------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"candidate": self.requests["candidate"],
                    "incumbent": self.requests["incumbent"],
                    "candidate_errors": self.errors["candidate"],
                    "incumbent_errors": self.errors["incumbent"]}

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "model": self.name, "mode": self.mode,
                "fraction": self.fraction,
                "candidate": self.candidate_label,
                "incumbent": self.incumbent_label,
                "requests": dict(self.requests),
                "errors": dict(self.errors),
                "diffs": self.diffs,
                "max_diff": round(self.max_diff, 9),
                "mean_diff": round(self.sum_diff / self.diffs, 9)
                if self.diffs else 0.0,
                "shadow_dropped": self.shadow_dropped,
            }


class CanaryRouter:
    """The server's per-name canary table. ``ModelServer.predict_async``
    consults it on every request whose version the caller did not pin:
    fraction-mode requests may be re-routed to the candidate, shadow-mode
    requests may be duplicated. No active canary = one dict read."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._active: Dict[str, CanaryState] = {}

    def start(self, state: CanaryState) -> None:
        with self._lock:
            if state.name in self._active:
                raise RuntimeError(
                    f"a canary is already active for {state.name!r}")
            self._active[state.name] = state

    def end(self, name: str) -> Optional[CanaryState]:
        with self._lock:
            return self._active.pop(name, None)

    def active(self, name: str) -> Optional[CanaryState]:
        with self._lock:
            return self._active.get(name)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            states = list(self._active.values())
        return [s.summary() for s in states]


def shadow_diff(state: CanaryState, primary_out, shadow_out) -> None:
    """Diff one shadow pair (max |candidate - incumbent| over the
    flattened outputs; shape mismatch records ``inf`` — a candidate that
    changed output arity is maximally different). Runs on the resolving
    thread; chaos site ``canary_diff`` makes the diff path itself
    fault-injectable, and any failure is classified, never raised into
    the batcher worker."""
    try:
        chaos.hit(DIFF_SITE)
        a = np.asarray(primary_out, np.float64).ravel()
        b = np.asarray(shadow_out, np.float64).ravel()
        d = float(np.max(np.abs(a - b))) if a.shape == b.shape \
            else float("inf")
        state.note_diff(d)
    except Exception as e:
        faults.record_serving_fault(DIFF_SITE, e)


def attach_shadow(state: CanaryState, primary_fut, shadow_fut) -> None:
    """Rendezvous two futures (live response + shadow duplicate) and diff
    their outputs once both resolve. Non-blocking: whichever future
    resolves second performs the diff — callbacks must never wait on the
    sibling, both may resolve on the single batcher worker thread. The
    candidate arm's outcome is observed here (the primary's is observed
    by the server's general canary watch)."""
    slots: Dict[str, Any] = {}
    lock = threading.Lock()

    def _arrive(which: str, f) -> None:
        try:
            exc = f.exception()
        except BaseException:
            exc = True
        if which == "shadow":
            state.observe("candidate", exc is None)
        result = None if exc is not None else f.result()
        with lock:
            slots[which] = (exc, result)
            if len(slots) < 2:
                return
            (p_exc, p_out) = slots["primary"]
            (s_exc, s_out) = slots["shadow"]
        if p_exc is None and s_exc is None:
            shadow_diff(state, p_out, s_out)

    primary_fut.add_done_callback(lambda f: _arrive("primary", f))
    shadow_fut.add_done_callback(lambda f: _arrive("shadow", f))


# ---------------------------------------------------------------------------
# the delivery controller
# ---------------------------------------------------------------------------


class DeliveryController:
    """Watch one training checkpoint directory and deliver its verified
    checkpoints to one model name on a
    :class:`~xgboost_tpu_torch.serving.ModelServer`: publish -> canary ->
    gate -> promote -> bake -> (auto-rollback + quarantine). One
    controller per (server, model name); start with :meth:`start` (daemon
    thread) or drive one cycle with :meth:`poll`. ``eval_data=(X, y)``
    arms the AUC quality gate (without it only the SLO gates apply).
    ``broadcast(msg) -> resp`` mirrors publish/promote/rollback/
    quarantine to a fleet router."""

    def __init__(self, server, name: str, watch_dir: str, *,
                 eval_data: Optional[Tuple[Any, Any]] = None,
                 mode: Optional[str] = None,
                 fraction: Optional[float] = None,
                 min_requests: Optional[int] = None,
                 canary_deadline_s: Optional[float] = None,
                 dauc_tol: Optional[float] = None,
                 p99_ratio: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 bake_s: Optional[float] = None,
                 from_rounds: Optional[int] = None,
                 broadcast: Optional[Callable[[Dict[str, Any]],
                                              Dict[str, Any]]] = None
                 ) -> None:
        self.server = server
        self.name = name
        self.watch_dir = watch_dir
        self.eval_data = eval_data
        self.mode = mode if mode is not None \
            else os.environ.get(_ENV_MODE, "shadow")
        if self.mode not in ("shadow", "fraction"):
            raise ValueError(f"unknown canary mode: {self.mode!r}")
        self.fraction = fraction if fraction is not None \
            else _env_num(_ENV_FRACTION, 0.25)
        self.min_requests = max(1, min_requests if min_requests is not None
                                else _env_num(_ENV_MIN_REQUESTS, 32, int))
        self.canary_deadline_s = canary_deadline_s \
            if canary_deadline_s is not None \
            else _env_num(_ENV_CANARY_DEADLINE, 600.0)
        self.dauc_tol = dauc_tol if dauc_tol is not None \
            else _env_num(_ENV_DAUC, 0.002)
        self.p99_ratio = max(1.0, p99_ratio if p99_ratio is not None
                             else _env_num(_ENV_P99_RATIO, 1.25))
        self.poll_s = max(0.01, poll_s if poll_s is not None
                          else _env_num(_ENV_POLL, 1.0))
        self.bake_s = max(0.0, bake_s if bake_s is not None
                          else _env_num(_ENV_BAKE, 30.0))
        self.broadcast = broadcast
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._state = IDLE
        self._published: Dict[int, int] = {}  # rounds -> version
        self._skipped_once: set = set()  # (path, size) already counted
        self._history: List[Dict[str, Any]] = []
        # restart resilience: rounds quarantined by a PREVIOUS controller
        # live in the manifest the server restored — never re-promote them
        self._quarantined_rounds: set = {
            int(info.get("rounds", -1))
            for info in server.quarantined_versions(name).values()
            if info.get("rounds") is not None}
        if from_rounds is not None:
            self._processed = int(from_rounds)
        else:
            # default baseline: when the server already serves this name,
            # assume the operator seeded it from the newest checkpoint
            # present now — only NEW checkpoints are delivered. A server
            # without the model delivers everything from round 0.
            got = _ckpt.load_latest(watch_dir) \
                if server.registry.live_version(name) is not None else None
            self._processed = got[1] if got is not None else 0
        self._c_seen = REGISTRY.counter(
            "delivery_checkpoints_seen_total",
            "New verified checkpoints picked up by the delivery watcher")
        self._c_skipped = REGISTRY.counter(
            "delivery_checkpoints_skipped_total",
            "Checkpoints the delivery watcher refused, by reason "
            "(corrupt = failed verification, quarantined = rolled back "
            "earlier)")
        for reason in ("corrupt", "quarantined"):
            self._c_skipped.labels(reason=reason)
        self._c_published = REGISTRY.counter(
            "delivery_publishes_total",
            "Checkpoint versions published (resident, not yet live)")
        self._c_promoted = REGISTRY.counter(
            "delivery_promotions_total",
            "Canary versions promoted to live")
        self._c_rejected = REGISTRY.counter(
            "delivery_canary_rejected_total",
            "Canary versions rejected by the promotion gates, by reason")
        self._c_rollbacks = REGISTRY.counter(
            "delivery_rollbacks_total",
            "Auto-rollbacks to the last-good version after a "
            "post-promotion breaker trip")
        self._c_quarantined = REGISTRY.counter(
            "delivery_quarantines_total",
            "Versions quarantined in the manifest by auto-rollback")
        self._g_state = REGISTRY.gauge(
            "delivery_state",
            "Delivery controller state per model: 0 idle, 1 canary, "
            "2 bake").labels(model=name)
        self._c_promoted.inc(0)
        self._c_rollbacks.inc(0)
        self._g_state.set(IDLE)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "DeliveryController":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name=f"xgbtpu-delivery-{self.name}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        # never leave routing state armed after the controller dies
        state = self.server.canary.end(self.name)
        if state is not None:
            self._unpin(state.version, state.incumbent_version)
            self._set_state(IDLE)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll()
            except Exception as e:
                # the watcher must survive anything a cycle throws (bad
                # disk, publish chaos, a gate read racing a close): the
                # failure is classified and the next poll retries
                faults.record_serving_fault(WATCH_SITE, e)
            self._stop.wait(self.poll_s)

    # ------------------------------------------------------------------
    # one watch cycle
    # ------------------------------------------------------------------
    def poll(self) -> Optional[str]:
        """One watch cycle: scan for a new deliverable checkpoint and, if
        one exists, run the full delivery pipeline on it. Returns the
        cycle outcome (``promoted`` / ``rolled_back`` / ``rejected`` /
        ``bootstrapped`` / None when nothing new)."""
        cand = self._scan()
        if cand is None:
            return None
        path, rounds = cand
        self._event("checkpoint_seen", rounds=rounds, path=path)
        self._c_seen.inc()
        return self._deliver(path, rounds)

    def _scan(self) -> Optional[Tuple[str, int]]:
        """Newest verified checkpoint with rounds beyond the processed
        mark — counting (once) every corrupt or quarantined file it had
        to look past. Multiple new checkpoints collapse to the newest:
        boosting snapshots are strictly cumulative. Steady-state polls
        cost zero file I/O: full verification (a read + sha256 over the
        whole payload) runs only for files NAMED beyond the processed
        mark — a watched multi-hundred-MB model must not be re-hashed
        every ``poll_s`` forever. The filename is only a hint: anything
        it flags as new is fully verified before delivery."""
        for path in reversed(_ckpt.list_checkpoints(self.watch_dir)):
            hint = _ckpt.path_rounds(path)
            if hint is not None and hint <= self._processed:
                return None  # nothing new: settled territory, no reads
            ok, detail, rounds = _ckpt.verify_checkpoint(path)
            if ok and rounds <= self._processed:
                return None  # everything older is already handled
            if not ok:
                try:
                    key = (path, os.path.getsize(path))
                except OSError:
                    key = (path, -1)
                if key not in self._skipped_once:
                    self._skipped_once.add(key)
                    self._c_skipped.labels(reason="corrupt").inc()
                    self._event("checkpoint_skipped", reason="corrupt",
                                detail=detail, path=path)
                continue
            if rounds in self._quarantined_rounds:
                key = (path, "quarantined")
                if key not in self._skipped_once:
                    self._skipped_once.add(key)
                    self._c_skipped.labels(reason="quarantined").inc()
                    self._event("checkpoint_skipped",
                                reason="quarantined", rounds=rounds,
                                path=path)
                continue
            return path, rounds
        return None

    # ------------------------------------------------------------------
    # the delivery pipeline
    # ------------------------------------------------------------------
    def _deliver(self, path: str, rounds: int) -> str:
        version = self._publish(path, rounds)
        incumbent = self.server.registry.live_version(self.name)
        if incumbent is None:
            # bootstrap: no incumbent to canary against — promote
            # directly (first model for this name)
            self.server.promote(self.name, version)
            self._promote_fleet(version)
            self._c_promoted.inc()
            self._finish(rounds, "bootstrapped", version=version)
            return "bootstrapped"
        if incumbent == version:
            self._finish(rounds, "already_live", version=version)
            return "already_live"

        state = CanaryState(self.name, version, incumbent,
                            mode=self.mode, fraction=self.fraction)
        self._pin(version, incumbent)
        self.server.canary.start(state)
        self._set_state(CANARY)
        self._event("canary_start", model=state.candidate_label,
                    incumbent=state.incumbent_label, mode=self.mode,
                    fraction=self.fraction,
                    min_requests=self.min_requests)
        try:
            filled = self._await_canary(state)
            verdict, detail = self._gate(state) if filled \
                else (False, {"reasons": ["canary_timeout"],
                              **state.counts()})
        finally:
            self.server.canary.end(self.name)
        if not verdict:
            self._unpin(version, incumbent)
            self._set_state(IDLE)
            reason = ",".join(detail.get("reasons", [])) or "gate"
            self._c_rejected.labels(reason=reason).inc()
            self._event("canary_rejected", model=state.candidate_label,
                        **detail)
            if "canary_timeout" not in detail.get("reasons", ()):
                # a gate-failed candidate would fail again — settled; a
                # timeout (no traffic) stays pending and retries
                self._finish(rounds, "rejected", version=version,
                             detail=detail)
                # a settled rejection releases everything publish took
                # (arena entry, retained source, manifest row, spilled
                # bytes, fleet copies): an online loop rejecting
                # candidates for weeks must not grow disk or manifest
                with self._lock:
                    self._published.pop(rounds, None)
                self.server.discard_version(self.name, version)
                self._fleet({"op": "unload", "model": self.name,
                             "version": version})
            return "rejected"

        self.server.promote(self.name, version)
        self._promote_fleet(version)
        self._c_promoted.inc()
        outcome = self._bake(version, incumbent, rounds)
        self._unpin(version, incumbent)
        self._set_state(IDLE)
        self._finish(rounds, outcome, version=version)
        return outcome

    def _publish(self, path: str, rounds: int) -> int:
        """Idempotent publish: the resident (not live) version for this
        checkpoint, loading it only once across retried cycles. The
        VERIFIED PAYLOAD is published as raw model bytes — not the
        checkpoint path — so the manifest spills it durably and the
        served version survives training-side retention pruning the
        file it came from (the training dir owns its files; the serving
        plane owns its versions)."""
        got = self._published.get(rounds)
        if got is not None:
            return got
        chaos.hit(PUBLISH_SITE)
        try:
            verified = _ckpt.read_checkpoint(path)
            if verified is None:
                raise ValueError(
                    f"checkpoint {path!r} no longer verifies (pruned or "
                    "corrupted between scan and publish)")
            label = self.server.publish(self.name, bytes(verified[0]))
        except Exception as e:
            faults.record_serving_fault(PUBLISH_SITE, e)
            raise
        version = int(label.rsplit("@v", 1)[1])
        with self._lock:
            self._published[rounds] = version
        self._c_published.inc()
        if self.broadcast is not None:
            # ship the manifest-spilled copy (serving-plane-owned, so it
            # survives training retention pruning), never the training
            # checkpoint path — a replica that faults the version back in
            # after the trainer pruned the .ckpt must still find bytes
            src = self.server.durable_source(self.name, version) or path
            self._fleet({"op": "load", "model": self.name, "path": src,
                         "version": version, "live": False})
        return version

    def _await_canary(self, state: CanaryState) -> bool:
        """Block until the candidate arm saw ``min_requests`` outcomes
        (True) or the canary deadline / a stop passed (False)."""
        deadline = time.monotonic() + self.canary_deadline_s
        while not self._stop.is_set() and time.monotonic() < deadline:
            if state.counts()["candidate"] >= self.min_requests:
                return True
            self._stop.wait(0.02)
        return state.counts()["candidate"] >= self.min_requests

    def _gate(self, state: CanaryState) -> Tuple[bool, Dict[str, Any]]:
        """The promotion verdict: live SLO (p99 ratio + error rate) and
        held-out AUC. Returns (ok, detail-for-the-timeline)."""
        reasons: List[str] = []
        detail: Dict[str, Any] = dict(state.counts())
        cand_p99 = REGISTRY.quantile("predict_latency_seconds", 0.99,
                                     model=state.candidate_label)
        inc_p99 = REGISTRY.quantile("predict_latency_seconds", 0.99,
                                    model=state.incumbent_label)
        if cand_p99 is not None:
            detail["candidate_p99_s"] = round(cand_p99, 9)
        if inc_p99 is not None:
            detail["incumbent_p99_s"] = round(inc_p99, 9)
        if cand_p99 is not None and inc_p99 is not None \
                and cand_p99 > inc_p99 * self.p99_ratio:
            reasons.append("p99")
        c = state.counts()
        cand_err = c["candidate_errors"] / max(c["candidate"], 1)
        inc_err = c["incumbent_errors"] / max(c["incumbent"], 1)
        detail["candidate_error_rate"] = round(cand_err, 6)
        detail["incumbent_error_rate"] = round(inc_err, 6)
        if cand_err > inc_err + 1e-9:
            reasons.append("error_rate")
        if self.eval_data is not None:
            try:
                cand_auc = self._auc(state.version)
                inc_auc = self._auc(state.incumbent_version)
                detail["candidate_auc"] = round(cand_auc, 6)
                detail["incumbent_auc"] = round(inc_auc, 6)
                detail["dauc"] = round(cand_auc - inc_auc, 6)
                if cand_auc - inc_auc < -self.dauc_tol:
                    reasons.append("auc")
            except Exception as e:
                faults.record_serving_fault(WATCH_SITE, e)
                reasons.append("auc_eval_failed")
        detail["reasons"] = reasons
        return not reasons, detail

    def _auc(self, version: int) -> float:
        """Held-out AUC of one resident version (``create_metric("auc")``)
        on the controller's eval slice, through the in-place path traffic
        uses."""
        from ..metric import create_metric

        X, y = self.eval_data
        entry = self.server.registry.get(self.name, version)
        pred = entry.booster.inplace_predict(np.asarray(X, np.float32))
        return float(create_metric("auc").evaluate(
            torch.as_tensor(np.asarray(pred, np.float32)),
            torch.as_tensor(np.asarray(y, np.float32))))

    def _bake(self, version: int, incumbent: int, rounds: int) -> str:
        """Post-promotion breaker watch: ``bake_s`` seconds during which
        a NAME-keyed breaker trip triggers rollback + quarantine."""
        self._set_state(BAKE)
        breaker = self.server.faults.breaker(self.name)
        deadline = time.monotonic() + self.bake_s
        while not self._stop.is_set() and time.monotonic() < deadline:
            if breaker.state == faults.OPEN:
                self._rollback(version, incumbent, rounds)
                return "rolled_back"
            self._stop.wait(0.02)
        if breaker.state == faults.OPEN:  # tripped right at the wire
            self._rollback(version, incumbent, rounds)
            return "rolled_back"
        return "promoted"

    def _rollback(self, version: int, incumbent: int, rounds: int) -> None:
        """Re-swap to last-good (still pinned → warm), quarantine the bad
        version in the manifest, reset the breaker the bad version
        tripped so restored traffic flows immediately."""
        self.server.rollback(self.name, incumbent)
        self._fleet({"op": "rollback", "model": self.name,
                     "version": incumbent})
        self._c_rollbacks.inc()
        self.server.quarantine_version(self.name, version, rounds=rounds)
        self._fleet({"op": "quarantine", "model": self.name,
                     "version": version, "rounds": rounds})
        with self._lock:
            self._quarantined_rounds.add(rounds)
        self._c_quarantined.inc()
        self.server.faults.breaker(self.name).reset()

    def _promote_fleet(self, version: int) -> None:
        self._fleet({"op": "promote", "model": self.name,
                     "version": version})

    def _fleet(self, msg: Dict[str, Any]) -> None:
        """Mirror one control op to the fleet router (best effort with
        classification: the shared manifest re-converges any replica a
        broadcast missed on its next restart)."""
        if self.broadcast is None:
            return
        try:
            resp = self.broadcast(msg) or {}
            if resp.get("error"):
                raise RuntimeError(f"fleet {msg.get('op')}: "
                                   f"{resp['error']}")
        except Exception as e:
            faults.record_serving_fault(WATCH_SITE, e)

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    def _pin(self, *versions: int) -> None:
        for v in versions:
            self.server.registry.pin(self.name, v, True)

    def _unpin(self, *versions: int) -> None:
        for v in versions:
            self.server.registry.pin(self.name, v, False)

    def _set_state(self, state: int) -> None:
        with self._lock:
            self._state = state
        self._g_state.set(state)

    def _event(self, name: str, **args: Any) -> None:
        self.server.obs.event(name, **args)

    def _finish(self, rounds: int, outcome: str, **extra: Any) -> None:
        with self._lock:
            self._processed = max(self._processed, rounds)
            self._history.append(
                {"rounds": rounds, "outcome": outcome,
                 "unix_ms": time.time() * 1e3, **extra})
            del self._history[:-32]

    def status(self) -> Dict[str, Any]:
        with self._lock:
            state = self._state
            history = list(self._history)
            processed = self._processed
            published = {str(r): v for r, v in self._published.items()}
            quarantined = sorted(self._quarantined_rounds)
        canary = self.server.canary.active(self.name)
        return {
            "model": self.name, "watch_dir": self.watch_dir,
            "state": {IDLE: "idle", CANARY: "canary",
                      BAKE: "bake"}[state],
            "mode": self.mode, "fraction": self.fraction,
            "min_requests": self.min_requests,
            "processed_rounds": processed,
            "published": published,
            "quarantined_rounds": quarantined,
            "canary": canary.summary() if canary is not None else None,
            "history": history,
        }
