"""``ModelServer``: the serving front end, and its JSONL loop (the port of
the JAX package's ``serving/server.py``).

Composes the pieces of this package around the serving fast path
(``predictor/serving.py``): :class:`~.tenancy.ModelRegistry` (the
multi-model arena), :class:`~.batcher.MicroBatcher` (request coalescing),
:class:`~.admission.AdmissionController` (SLO sheds) and
:func:`~.swap.hot_swap` (zero-downtime version flips). Python callers use
it directly::

    srv = xgboost_tpu_torch.ModelServer({"fraud": "models/fraud.json"})
    fut = srv.predict_async("fraud", rows, deadline_ms=15)
    probs = fut.result()
    srv.swap("fraud", "ckpts/fraud/")     # newest verified checkpoint
    srv.close()

The server's models live on its device: the card unless the caller passes
``device="cpu"``. Non-Python callers use the line protocol (``python -m
xgboost_tpu_torch serve``: one JSON document per line, the JAX package's
ops and fields, on stdin/stdout or a TCP socket). The crash-only manifest
(``run_dir/manifest.json``) is written and read in the JAX package's
format, so either package's server restores the other's.
"""

from __future__ import annotations

import json
import os
import signal
import socketserver
import sys
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np

from .._device import resolve_device
from ..observability import flight as _flight
from ..observability.metrics import REGISTRY
from .admission import AdmissionController, RequestShed
from .batcher import MicroBatcher
from .delivery import SHADOW_TENANT, CanaryRouter, attach_shadow
from .faults import FaultDomain, record_serving_fault
from .obs import ServingRecorder
from .swap import SwapRunner, promote_live, warm_entry
from .tenancy import ModelRegistry

__all__ = ["ModelServer", "serve_main"]

MANIFEST_FORMAT = "xgbtpu-manifest-v1"

#: registry/swap events that change the retained source set (or the
#: quarantine set) and therefore rewrite the crash-only manifest
_MANIFEST_EVENTS = frozenset((
    "model_load", "model_swap", "model_published", "model_promoted",
    "model_rolled_back", "model_quarantined", "model_discarded"))


class ModelServer:
    """Async, micro-batched, multi-tenant model server.

    Construction knobs mirror the env vars: ``arena_mb``
    (XGBTPU_SERVING_ARENA_MB), ``max_queue`` (XGBTPU_SERVING_QUEUE),
    ``batch_wait_us`` (XGBTPU_BATCH_WAIT_US), ``max_batch_rows``
    (XGBTPU_BATCH_MAX_ROWS), ``run_dir`` (XGBTPU_SERVE_DIR: the durable
    observability sink, access log, dispatch flight ring and request trace
    under ``run_dir/obs/server/``, and the crash-only manifest at
    ``run_dir/manifest.json``). ``models`` maps name -> source (model JSON
    path or bytes, a live Booster, or a checkpoint file or directory).
    ``device`` is where every model loads and every dispatch walks: None
    means the card, and raises where there is none."""

    def __init__(self, models: Optional[Dict[str, Any]] = None, *,
                 arena_mb: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 batch_wait_us: Optional[int] = None,
                 max_batch_rows: Optional[int] = None,
                 run_dir: Optional[str] = None,
                 manifest_path: Optional[str] = None,
                 tenant_weights=None, device=None) -> None:
        self.device = resolve_device(device)
        self.obs = ServingRecorder(run_dir)
        # the crash-only contract root: the resident-model manifest (and
        # raw-source spill files) live directly under the run_dir, next
        # to (not inside) the obs/ tree — unless ``manifest_path`` points
        # elsewhere (a fleet of replicas shares ONE manifest while each
        # keeps a private run_dir)
        self._run_root = run_dir or os.environ.get("XGBTPU_SERVE_DIR")
        self._manifest_path = manifest_path or (
            os.path.join(self._run_root, "manifest.json")
            if self._run_root else None)
        self.faults = FaultDomain(on_event=self.obs.event)
        self.registry = ModelRegistry(arena_mb, on_event=self._on_event,
                                      device=self.device)
        self.admission = AdmissionController(max_queue, faults=self.faults)
        self.batcher = MicroBatcher(
            self.admission, obs=self.obs, max_wait_us=batch_wait_us,
            max_batch_rows=max_batch_rows, tenant_weights=tenant_weights,
            device=self.device)
        self._swapper = SwapRunner(self.registry, on_event=self._on_event)
        #: the delivery plane (serving/delivery.py): active canaries per
        #: model name, and the controllers driving them
        self.canary = CanaryRouter()
        self._deliveries: Dict[str, Any] = {}
        self._quarantined: Dict[str, Dict[int, Dict[str, Any]]] = {}
        # gate-rejected published versions dropped by discard_version:
        # the manifest writer scrubs their rows + spilled bytes so a
        # continuous-training loop rejecting candidates cannot grow the
        # manifest or disk without bound (version numbers are never
        # reused, so the tombstones stay valid for the process lifetime)
        self._discarded: Dict[str, set] = {}
        self._state_lock = threading.Lock()
        self._closed = False
        self._draining = False
        self._manifest_lock = threading.Lock()
        if self._manifest_path:
            self._restore_manifest()
        if models:
            for name, source in models.items():
                self.load(name, source)

    # ------------------------------------------------------------------
    def _on_event(self, name: str, **args: Any) -> None:
        """Registry/swap/delivery event hook: timeline recording plus the
        crash-only manifest — every change to the retained source set
        (load, swap, publish, promote, rollback, quarantine) atomically
        rewrites ``run_dir/manifest.json`` so a killed-and-restarted
        server re-faults its full model set with the same live pointers
        and quarantine decisions."""
        self.obs.event(name, **args)
        if name in _MANIFEST_EVENTS:
            self._write_manifest()

    def load(self, name: str, source: Any, *,
             version: Optional[int] = None, warm: bool = True,
             make_live: bool = True) -> str:
        """Load a model version; with ``make_live`` (default) the serving
        pointer flips to it, otherwise the version is merely *published*
        — resident and warm but not serving (the delivery controller's
        canary staging). Returns ``name@vN``."""
        booster = source if hasattr(source, "save_raw") else None
        entry = self.registry.load(name, source, version=version,
                                   booster=booster, make_live=make_live)
        if warm:
            warm_entry(entry)
        self._on_event("model_load" if make_live else "model_published",
                       model=entry.label)
        return entry.label

    def publish(self, name: str, source: Any, *,
                version: Optional[int] = None, warm: bool = True) -> str:
        """Publish a version without flipping the serving pointer:
        ``load(..., make_live=False)``, the staging half of delivery."""
        return self.load(name, source, version=version, warm=warm,
                         make_live=False)

    def promote(self, name: str, version: int, *,
                drain_timeout_s: float = 60.0) -> str:
        """Flip the serving pointer to an already-published version (the
        existing warm hot-swap: flip + drain; the load happened at
        publish). Refuses quarantined versions. Returns ``name@vN``."""
        version = int(version)
        with self._state_lock:
            if version in self._quarantined.get(name, {}):
                raise ValueError(
                    f"{name}@v{version} is quarantined (rolled back by "
                    "delivery); it cannot be promoted")
        return promote_live(
            self.registry, name, version,
            drain_timeout_s=drain_timeout_s, on_event=self._on_event,
            event="model_promoted").label

    def rollback(self, name: str, version: int, *,
                 drain_timeout_s: float = 10.0) -> str:
        """Re-swap to a previous (last-good) version — the delivery
        controller's auto-rollback flip. Same machinery as promote, its
        own timeline event. Returns ``name@vN``."""
        return promote_live(
            self.registry, name, int(version),
            drain_timeout_s=drain_timeout_s, on_event=self._on_event,
            event="model_rolled_back").label

    def quarantine_version(self, name: str, version: int, *,
                           rounds: Optional[int] = None) -> None:
        """Quarantine one version: drop it from the arena AND its
        retained source, record it in the manifest so a restarted server
        (and the delivery watcher — it never re-promotes a quarantined
        round) inherit the decision."""
        version = int(version)
        with self._state_lock:
            self._quarantined.setdefault(name, {})[version] = {
                "rounds": int(rounds) if rounds is not None else None,
                "unix_ms": round(time.time() * 1e3, 3)}
        self.registry.drop(name, version)
        self._on_event("model_quarantined", model=f"{name}@v{version}",
                       rounds=rounds)

    def quarantined_versions(self, name: str) -> Dict[int, Dict[str, Any]]:
        """version -> {rounds, unix_ms} for one model name."""
        with self._state_lock:
            return {v: dict(info) for v, info in
                    self._quarantined.get(name, {}).items()}

    def discard_version(self, name: str, version: int) -> None:
        """Drop a published-but-never-promoted version (a gate-rejected
        delivery candidate): arena entry, retained source, manifest row
        and the spilled model bytes all go. Unlike quarantine this is
        plain cleanup, not a verdict — the round may still be retrained
        and arrive again as a NEW version. Refuses the live version."""
        version = int(version)
        if self.registry.live_version(name) == version:
            raise ValueError(
                f"{name}@v{version} is live; rollback before discarding")
        with self._state_lock:
            self._discarded.setdefault(name, set()).add(version)
        self.registry.pin(name, version, False)
        self.registry.drop(name, version)
        # the spilled bytes go once, here; later manifest rewrites only
        # scrub the ROW (the tombstone set is replayed against the
        # read-merge-write doc, not against the filesystem)
        if self._manifest_path:
            try:
                os.remove(os.path.join(
                    os.path.dirname(self._manifest_path) or ".",
                    "models", f"{name}@v{version}.json"))
            except OSError:
                pass
        self._on_event("model_discarded", model=f"{name}@v{version}")

    def durable_source(self, name: str, version: int) -> Optional[str]:
        """The manifest-spilled copy of one published version
        (``<manifest dir>/models/<name>@vN.json``) when it exists — what
        a fleet publish broadcast ships instead of the training-owned
        checkpoint path, so replicas keep a loadable source after
        training retention prunes the original file."""
        if not self._manifest_path:
            return None
        path = os.path.join(
            os.path.dirname(self._manifest_path) or ".", "models",
            f"{name}@v{int(version)}.json")
        return path if os.path.exists(path) else None

    # ------------------------------------------------------------------
    # delivery controllers
    # ------------------------------------------------------------------
    def deliver(self, name: str, watch_dir: str, **kw: Any):
        """Attach a delivery controller watching ``watch_dir`` for this
        model name (one per name) and start it. Keyword args flow to
        :class:`~xgboost_tpu_torch.serving.delivery.DeliveryController`."""
        from .delivery import DeliveryController

        with self._state_lock:
            if name in self._deliveries:
                raise RuntimeError(
                    f"a delivery controller is already watching {name!r}")
        # construct OUTSIDE the state lock: the controller reads the
        # server's quarantine table (same, non-reentrant lock) in __init__
        ctl = DeliveryController(self, name, watch_dir, **kw)
        with self._state_lock:
            if name in self._deliveries:
                raise RuntimeError(
                    f"a delivery controller is already watching {name!r}")
            self._deliveries[name] = ctl
        return ctl.start()

    def delivery_status(self) -> Dict[str, Any]:
        with self._state_lock:
            ctls = dict(self._deliveries)
        return {name: ctl.status() for name, ctl in ctls.items()}

    def stop_delivery(self, name: str) -> bool:
        with self._state_lock:
            ctl = self._deliveries.pop(name, None)
        if ctl is None:
            return False
        ctl.stop()
        return True

    def swap(self, name: str, source: Any, *,
             version: Optional[int] = None, block: bool = True,
             drain_timeout_s: float = 60.0):
        """Zero-downtime swap to a new version (``swap.py``): warm in the
        background, flip atomically, drain the old snapshot. ``block=False``
        returns the swap thread instead of the new label."""
        booster = source if hasattr(source, "save_raw") else None
        if block:
            return self._swapper.swap(
                name, source, version=version, booster=booster,
                drain_timeout_s=drain_timeout_s).label
        return self._swapper.swap_async(
            name, source, version=version, booster=booster,
            drain_timeout_s=drain_timeout_s)

    # ------------------------------------------------------------------
    # crash-only restart: the resident-model manifest
    # ------------------------------------------------------------------
    def _write_manifest(self) -> None:
        """Atomically persist name@version -> retained source next to the
        manifest. ``raw`` sources (live Boosters) are spilled to
        ``<manifest dir>/models/<name>@v<N>.json`` once so they survive
        the process; path-shaped sources are recorded as-is.

        Fleet contract: N replicas may share ONE manifest.
        Every write is (a) **atomic** — ``flight.atomic_write_json``'s
        pid-unique tmp + rename, so two replicas racing never produce a
        torn file; (b) a **read-merge-write** — versions recorded on disk
        by other replicas are kept (only this server's view of a (name,
        version) it also holds, and its live pointers, win); (c) stamped
        with a **last-writer-wins ``version`` field** (disk version + 1)
        so readers can observe write ordering. The read-merge-write
        window is serialized across processes with a best-effort advisory
        ``flock`` (held for the milliseconds of one merge; a filesystem
        without lock support degrades to lock-free last-writer-wins,
        where a racing writer's very latest registration can be shadowed
        until its next write — readers never see a torn or unparseable
        file either way)."""
        if not self._manifest_path:
            return
        with self._manifest_lock:
            lockf = None
            try:
                import fcntl

                lockf = open(f"{self._manifest_path}.lock", "w")
                fcntl.flock(lockf, fcntl.LOCK_EX)
            except (ImportError, OSError):
                lockf = None  # degrade: atomic rename + LWW version
            try:
                self._write_manifest_merged()
            finally:
                if lockf is not None:
                    try:
                        lockf.close()  # releases the flock
                    except OSError:
                        pass

    def _write_manifest_merged(self) -> None:
        """The read-merge-write body of :meth:`_write_manifest` (runs
        under the process lock, and the cross-process flock when
        available)."""
        root = os.path.dirname(self._manifest_path) or "."
        try:
            with open(self._manifest_path) as f:
                prev = json.load(f)
            if prev.get("format") != MANIFEST_FORMAT:
                prev = {}
        except (OSError, ValueError):
            prev = {}
        models: Dict[str, Any] = {
            name: {"live": info.get("live"),
                   "versions": dict(info.get("versions", {})),
                   "quarantined": dict(info.get("quarantined", {}))}
            for name, info in (prev.get("models") or {}).items()
            if isinstance(info, dict)}
        live = self.registry.models()
        for (name, v), (kind, payload) in sorted(
                self.registry.sources_snapshot().items()):
            if kind == "raw":
                mdir = os.path.join(root, "models")
                path = os.path.join(mdir, f"{name}@v{v}.json")
                try:
                    if not os.path.exists(path):
                        os.makedirs(mdir, exist_ok=True)
                        tmp = f"{path}.tmp.{os.getpid()}"
                        with open(tmp, "wb") as f:
                            f.write(bytes(payload))
                            f.flush()
                            os.fsync(f.fileno())
                        os.replace(tmp, path)
                except OSError:
                    continue  # unspillable source: not restartable
                kind, payload = "file", path
            doc = models.setdefault(
                name, {"live": None, "versions": {}, "quarantined": {}})
            if name in live:
                doc["live"] = live[name]
            doc["versions"][str(v)] = {"kind": kind, "path": payload}
        # quarantine decisions win over everything: a quarantined version
        # loses its retained source (and can never be the live pointer),
        # on this replica's view AND whatever other replicas recorded
        with self._state_lock:
            quarantined = {name: {str(v): dict(info)
                                  for v, info in q.items()}
                           for name, q in self._quarantined.items()}
        for name, q in quarantined.items():
            doc = models.setdefault(
                name, {"live": None, "versions": {}, "quarantined": {}})
            doc.setdefault("quarantined", {}).update(q)
        for name, doc in models.items():
            for v_str in list(doc.get("quarantined", {})):
                doc.get("versions", {}).pop(v_str, None)
                if str(doc.get("live")) == v_str:
                    doc["live"] = None
        # discarded (gate-rejected, never-live) versions lose their row
        # on every rewrite: the read-merge-write keeps versions other
        # replicas recorded, so without the tombstone replay a slower
        # replica's write would resurrect the row (their bytes went once
        # in discard_version; the `unload` broadcast drops other
        # replicas' copies).
        with self._state_lock:
            discarded = {name: sorted(vs)
                         for name, vs in self._discarded.items()}
        for name, versions in discarded.items():
            doc = models.get(name)
            if doc is None:
                continue
            for v in versions:
                doc.get("versions", {}).pop(str(v), None)
        _flight.atomic_write_json(
            self._manifest_path,
            {"format": MANIFEST_FORMAT, "pid": os.getpid(),
             "version": int(prev.get("version", 0) or 0) + 1,
             "unix_ms": time.time() * 1e3, "models": models})

    def _restore_manifest(self) -> None:
        """Crash-only restart: re-register every manifest source LAZILY
        (no booster builds, no compiles) — the first request per model
        faults it in exactly like an LRU eviction would."""
        path = self._manifest_path
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        if doc.get("format") != MANIFEST_FORMAT:
            return
        restored = 0
        for name, info in doc.get("models", {}).items():
            live_v = info.get("live")
            quarantined = set(info.get("quarantined", {}) or {})
            for v_str, q in (info.get("quarantined") or {}).items():
                try:
                    with self._state_lock:
                        self._quarantined.setdefault(name, {})[
                            int(v_str)] = dict(q) if isinstance(q, dict) \
                            else {"rounds": None}
                    # a quarantined version's row was scrubbed, so the
                    # registry cannot learn its number from the sources
                    # below — reserve it, or the next publish would be
                    # assigned a quarantined (unpromotable) version
                    self.registry.reserve_version(name, int(v_str))
                except (TypeError, ValueError):
                    continue
            for v_str, spec in info.get("versions", {}).items():
                if v_str in quarantined:
                    continue  # a quarantined version never serves again
                try:
                    self.registry.register_source(
                        name, int(v_str), (spec["kind"], spec["path"]),
                        live=(live_v is not None
                              and int(v_str) == int(live_v)))
                    restored += 1
                except (KeyError, TypeError, ValueError):
                    continue  # one bad entry must not lose the rest
        if restored:
            self.obs.event("manifest_restore", models=restored)

    # ------------------------------------------------------------------
    def begin_drain(self) -> None:
        """SIGTERM half of crash-only shutdown: stop admitting (new
        requests shed with reason ``draining``) while everything already
        admitted keeps flowing to completion; dump the black box now in
        case the process is killed harder before :meth:`close`."""
        if self._draining:
            return
        self._draining = True
        self.admission.draining = True
        self.obs.event("server_drain")
        self.obs.dump("drain")

    @property
    def draining(self) -> bool:
        return self._draining

    # ------------------------------------------------------------------
    def predict_async(self, name: str, data, *,
                      deadline_ms: Optional[float] = None,
                      version: Optional[int] = None,
                      predict_type: str = "value", iteration_range=None,
                      missing: float = np.nan, base_margin=None,
                      request_id: Optional[str] = None,
                      tenant: str = "") -> "Future":
        """Admit + enqueue one request; the Future resolves to the
        prediction (or raises :class:`RequestShed` / the dispatch error)
        and carries ``.request_id`` — the caller-supplied id or a
        generated one — under which the request's access-log line and
        trace track were written."""
        if self._closed:
            raise RuntimeError("model server is closed")
        rec = self.obs.start_request(request_id, deadline_ms)
        rec.tenant = tenant
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        # delivery canary (serving/delivery.py): requests whose version
        # the caller did not pin may be re-routed to the candidate
        # (fraction mode — deterministic request_id-hash split) or
        # duplicated to it (shadow mode, below). One dict read when no
        # canary is active.
        state = self.canary.active(name) if version is None else None
        route_version = version
        if state is not None:
            cv = state.route_version(rec.id)
            if cv is not None:
                route_version = cv
        try:
            entry = self.registry.get(name, route_version)
        except KeyError as e:
            # unknown model: still one access-log line per request
            rec.model = name
            self.obs.finish(rec, "error", error=f"KeyError: {e}")
            e.request_id = rec.id
            raise
        rec.model = entry.label
        fut = self.batcher.submit(
            entry, data, predict_type=predict_type,
            iteration_range=iteration_range, missing=missing,
            base_margin=base_margin, deadline=deadline, rec=rec,
            tenant=tenant)
        if state is not None:
            which = "candidate" if entry.version == state.version \
                else "incumbent"
            state.watch_future(fut, which)
            if which == "incumbent" and state.should_shadow(rec.id):
                self._shadow_request(
                    state, name, data, fut, rec.id,
                    predict_type=predict_type,
                    iteration_range=iteration_range, missing=missing,
                    base_margin=base_margin)
        return fut

    def _shadow_request(self, state, name: str, data, primary_fut,
                        rid: str, *, predict_type, iteration_range,
                        missing, base_margin) -> None:
        """Duplicate one sampled live request to the canary candidate
        (shadow mode): the duplicate rides the normal batcher on the
        ``_canary`` tenant lane with its own ``<id>~shadow`` access-log
        record; its outcome feeds the candidate arm and the output pair
        is diffed (``delivery.attach_shadow``). The live response is
        never touched — a shed or failed shadow only counts as
        ``shadow_dropped``."""
        try:
            cand = self.registry.get(name, state.version)
            srec = self.obs.start_request(f"{rid}~shadow", None)
            srec.tenant = SHADOW_TENANT
            srec.model = cand.label
            sfut = self.batcher.submit(
                cand, data, predict_type=predict_type,
                iteration_range=iteration_range, missing=missing,
                base_margin=base_margin, rec=srec, tenant=SHADOW_TENANT)
        except RequestShed:
            state.note_shadow_dropped()
            return
        except Exception as e:
            # a shadow must never surface into the live request path:
            # classify (site canary_shadow) and drop the duplicate
            record_serving_fault("canary_shadow", e)
            state.note_shadow_dropped()
            return
        attach_shadow(state, primary_fut, sfut)

    def predict(self, name: str, data, *,
                timeout: Optional[float] = 60.0, **kw) -> np.ndarray:
        return self.predict_async(name, data, **kw).result(timeout)

    # ------------------------------------------------------------------
    def metrics(self) -> str:
        """Prometheus text exposition of the process registry."""
        return REGISTRY.exposition()

    def stats(self) -> Dict[str, Any]:
        """Operational snapshot for the ``stats`` op: arena + queue state
        plus the SLO ledger (stage-histogram p50/p99 overall and per
        model, deadline hit/miss, current error-budget burn, worst
        exemplars) — the JSONL protocol's view of the ledger without
        scraping ``metrics``."""
        self.obs.drain()  # barrier: include every completed request
        out = {
            "arena": self.registry.stats(),
            "queue_depth": self.batcher.queue_depth(),
            "p99_s": self.admission.p99_s(),
            "slo": self.obs.ledger.summary(),
            "faults": self.faults.snapshot(),
            "draining": self._draining,
        }
        canaries = self.canary.snapshot()
        if canaries:
            out["canaries"] = canaries
        with self._state_lock:
            has_delivery = bool(self._deliveries)
            quarantined = {n: sorted(q) for n, q in
                           self._quarantined.items() if q}
        if has_delivery:
            out["delivery"] = self.delivery_status()
        if quarantined:
            out["quarantined"] = quarantined
        return out

    def close(self, drain: bool = True) -> None:
        if not self._closed:
            self._closed = True
            # delivery controllers first: they drive canaries/promotions
            # through the batcher being shut down below
            with self._state_lock:
                ctls = list(self._deliveries.values())
                self._deliveries.clear()
            for ctl in ctls:
                ctl.stop()
            self.batcher.close(drain=drain)
            # seal the flight recorder last: the black box carries the
            # final SLO summary and every drained request's access line
            self.obs.close()

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# JSONL line protocol (stdin/stdout or TCP): the test/ops surface of the
# server. One JSON object per line; every request gets exactly one JSON
# response line. Ops: predict, load, swap, metrics, stats, shutdown.
# ---------------------------------------------------------------------------


def _handle(server: ModelServer, msg: Dict[str, Any],
            shutdown) -> Dict[str, Any]:
    op = msg.get("op", "predict")
    rid = msg.get("id")
    out: Dict[str, Any] = {} if rid is None else {"id": rid}
    try:
        if op == "predict":
            data = np.asarray(msg["data"], np.float32)
            if data.ndim == 1:  # single-row convenience
                data = data.reshape(1, -1)
            # the protocol's message id doubles as the request-trace id,
            # so a client log line and the server's access-log line /
            # trace track correlate without translation
            fut = server.predict_async(
                msg.get("model", "default"), data,
                deadline_ms=msg.get("deadline_ms"),
                request_id=None if rid is None else str(rid),
                tenant=str(msg.get("tenant", "") or ""),
                predict_type=("margin" if msg.get("margin")
                              else "value"),
                iteration_range=(tuple(msg["iteration_range"])
                                 if msg.get("iteration_range") else None),
                missing=float(msg.get("missing", "nan")))
            out["request_id"] = getattr(fut, "request_id", None)
            result = fut.result(msg.get("timeout_s", 60.0))
            out["result"] = np.asarray(result, np.float64).tolist()
        elif op == "load":
            out["version"] = server.load(
                msg["model"], msg["path"], version=msg.get("version"),
                make_live=bool(msg.get("live", True)))
            out["ok"] = True
        elif op == "swap":
            out["version"] = server.swap(
                msg["model"], msg["path"], version=msg.get("version"))
            out["ok"] = True
        elif op == "promote":
            out["version"] = server.promote(msg["model"],
                                            int(msg["version"]))
            out["ok"] = True
        elif op == "rollback":
            out["version"] = server.rollback(msg["model"],
                                             int(msg["version"]))
            out["ok"] = True
        elif op == "quarantine":
            server.quarantine_version(msg["model"], int(msg["version"]),
                                      rounds=msg.get("rounds"))
            out["ok"] = True
        elif op == "unload":
            server.discard_version(msg["model"], int(msg["version"]))
            out["ok"] = True
        elif op == "deliver":
            out.update(_handle_deliver(server, msg))
        elif op == "metrics":
            out["metrics"] = server.metrics()
        elif op == "stats":
            out["stats"] = server.stats()
        elif op == "ping":
            # a fleet router's health probe: one cheap line, no drain
            # barrier
            out["ok"] = True
            out["draining"] = server.draining
            out["queue_depth"] = server.batcher.queue_depth()
            out["pid"] = os.getpid()
        elif op == "shutdown":
            out["ok"] = True
            shutdown()
        else:
            out["error"] = f"unknown op: {op!r}"
    except RequestShed as e:
        out["error"] = str(e)
        out["shed"] = e.reason
        if getattr(e, "request_id", None) is not None:
            out.setdefault("request_id", e.request_id)
    except Exception as e:  # noqa: BLE001 — protocol surface: report, don't die
        out["error"] = f"{type(e).__name__}: {e}"
        if getattr(e, "request_id", None) is not None:
            out.setdefault("request_id", e.request_id)
    return out


def _handle_deliver(server: ModelServer, msg: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """The ``deliver`` protocol op: attach/inspect/stop a delivery
    controller over the wire. ``action``: ``start`` (default; ``model``
    + ``watch`` required, optional ``mode``/``fraction``/
    ``min_requests``/``bake_s``/``poll_s``/``dauc_tol``/``eval_npz`` — an
    ``.npz`` with arrays ``X``/``y`` arming the AUC gate), ``status``,
    ``stop``."""
    action = msg.get("action", "start")
    if action == "status":
        return {"ok": True, "delivery": server.delivery_status()}
    if action == "stop":
        return {"ok": server.stop_delivery(msg["model"])}
    if action != "start":
        return {"error": f"unknown deliver action: {action!r}"}
    kw: Dict[str, Any] = {}
    for key, conv in (("mode", str), ("fraction", float),
                      ("min_requests", int), ("bake_s", float),
                      ("poll_s", float), ("dauc_tol", float),
                      ("p99_ratio", float), ("from_rounds", int),
                      ("canary_deadline_s", float)):
        if msg.get(key) is not None:
            kw[key] = conv(msg[key])
    if msg.get("eval_npz"):
        with np.load(msg["eval_npz"]) as npz:
            kw["eval_data"] = (np.asarray(npz["X"], np.float32),
                               np.asarray(npz["y"]))
    server.deliver(msg["model"], msg["watch"], **kw)
    return {"ok": True, "model": msg["model"], "watch": msg["watch"]}


def _parse_serve_args(argv: List[str]) -> Dict[str, Any]:
    opts: Dict[str, Any] = {"models": {}, "deliver": {}, "port": None,
                            "stdin": False, "host": "127.0.0.1"}
    flags = {"--port": ("port", int), "--arena-mb": ("arena_mb", float),
             "--batch-wait-us": ("batch_wait_us", int),
             "--max-queue": ("max_queue", int), "--host": ("host", str),
             "--run-dir": ("run_dir", str),
             "--manifest": ("manifest_path", str),
             "--device": ("device", str)}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--stdin":
            opts["stdin"] = True
        elif a == "--model":
            i += 1
            name, sep, path = argv[i].partition("=")
            if not sep:
                raise ValueError("--model takes name=path")
            opts["models"][name] = path
        elif a == "--deliver":
            i += 1
            name, sep, watch = argv[i].partition("=")
            if not sep:
                raise ValueError("--deliver takes name=watch_dir")
            opts["deliver"][name] = watch
        elif a in flags:
            key, conv = flags[a]
            i += 1
            opts[key] = conv(argv[i])
        else:
            raise ValueError(f"unknown serve option: {a!r}")
        i += 1
    if opts["port"] is None and not opts["stdin"]:
        raise ValueError("serve needs --port N or --stdin")
    return opts


def serve_main(argv: List[str], stdin=None, stdout=None) -> int:
    """``python -m xgboost_tpu_torch serve`` entry. ``--stdin`` serves the
    line protocol over stdio; ``--port N`` serves it over TCP with a
    thread per connection, so concurrent client connections coalesce in
    the micro-batcher. The JAX package's options, plus ``--device`` (the
    card unless it says ``cpu``). ``stdin``/``stdout`` overrides serve
    in-process callers."""
    try:
        opts = _parse_serve_args(argv)
    except (ValueError, IndexError) as e:
        print(f"serve: {e}", file=sys.stderr)
        print("usage: python -m xgboost_tpu_torch serve (--port N | --stdin) "
              "[--model name=path ...] [--deliver name=watch_dir ...] "
              "[--arena-mb M] [--batch-wait-us U] "
              "[--max-queue Q] [--host H] [--run-dir D] [--manifest F] "
              "[--device cpu|cuda]",
              file=sys.stderr)
        return 1
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    server = ModelServer(
        opts["models"], arena_mb=opts.get("arena_mb"),
        max_queue=opts.get("max_queue"),
        batch_wait_us=opts.get("batch_wait_us"),
        run_dir=opts.get("run_dir"),
        manifest_path=opts.get("manifest_path"),
        device=opts.get("device"))
    for name, watch in opts["deliver"].items():
        server.deliver(name, watch)

    def respond(obj: Dict[str, Any], fh) -> None:
        fh.write(json.dumps(obj) + "\n")
        fh.flush()

    if opts["stdin"]:
        stop = {"flag": False}

        def shutdown() -> None:
            stop["flag"] = True

        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError as e:
                respond({"error": f"bad json: {e}"}, stdout)
                continue
            respond(_handle(server, msg, shutdown), stdout)
            if stop["flag"]:
                break
        server.close()
        return 0

    # in-flight protocol bookkeeping: the SIGTERM drain barrier must not
    # exit the process while a handler thread still owes a response to a
    # request it already read off its socket ("kill -TERM mid-traffic
    # loses zero admitted requests")
    inflight = {"n": 0}
    inflight_cv = threading.Condition()

    class Handler(socketserver.StreamRequestHandler):
        def handle(self) -> None:
            for raw in self.rfile:
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    continue
                with inflight_cv:
                    inflight["n"] += 1
                try:
                    try:
                        msg = json.loads(line)
                    except ValueError as e:
                        out = {"error": f"bad json: {e}"}
                    else:
                        out = _handle(server, msg, shutdown)
                    try:
                        self.wfile.write(
                            (json.dumps(out) + "\n").encode())
                        self.wfile.flush()
                    except OSError:
                        return  # client went away mid-response
                finally:
                    with inflight_cv:
                        inflight["n"] -= 1
                        inflight_cv.notify_all()

    class Srv(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    tcp = Srv((opts["host"], opts["port"]), Handler)

    def shutdown() -> None:
        threading.Thread(target=tcp.shutdown, daemon=True).start()

    # crash-only SIGTERM: stop admission, stop accepting, let the drain
    # below flush the batcher within XGBTPU_DRAIN_DEADLINE_S, black-box
    # dump, exit 0. Installable only
    # from the main thread; embedded/test callers keep their own handling.
    prev_term = None
    try:
        def _sigterm(signum, frame):
            server.begin_drain()
            shutdown()

        prev_term = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread

    if server.device.type == "cuda":
        # a server restored from a manifest (a fleet replica's respawn)
        # faults its models in at their first request: kernel B's library
        # (built at first use) loads here, before READY, not on that
        # request
        from .. import _build

        _build.library("predict_walk")
    host, port = tcp.server_address[:2]
    print(f"READY serving on {host}:{port} "
          f"(models: {', '.join(sorted(opts['models'])) or 'none'} "
          f"pid={os.getpid()})", file=stdout, flush=True)
    try:
        tcp.serve_forever(poll_interval=0.1)
    except KeyboardInterrupt:
        pass
    finally:
        tcp.server_close()
        # drain barrier: every request a handler thread already read gets
        # its response before the process exits (new arrivals shed with
        # reason "draining" once begin_drain ran, so this converges)
        try:
            deadline_s = float(
                os.environ.get("XGBTPU_DRAIN_DEADLINE_S", "60") or 60)
        except ValueError:
            deadline_s = 60.0
        with inflight_cv:
            inflight_cv.wait_for(lambda: inflight["n"] == 0,
                                 timeout=deadline_s)
        server.close()
        if prev_term is not None:
            try:
                signal.signal(signal.SIGTERM, prev_term)
            except ValueError:
                pass
    return 0
