"""Multi-model tenancy: a forest-snapshot arena with an LRU memory budget,
plus the request-side half, weighted-fair queuing across request tenants
(the port of the JAX package's ``serving/tenancy.py``).

- models are resident by ``name@version``; the **serving pointer** per
  name is the live version (hot swap flips it atomically: ``swap.py``);
- every resident entry is charged its footprint against an arena budget
  (``XGBTPU_SERVING_ARENA_MB``, default 512): the bytes the stacked forest
  holds on the server's device, kernel B's packed node records
  (``StackedForest.nodes``) and unit tree weights included, plus the raw
  model JSON. Loading past the budget evicts least-recently-*used*
  entries, stale versions left behind by swaps included, until the new
  model fits;
- an evicted model is not gone: its **source** (raw model bytes, a model
  file, or a checksummed checkpoint file or directory) is retained, so the
  next request faults it back in (a registry *miss*) instead of erroring;
  ``hits + misses == get() calls``.

Models load onto the registry's device (the server's: the card unless the
caller passes ``device="cpu"``).

The second kind of tenant is the *caller*: under contention a hot tenant
flooding the micro-batcher queue must not starve the others.

- :class:`TenantFairQueue`: the micro-batcher's request queue, per-tenant
  lanes dequeued by start-time fair queuing (virtual time advances by
  ``rows / weight`` per dequeue, weights from ``XGBTPU_TENANT_WEIGHTS``,
  default equal).
- :func:`tenant_weights` / :func:`tenant_quota`: the env grammars
  (``name=N,*=M``, the shape of ``XGBTPU_RETRY``). Quotas bound each
  tenant's *queue occupancy* at admission (``admission.py`` sheds with
  reason ``tenant_quota``).

Registry metrics: ``serving_arena_bytes`` / ``serving_models_resident``
gauges, ``serving_model_loads_total{model=}``,
``serving_model_evictions_total``, ``serving_model_hits_total`` /
``serving_model_misses_total``; per-tenant
``serving_tenant_dequeued_rows_total{tenant=}``.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .._device import resolve_device
from ..observability.metrics import REGISTRY

__all__ = ["ModelEntry", "ModelRegistry", "resolve_source", "load_booster",
           "TenantFairQueue", "tenant_weights", "tenant_quotas",
           "tenant_quota", "QUEUE_STOP", "OVERFLOW_TENANT",
           "SHADOW_TENANT"]

_ENV_WEIGHTS = "XGBTPU_TENANT_WEIGHTS"
_ENV_QUOTA = "XGBTPU_TENANT_QUOTA"
_ENV_TENANT_MAX = "XGBTPU_TENANT_MAX"

#: the shared lane/label every tenant past the distinct-tenant cap maps
#: to — wire-supplied tenant names must not grow per-tenant server state
#: (metric children, ledger caches, fair-queue lanes) without bound
OVERFLOW_TENANT = "overflow"

#: the tenant lane shadow-canary duplicates ride (serving/delivery.py).
#: The batcher recognizes it to keep shadow traffic OUT of the live
#: fault plane: an all-shadow dispatch group feeds neither the model's
#: NAME-keyed breaker nor the payload quarantine — a bad candidate must
#: fail its canary, never shed live traffic.
SHADOW_TENANT = "_canary"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# request tenants: weights, quotas, the weighted-fair queue
# ---------------------------------------------------------------------------


def _parse_tenant_map(raw: Optional[str], conv) -> Dict[str, Any]:
    """``name=N,*=M`` (or a bare number meaning ``*=N``) -> dict. The
    shared grammar of ``XGBTPU_TENANT_WEIGHTS`` / ``XGBTPU_TENANT_QUOTA``
    (mirrors ``XGBTPU_RETRY``); malformed parts are skipped — a bad env
    must never take the server down."""
    out: Dict[str, Any] = {}
    if not raw:
        return out
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, _, v = part.partition("=")
            k, v = k.strip(), v.strip()
        else:
            k, v = "*", part
        try:
            out[k] = conv(v)
        except ValueError:
            continue
    return out


def tenant_weights(env: Optional[str] = None) -> Dict[str, float]:
    """Per-tenant scheduling weights (``XGBTPU_TENANT_WEIGHTS``). Missing
    tenants take the ``*`` entry, default 1.0 — equal shares."""
    raw = env if env is not None else os.environ.get(_ENV_WEIGHTS)
    return {k: max(v, 1e-6)
            for k, v in _parse_tenant_map(raw, float).items() if v > 0}


def tenant_quotas(env: Optional[str] = None) -> Dict[str, int]:
    """The parsed ``XGBTPU_TENANT_QUOTA`` table — parsed ONCE at
    controller construction (the admit path runs per request; same
    read-at-construction contract as every other serving knob)."""
    raw = env if env is not None else os.environ.get(_ENV_QUOTA)
    return {k: max(1, int(v))
            for k, v in _parse_tenant_map(raw, int).items()}


def tenant_quota(tenant: str, env: Optional[str] = None) -> Optional[int]:
    """Max queued requests for ``tenant`` (``XGBTPU_TENANT_QUOTA``), or
    None = unbounded (only the global queue bound applies)."""
    table = tenant_quotas(env)
    return table.get(tenant, table.get("*"))


#: returned by :meth:`TenantFairQueue.get` once the queue is stopped AND
#: drained — the batcher worker's exit marker (never before the last
#: queued request, so ``close(drain=True)`` keeps serving the backlog)
QUEUE_STOP = object()


class TenantFairQueue:
    """Weighted-fair request queue: per-tenant FIFO lanes, dequeued in
    start-time-fair-queuing order.

    Every item enqueues with a *virtual finish tag*
    ``max(vtime, tenant's last tag) + cost / weight`` (cost = request
    rows: the resource a dispatch actually spends); :meth:`get` always
    returns the item with the smallest head tag, and advances the queue's
    virtual time to it. Consequences, both pinned by tests:

    - a backlogged tenant's lane drains at its weight share of dequeued
      rows, independent of how many requests it stuffed into the queue;
    - a tenant with a shallow lane (the "light" tenant under a hot-tenant
      flood) enqueues near the current virtual time and is dequeued
      within ~one weighted round, so its queue wait is bounded by the
      *active tenant count*, not the hot tenant's backlog.

    FIFO order inside a lane is preserved (tags are monotonic per
    tenant). With a single tenant this degrades to the plain FIFO queue
    it replaced. Thread-safe; ``maxsize`` is advisory only (admission
    owns the bound)."""

    def __init__(self, weights: Optional[Dict[str, float]] = None) -> None:
        self._cv = threading.Condition()
        self._lanes: "Dict[str, deque]" = {}  # tenant -> deque[(tag, item)]
        self._weights = tenant_weights() if weights is None \
            else {k: max(float(v), 1e-6) for k, v in weights.items()}
        self._last_tag: Dict[str, float] = {}
        self._vtime = 0.0
        self._size = 0
        self._stopped = False

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, self._weights.get("*", 1.0))

    # ------------------------------------------------------------------
    def put(self, item: Any, tenant: str = "", cost: float = 1.0) -> None:
        with self._cv:
            if self._stopped:
                raise RuntimeError("queue is stopped")
            tag = max(self._vtime, self._last_tag.get(tenant, 0.0)) \
                + max(cost, 1e-9) / self.weight(tenant)
            self._last_tag[tenant] = tag
            self._lanes.setdefault(tenant, deque()).append((tag, item))
            self._size += 1
            self._cv.notify()

    def get(self, timeout: Optional[float] = None) -> Any:
        """Next item in weighted-fair order. Blocks up to ``timeout``
        (None = forever); raises ``queue.Empty`` on timeout, returns
        :data:`QUEUE_STOP` once stopped and drained."""
        import queue as _queue

        with self._cv:
            if not self._cv.wait_for(
                    lambda: self._size > 0 or self._stopped, timeout):
                raise _queue.Empty
            if self._size == 0:
                return QUEUE_STOP
            tenant = min(self._lanes, key=lambda t: self._lanes[t][0][0])
            tag, item = self._lanes[tenant].popleft()
            if not self._lanes[tenant]:
                del self._lanes[tenant]
            self._vtime = max(self._vtime, tag)
            self._size -= 1
            return item

    def get_nowait(self) -> Any:
        return self.get(timeout=0)

    def stop(self) -> None:
        """No further :meth:`put`; :meth:`get` serves the backlog then
        returns :data:`QUEUE_STOP` (the positional-sentinel analog for a
        queue whose order is no longer FIFO)."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    # ------------------------------------------------------------------
    def qsize(self) -> int:
        with self._cv:
            return self._size

    def depth(self, tenant: str) -> int:
        """Queued requests for one tenant — the admission layer's quota
        input."""
        with self._cv:
            lane = self._lanes.get(tenant)
            return len(lane) if lane else 0


# ---------------------------------------------------------------------------
# model sources: everything a model can be (re)loaded from
# ---------------------------------------------------------------------------


def resolve_source(source: Any) -> Tuple[str, Any]:
    """Normalize a user-supplied model source into a (kind, payload) spec
    that survives eviction: a live ``Booster`` becomes its raw JSON bytes,
    paths stay paths. Kinds: ``raw`` (model JSON bytes), ``file`` (model
    JSON path), ``ckpt`` (one checkpoint file), ``ckpt_dir`` (checkpoint
    directory: the newest *verified* snapshot wins)."""
    if hasattr(source, "save_raw"):  # live Booster
        return ("raw", source.save_raw())
    if isinstance(source, (bytes, bytearray)):
        return ("raw", bytes(source))
    if isinstance(source, (str, os.PathLike)):
        path = os.fspath(source)
        if os.path.isdir(path):
            return ("ckpt_dir", path)
        if path.endswith(".ckpt"):
            return ("ckpt", path)
        return ("file", path)
    raise TypeError(f"unsupported model source: {type(source).__name__}")


def load_booster(spec: Tuple[str, Any], device=None):
    """A fresh ``Booster`` on ``device`` (None: the card) from a resolved
    source spec. Checkpoint kinds
    go through the resilience layer's verified readers, so a truncated or
    bit-flipped snapshot is rejected (or fallen through) instead of served.

    Every build runs under the ``serving_model_load`` retry/chaos site:
    a transient read hiccup gets one bounded retry (``XGBTPU_RETRY``
    site ``serving_model_load``), anything persistent is classified and
    re-raised — an LRU fault-back-in that fails permanently surfaces to
    the caller instead of crash-looping the arena."""
    from ..resilience import chaos, policy

    def _build():
        chaos.hit("serving_model_load")
        return _load_booster_from(spec, device)

    try:
        return policy.RetryPolicy("serving_model_load", retries=1).run(
            _build)
    except Exception as e:
        # RetryPolicy already recorded faults_total{site,kind}; add only
        # the serving-plane slice here (no double count)
        REGISTRY.counter(
            "serving_faults_total",
            "Failures observed on the serving plane, by site and kind",
        ).labels(site="serving_model_load", kind=policy.classify(e)).inc()
        raise


def _load_booster_from(spec: Tuple[str, Any], device=None):
    from ..learner import Booster
    from ..resilience import checkpoint

    kind, payload = spec
    if kind == "raw":
        return Booster(model_file=bytes(payload), device=device)
    if kind == "file":
        return Booster(model_file=payload, device=device)
    if kind == "ckpt":
        got = checkpoint.read_checkpoint(payload)
        if got is None:
            raise ValueError(f"checkpoint {payload!r} failed verification")
        return Booster(model_file=got[0], device=device)
    if kind == "ckpt_dir":
        got = checkpoint.load_latest(payload)
        if got is None:
            raise ValueError(
                f"no verified checkpoint in {payload!r} "
                "(python -m xgboost_tpu_torch checkpoint-inspect)")
        return Booster(model_file=got[0], device=device)
    raise ValueError(f"unknown source kind: {kind!r}")


#: the StackedForest tensors a snapshot holds on its device
_FOREST_TENSORS = ("left", "right", "feature", "cond", "default_left",
                   "tree_group", "nodes", "unit_weights", "split_type",
                   "cat_bits")


def _forest_footprint_bytes(booster) -> int:
    """Resident footprint: the bytes of the stacked forest's tensors on
    their device (kernel B's packed node records included; read from
    shapes, no device-to-host copy) and of the tree weights. The
    full-model snapshot is built here if absent, which is the warm-up a
    fresh model wants before serving. A linear booster holds no forest."""
    booster._configure()
    if getattr(booster._gbm, "model", None) is None:
        return 0
    forest, tw = booster._forest_snapshot()
    tensors = [getattr(forest, f) for f in _FOREST_TENSORS] + [tw]
    return sum(int(t.numel()) * t.element_size() for t in tensors
               if t is not None)


# ---------------------------------------------------------------------------


class ModelEntry:
    """One resident ``name@version``: the Booster, its footprint charge,
    and an in-flight count so hot swap can drain requests pinned to the
    old snapshot before releasing it."""

    def __init__(self, name: str, version: int, booster, spec,
                 nbytes: int) -> None:
        self.name = name
        self.version = version
        self.label = f"{name}@v{version}"
        self.booster = booster
        self.spec = spec
        self.nbytes = nbytes
        #: eviction shield: a pinned entry is skipped by the
        #: LRU budget pass — the delivery controller pins the canary AND
        #: the incumbent for the whole canary window, so a hot third
        #: tenant cannot evict the incumbent mid-canary and turn a
        #: rollback into a cold fault-in. Set via ModelRegistry.pin().
        self.pinned = False
        self._cv = threading.Condition()
        self._inflight = 0

    # -- in-flight pinning ------------------------------------------------
    def acquire(self) -> "ModelEntry":
        with self._cv:
            self._inflight += 1
        return self

    def release(self) -> None:
        with self._cv:
            self._inflight = max(0, self._inflight - 1)
            self._cv.notify_all()

    @property
    def inflight(self) -> int:
        with self._cv:
            return self._inflight

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until no request holds this entry (True) or the timeout
        expires (False). The swap path calls this on the *old* snapshot
        after flipping the pointer: new traffic can no longer acquire it,
        so the count only falls."""
        with self._cv:
            return self._cv.wait_for(lambda: self._inflight == 0, timeout)

    # -- the dispatch the batcher runs ------------------------------------
    def predict(self, X, *, predict_type: str = "value",
                iteration_range=None, missing=np.nan,
                base_margin=None) -> np.ndarray:
        """One coalesced dispatch through the serving fast path
        (``Booster.inplace_predict``: kernel B on the card), scoped to this
        tenant (per-model ``predict_latency_seconds`` labels)."""
        from ..predictor.serving import serving_context

        with serving_context(model=self.label):
            return self.booster.inplace_predict(
                X, predict_type=predict_type,
                iteration_range=iteration_range, missing=missing,
                base_margin=base_margin)


class ModelRegistry:
    """The arena: name@version -> :class:`ModelEntry`, LRU-ordered, under
    a byte budget. All mutation is lock-guarded; entries a swap just
    replaced stay alive (and addressable by explicit version) until
    evicted or released."""

    def __init__(self, arena_mb: Optional[float] = None,
                 on_event=None, device=None) -> None:
        #: where every model of the arena loads (None: the card; raises
        #: where there is none)
        self.device = resolve_device(device)
        if arena_mb is None:
            arena_mb = _env_float("XGBTPU_SERVING_ARENA_MB", 512.0)
        self.budget_bytes = max(1, int(arena_mb * 1024 * 1024))
        # serving flight-recorder hook (``obs.ServingRecorder.event``):
        # evictions and fault-back-ins are timeline events an operator
        # reading serve-report needs next to the latency cliff they cause
        self._on_event = on_event or (lambda name, **args: None)
        self._lock = threading.RLock()
        self._entries: "OrderedDict[Tuple[str, int], ModelEntry]" = \
            OrderedDict()
        self._live: Dict[str, int] = {}  # serving pointer per name
        self._sources: Dict[Tuple[str, int], Tuple[str, Any]] = {}
        self._next_version: Dict[str, int] = {}
        self._g_bytes = REGISTRY.gauge(
            "serving_arena_bytes",
            "Resident bytes of stacked-forest snapshots in the model arena")
        self._g_models = REGISTRY.gauge(
            "serving_models_resident", "Models resident in the arena")
        self._hits = REGISTRY.counter(
            "serving_model_hits_total",
            "Model lookups served by a resident arena entry")
        self._misses = REGISTRY.counter(
            "serving_model_misses_total",
            "Model lookups that faulted the model back in from its source")
        self._evictions = REGISTRY.counter(
            "serving_model_evictions_total",
            "Arena entries evicted by the LRU memory budget")
        self._g_bytes.set(0)
        self._g_models.set(0)

    # ------------------------------------------------------------------
    def load(self, name: str, source: Any, *,
             version: Optional[int] = None, make_live: bool = True,
             booster=None) -> ModelEntry:
        """Load (or re-register) a model version. ``source`` is anything
        :func:`resolve_source` accepts; ``booster`` short-circuits the
        load with an already-built instance (the in-process path — the
        resolved source is still retained for fault-back-in). Returns the
        resident entry; with ``make_live`` the serving pointer flips to it
        (the caller sequences draining — see ``swap.py``)."""
        spec = resolve_source(source)
        if booster is not None and booster.device != self.device:
            booster = None  # a live Booster elsewhere: load its bytes here
        if booster is None:
            booster = load_booster(spec, self.device)
        with self._lock:
            if version is None:
                version = self._next_version.get(name, 0) + 1
            self._next_version[name] = max(
                version, self._next_version.get(name, 0))
        # footprint (builds the forest snapshot == warms the model) runs
        # outside the lock: stacking a big forest must not stall lookups
        nbytes = _forest_footprint_bytes(booster) + _spec_bytes(spec)
        entry = ModelEntry(name, version, booster, spec, nbytes)
        with self._lock:
            key = (name, version)
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self._sources[key] = spec
            if make_live:
                self._live[name] = version
            REGISTRY.counter(
                "serving_model_loads_total",
                "Models (re)loaded into the arena").labels(
                    model=entry.label).inc()
            evicted = self._evict_to_budget_locked(keep=key)
            self._publish_locked()
        for label in evicted:  # file I/O stays off the registry lock
            self._on_event("model_evict", model=label)
        return entry

    def get(self, name: str, version: Optional[int] = None) -> ModelEntry:
        """The resident entry for ``name`` (live version unless pinned).
        A budget-evicted model faults back in from its retained source —
        counted as a miss; resident lookups are hits."""
        with self._lock:
            v = version if version is not None else self._live.get(name)
            if v is None:
                raise KeyError(f"unknown model: {name!r}")
            key = (name, v)
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self._hits.inc()
                return entry
            spec = self._sources.get(key)
            if spec is None:
                raise KeyError(f"unknown model version: {name!r} v{v}")
            self._misses.inc()
        self._on_event("model_fault_in", model=f"{name}@v{v}")
        # reload outside the lock (may read disk / restack the forest)
        booster = load_booster(spec, self.device)
        nbytes = _forest_footprint_bytes(booster) + _spec_bytes(spec)
        entry = ModelEntry(name, v, booster, spec, nbytes)
        with self._lock:
            raced = self._entries.get(key)
            if raced is not None:  # another thread faulted it in first
                self._entries.move_to_end(key)
                return raced
            self._entries[key] = entry
            evicted = self._evict_to_budget_locked(keep=key)
            self._publish_locked()
        for label in evicted:
            self._on_event("model_evict", model=label)
        return entry

    def register_source(self, name: str, version: int,
                        spec: Tuple[str, Any], *,
                        live: bool = False) -> None:
        """Register a model source WITHOUT loading it — the crash-only
        restart path: a server
        restoring its persisted manifest registers every retained source
        lazily, and the first request for each name faults the booster
        back in exactly like an LRU eviction would."""
        if spec[0] not in ("raw", "file", "ckpt", "ckpt_dir"):
            raise ValueError(f"unknown source kind: {spec[0]!r}")
        with self._lock:
            self._sources[(name, int(version))] = (spec[0], spec[1])
            self._next_version[name] = max(
                int(version), self._next_version.get(name, 0))
            if live:
                self._live[name] = int(version)

    def sources_snapshot(self) -> Dict[Tuple[str, int], Tuple[str, Any]]:
        """Every retained (name, version) -> source spec — the manifest
        writer's input."""
        with self._lock:
            return dict(self._sources)

    def reserve_version(self, name: str, version: int) -> None:
        """Make future auto-assigned versions start beyond ``version``.
        The restart path reserves QUARANTINED version numbers: their
        manifest rows are scrubbed (so ``register_source`` never sees
        them), and without the reservation the next published checkpoint
        would be assigned a quarantined number — unpromotable forever."""
        with self._lock:
            self._next_version[name] = max(
                int(version), self._next_version.get(name, 0))

    def pin(self, name: str, version: int, pinned: bool = True) -> None:
        """Shield (or release) one resident version from LRU eviction.
        The delivery controller pins canary + incumbent for the canary
        window; pinning a non-resident
        version is a no-op — the next fault-in loads it unpinned."""
        with self._lock:
            entry = self._entries.get((name, int(version)))
            if entry is not None:
                entry.pinned = bool(pinned)

    def set_live(self, name: str, version: int) -> ModelEntry:
        """Atomically flip the serving pointer (the entry must exist)."""
        with self._lock:
            if (name, version) not in self._entries \
                    and (name, version) not in self._sources:
                raise KeyError(f"unknown model version: {name!r} v{version}")
            self._live[name] = version
        return self.get(name)

    def live_version(self, name: str) -> Optional[int]:
        with self._lock:
            return self._live.get(name)

    def drop(self, name: str, version: Optional[int] = None) -> None:
        """Forget a model (all versions unless one is pinned): entries,
        sources and the serving pointer."""
        with self._lock:
            keys = [k for k in set(self._entries) | set(self._sources)
                    if k[0] == name and (version is None or k[1] == version)]
            for k in keys:
                self._entries.pop(k, None)
                self._sources.pop(k, None)
            if version is None or self._live.get(name) == version:
                self._live.pop(name, None)
            self._publish_locked()

    # ------------------------------------------------------------------
    def total_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def resident(self) -> List[str]:
        with self._lock:
            return [e.label for e in self._entries.values()]

    def models(self) -> Dict[str, int]:
        """name -> live version (the serving pointers)."""
        with self._lock:
            return dict(self._live)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "resident_bytes": sum(
                    e.nbytes for e in self._entries.values()),
                "resident": [
                    {"model": e.label, "bytes": e.nbytes,
                     "inflight": e.inflight,
                     "live": self._live.get(e.name) == e.version}
                    for e in self._entries.values()
                ],
                "live": {n: f"{n}@v{v}" for n, v in self._live.items()},
            }

    # ------------------------------------------------------------------
    def _evict_to_budget_locked(self, keep: Tuple[str, int]) -> List[str]:
        """Drop least-recently-used entries until under budget. The entry
        being installed is exempt (a model bigger than the whole budget
        still serves — the arena just holds nothing else). In-flight and
        explicitly pinned entries (delivery canaries) are skipped this
        pass: their memory is held by the requests / the canary anyway,
        and dropping the registry's reference would only
        hide the bytes from the gauge. Returns the evicted labels so the
        caller can emit timeline events after releasing the lock."""
        evicted: List[str] = []
        total = sum(e.nbytes for e in self._entries.values())
        if total <= self.budget_bytes:
            return evicted
        for key in list(self._entries):
            if total <= self.budget_bytes:
                break
            if key == keep:
                continue
            entry = self._entries[key]
            if entry.inflight or entry.pinned:
                continue
            del self._entries[key]
            total -= entry.nbytes
            self._evictions.inc()
            evicted.append(entry.label)
        return evicted

    def _publish_locked(self) -> None:
        self._g_bytes.set(sum(e.nbytes for e in self._entries.values()))
        self._g_models.set(len(self._entries))


def _spec_bytes(spec: Tuple[str, Any]) -> int:
    kind, payload = spec
    return len(payload) if kind == "raw" else 0
