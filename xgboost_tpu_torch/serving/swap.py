"""Zero-downtime hot model swap: load, warm, flip, drain (the port of the
JAX package's ``serving/swap.py``).

1. **load**: the new version comes from any :func:`tenancy.resolve_source`
   source onto the server's device; checkpoint sources go through the
   checksummed readers, so a torn or bit-flipped file is rejected before
   it ever serves.
2. **warm**: the stacked forest is built at load (footprint accounting)
   and one NaN row is walked through the serving path (:func:`warm_entry`:
   kernel B on the card), so loading kernel B's library and its first
   launch land in the swap, not on the first request. Traffic keeps
   hitting the old version throughout.
3. **flip**: the serving pointer (``registry.set_live``) changes under the
   registry lock: requests admitted after this instant pin the new entry;
   nothing in flight is touched.
4. **drain**: requests already pinned to the old snapshot finish against
   it (``ModelEntry.drain``); only then does the swap return. The old
   version stays resident (addressable by explicit version) until the LRU
   budget reclaims it.

``model_swaps_total{model=}`` counts completed swaps.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np

from ..observability.metrics import REGISTRY
from .tenancy import ModelEntry, ModelRegistry

__all__ = ["hot_swap", "warm_entry", "promote_live"]


def warm_entry(entry: ModelEntry) -> None:
    """Walk one NaN row through the serving path of this entry's model
    (NaN rows take default directions: no data needed): on the card this
    loads kernel B's library (built at first use) and makes its first
    launch, so neither lands on the first request. Failures propagate: a
    model whose walk cannot run must fail the swap, not the first caller.

    The warm predict runs under an UNLABELLED serving context: its
    first-launch latency must not land in the model's
    ``predict_latency_seconds{model=}`` series, which feeds the admission
    p99 estimate and the delivery canary's p99 gate."""
    from ..predictor.serving import serving_context

    F = max(1, entry.booster.num_features())
    with serving_context():
        entry.booster.inplace_predict(
            np.full((1, F), np.nan, np.float32))


def hot_swap(registry: ModelRegistry, name: str, source: Any, *,
             version: Optional[int] = None, booster=None,
             warm: bool = True, drain_timeout_s: float = 60.0,
             on_flip=None, on_event=None) -> ModelEntry:
    """Swap ``name``'s live version for one loaded from ``source``.
    Returns the new live entry after the old snapshot drained (or the
    timeout passed — the old entry is left to drain under its in-flight
    pins either way; memory is only reclaimed once they release).
    ``on_flip`` (used by the server) runs right after the pointer flip,
    before draining; ``on_event(name, **args)`` (the serving flight
    recorder's hook) records the completed swap on the request timeline
    — from here rather than the server, so background ``swap_async``
    flips land on the timeline too.

    Failure containment: the whole sequence runs under the
    ``serving_swap`` chaos/classification site. A swap that fails at any
    stage before the flip leaves the OLD version serving untouched (the
    pointer only moves on success); the failure is classified and
    re-raised to the caller."""
    from ..resilience import chaos

    try:
        chaos.hit("serving_swap")
        return _hot_swap(registry, name, source, version=version,
                         booster=booster, warm=warm,
                         drain_timeout_s=drain_timeout_s,
                         on_flip=on_flip, on_event=on_event)
    except Exception as e:
        from .faults import record_serving_fault

        record_serving_fault("serving_swap", e)
        raise


def _hot_swap(registry: ModelRegistry, name: str, source: Any, *,
              version: Optional[int] = None, booster=None,
              warm: bool = True, drain_timeout_s: float = 60.0,
              on_flip=None, on_event=None) -> ModelEntry:
    old_version = registry.live_version(name)
    entry = registry.load(name, source, version=version, booster=booster,
                          make_live=False)
    if warm:
        warm_entry(entry)
    registry.set_live(name, entry.version)
    if on_flip is not None:
        on_flip(entry)
    if old_version is not None and old_version != entry.version:
        try:
            old = registry.get(name, version=old_version)
        except KeyError:
            old = None
        if old is not None and not old.drain(drain_timeout_s):
            from ..utils import console_logger

            console_logger.warning(
                f"hot swap {entry.label}: old snapshot v{old_version} "
                f"still has {old.inflight} in-flight request(s) after "
                f"{drain_timeout_s}s; leaving it pinned")
    REGISTRY.counter(
        "model_swaps_total",
        "Completed zero-downtime model swaps").labels(
            model=entry.label).inc()
    if on_event is not None:
        on_event("model_swap", model=entry.label,
                 old_version=old_version)
    return entry


def promote_live(registry: ModelRegistry, name: str, version: int, *,
                 warm: bool = True, drain_timeout_s: float = 60.0,
                 on_event=None, event: str = "model_promoted"
                 ) -> ModelEntry:
    """Flip ``name``'s serving pointer to an ALREADY-published resident
    version — the promote/rollback half of the delivery loop
    (``serving/delivery.py``). Same warm → flip → drain sequence as
    :func:`hot_swap`, but against a version the registry already holds
    (published with ``make_live=False``), so nothing is loaded from disk
    on the flip path; a rollback to a pinned incumbent is warm by
    construction. Counts into ``model_swaps_total`` — a promotion IS a
    swap, just one whose load happened at publish time."""
    entry = registry.get(name, version)
    if warm:
        warm_entry(entry)
    old_version = registry.live_version(name)
    registry.set_live(name, entry.version)
    if old_version is not None and old_version != entry.version:
        try:
            old = registry.get(name, version=old_version)
        except KeyError:
            old = None
        if old is not None and not old.drain(drain_timeout_s):
            from ..utils import console_logger

            console_logger.warning(
                f"{event} {entry.label}: old snapshot v{old_version} "
                f"still has {old.inflight} in-flight request(s) after "
                f"{drain_timeout_s}s; leaving it pinned")
    REGISTRY.counter(
        "model_swaps_total",
        "Completed zero-downtime model swaps").labels(
            model=entry.label).inc()
    if on_event is not None:
        on_event(event, model=entry.label, old_version=old_version)
    return entry


class SwapRunner:
    """Background-thread wrapper so a CLI/server can swap mid-traffic
    without stalling its request loop; at most one swap per model at a
    time (a second request for the same name waits its turn).
    ``on_event`` is forwarded to every :func:`hot_swap`."""

    def __init__(self, registry: ModelRegistry, on_event=None) -> None:
        self._registry = registry
        self._on_event = on_event
        self._locks: dict = {}
        self._guard = threading.Lock()

    def _model_lock(self, name: str) -> threading.Lock:
        with self._guard:
            lock = self._locks.get(name)
            if lock is None:
                lock = self._locks[name] = threading.Lock()
            return lock

    def swap(self, name: str, source: Any, **kw) -> ModelEntry:
        with self._model_lock(name):
            kw.setdefault("on_event", self._on_event)
            return hot_swap(self._registry, name, source, **kw)

    def swap_async(self, name: str, source: Any, **kw) -> threading.Thread:
        t = threading.Thread(
            target=self.swap, args=(name, source), kwargs=kw,
            name=f"xgbtpu-swap-{name}", daemon=True)
        t.start()
        return t
