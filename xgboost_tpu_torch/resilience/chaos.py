"""Named-site fault injection with seeded deterministic schedules (the port
of the JAX package's ``resilience/chaos.py``; the rabit mock's scripted
worker faults, ``rabit/src/allreduce_mock.h:20-50``, generalised to named
sites).

The sites the port hits:

==================  =====================================================
site                injection point
==================  =====================================================
``pallas``          the kernel-launch site: kernel B's wrapper
                    (``predictor.predict_margin``) at every call, and the
                    hoist plan of ``BinnedMatrix.fused_onehot`` (kernel
                    C's build). The name is the JAX package's, so its
                    schedules parse; there a hit falls back to XLA, here
                    it raises out of ``train`` (no plain-version fallback)
``collective``      every accounted collective (``observability.comms``)
``collective_timeout``  every guarded collective (``collective.guarded``):
                    presents as a transient deadline expiry there
``pager_io``        page reads and writes of the paged matrix
                    (``data/external.py``)
``checkpoint_write``  atomic checkpoint writes (``resilience/checkpoint``)
``gradient``/``grow``/``eval``  the per-round host boundaries
                    (``utils/fault.py`` ``inject``)
``worker_kill``     each round boundary of ``elastic_train``: a hit
                    SIGKILLs the worker
``heartbeat_drop``  each beat of the membership's heartbeat agent (its own
                    copy of this grammar, ``parallel/membership.py``): a
                    hit skips the beat
``serving_dispatch``  each coalesced dispatch of the model server's
                    batcher (``serving/batcher.py``), before the walk
``batcher_wedge``   each batch the batcher's worker runs: a hit parks the
                    worker until its watchdog replaces it
``serving_model_load``, ``serving_swap``, ``delivery_publish``,
``canary_diff``     the model server's loads, hot swaps, delivery
                    publishes and shadow diffs (``serving/``)
==================  =====================================================

``SITES`` also names the JAX package's sites the port has no caller for
(the compile and native sites); a schedule for them parses and never
fires.

Configuration: ``XGBTPU_CHAOS="site:kind:schedule[;site:kind:schedule]"``
or ``configure(...)``:

- ``kind``: ``transient`` | ``resource`` | ``permanent`` (the class of the
  raised ``ChaosError``, read by ``policy.classify``), or one of the
  modes ``crash`` | ``timeout`` | ``corrupt`` (which classify permanent,
  resource and permanent);
- ``schedule``: comma-separated specs over the site's 1-based hit count:
  ``N`` (the Nth hit), ``N-M`` (hits N..M), ``N+`` (from N on), ``%K``
  (every Kth), ``pP@S`` (each hit with probability P, decided by a crc32
  of (site, hit, seed S): the same hits fire in every process and rerun).

Example: ``XGBTPU_CHAOS="pallas:permanent:1;collective:transient:2,5"``.
``chaos.hit(name)`` is one global read when nothing is armed.
"""

from __future__ import annotations

import contextlib
import os
import threading
import zlib
from typing import Dict, Iterator, List, Optional

from . import policy

__all__ = [
    "ChaosError", "ChaosTransient", "ChaosResource", "ChaosPermanent",
    "ChaosCrash", "ChaosTimeout", "ChaosCorrupt",
    "SITES", "MODES", "hit", "configure", "active_plan", "reset",
]

_ENV = "XGBTPU_CHAOS"

#: the JAX package's documented sites (informational: any name works)
SITES = ("compile", "pallas", "collective", "pager_io", "native_load",
         "checkpoint_write", "gradient", "grow", "eval",
         "worker_kill", "heartbeat_drop", "collective_timeout",
         "serving_dispatch", "serving_model_load", "serving_swap",
         "batcher_wedge", "delivery_publish", "canary_diff",
         "native_canary", "native_dispatch")

#: failure modes accepted beside ``policy.KINDS``: how a fault presents
#: (a dead process, a wedged kernel, wrong bytes); in-process sites raise
MODES = ("crash", "timeout", "corrupt")


class ChaosError(RuntimeError):
    """An injected fault. ``chaos_kind`` is read by ``policy.classify``;
    ``chaos_mode`` is set on the mode subclasses."""

    chaos_kind = policy.TRANSIENT
    chaos_mode = ""

    def __init__(self, site: str, hit_index: int):
        super().__init__(
            f"chaos: injected {self.chaos_mode or self.chaos_kind} fault "
            f"at site={site!r} (hit {hit_index})")
        self.site = site
        self.hit_index = hit_index


class ChaosTransient(ChaosError):
    chaos_kind = policy.TRANSIENT


class ChaosResource(ChaosError):
    chaos_kind = policy.RESOURCE


class ChaosPermanent(ChaosError):
    chaos_kind = policy.PERMANENT


class ChaosCrash(ChaosError):
    """A scripted process death; in-process sites raise it (permanent)."""

    chaos_kind = policy.PERMANENT
    chaos_mode = "crash"


class ChaosTimeout(ChaosError):
    """A scripted wedge; in-process sites raise it (resource: the attempt
    consumed its deadline)."""

    chaos_kind = policy.RESOURCE
    chaos_mode = "timeout"


class ChaosCorrupt(ChaosError):
    """Scripted wrong output; in-process sites raise it (permanent)."""

    chaos_kind = policy.PERMANENT
    chaos_mode = "corrupt"


_EXC = {policy.TRANSIENT: ChaosTransient, policy.RESOURCE: ChaosResource,
        policy.PERMANENT: ChaosPermanent, "crash": ChaosCrash,
        "timeout": ChaosTimeout, "corrupt": ChaosCorrupt}


class _Spec:
    """One parsed ``site:kind:schedule`` clause."""

    def __init__(self, site: str, kind: str, sched: str):
        if kind not in policy.KINDS and kind not in MODES:
            raise ValueError(
                f"chaos kind must be one of {policy.KINDS + MODES}, "
                f"got {kind!r}")
        self.site = site
        self.kind = kind
        self.sched = sched
        self._preds = [self._parse_one(tok.strip())
                       for tok in sched.split(",") if tok.strip()]
        if not self._preds:
            raise ValueError(f"empty chaos schedule for site {site!r}")

    def _parse_one(self, tok: str):
        site = self.site
        if tok.startswith("p"):  # pP@SEED, seeded
            prob_s, _, seed_s = tok[1:].partition("@")
            prob = float(prob_s)
            seed = int(seed_s) if seed_s else 0

            def prob_pred(n: int, prob=prob, seed=seed) -> bool:
                h = zlib.crc32(f"{site}:{n}:{seed}".encode()) & 0xFFFFFFFF
                return (h / 2**32) < prob

            return prob_pred
        if tok.startswith("%"):  # every Kth hit
            k = int(tok[1:])
            if k <= 0:
                raise ValueError(f"chaos schedule %K needs K >= 1: {tok!r}")
            return lambda n, k=k: n % k == 0
        if tok.endswith("+"):  # from N on
            lo = int(tok[:-1])
            return lambda n, lo=lo: n >= lo
        if "-" in tok:  # N-M
            lo_s, _, hi_s = tok.partition("-")
            lo, hi = int(lo_s), int(hi_s)
            return lambda n, lo=lo, hi=hi: lo <= n <= hi
        target = int(tok)  # the Nth hit
        return lambda n, target=target: n == target

    def fires(self, n: int) -> bool:
        return any(p(n) for p in self._preds)


class ChaosPlan:
    """An armed set of specs with per-site hit counters (lock-guarded:
    the page prefetcher and the checkpoint writer hit sites from their own
    threads)."""

    def __init__(self, cfg: str):
        self.cfg = cfg
        self.specs: List[_Spec] = []
        for clause in cfg.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            parts = clause.split(":", 2)
            if len(parts) != 3:
                raise ValueError(
                    f"chaos clause must be site:kind:schedule, got "
                    f"{clause!r}")
            self.specs.append(_Spec(*[p.strip() for p in parts]))
        self._sites = {s.site for s in self.specs}
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self.fired: List[tuple] = []  # [(site, hit_index, kind)]

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def check(self, site: str) -> None:
        if site not in self._sites:
            return  # sites without a clause are not even counted
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
            fire = next((s for s in self.specs
                         if s.site == site and s.fires(n)), None)
            if fire is not None:
                self.fired.append((site, n, fire.kind))
        if fire is None:
            return
        from ..observability import trace
        from ..observability.metrics import REGISTRY

        REGISTRY.counter(
            "chaos_injections_total", "Faults injected by site and kind",
        ).labels(site=site, kind=fire.kind).inc()
        trace.instant("chaos_injection", site=site, hit=n, kind=fire.kind)
        raise _EXC[fire.kind](site, n)


_lock = threading.Lock()
_plan: Optional[ChaosPlan] = None  # configure()'s plan
_env_plan: Optional[ChaosPlan] = None  # the parsed variable, by its string


def active_plan() -> Optional[ChaosPlan]:
    """The armed plan: ``configure()``'s, else the parsed ``XGBTPU_CHAOS``
    (parsed again whenever the string changes). None when chaos is off."""
    global _env_plan
    if _plan is not None:
        return _plan
    cfg = os.environ.get(_ENV)
    if not cfg:
        return None
    with _lock:
        if _env_plan is None or _env_plan.cfg != cfg:
            _env_plan = ChaosPlan(cfg)
        return _env_plan


def hit(site: str) -> None:
    """Injection point: a no-op unless a plan is armed."""
    if _plan is None and _ENV not in os.environ:
        return
    plan = active_plan()
    if plan is not None:
        plan.check(site)


@contextlib.contextmanager
def configure(cfg: str) -> Iterator[ChaosPlan]:
    """Arm a plan for the enclosed block; yields it (``plan.fired``,
    ``plan.hits(site)``)."""
    global _plan
    plan = ChaosPlan(cfg)
    with _lock:
        prev, _plan = _plan, plan
    try:
        yield plan
    finally:
        with _lock:
            _plan = prev


def reset() -> None:
    """Drop any armed plan and the parsed variable."""
    global _plan, _env_plan
    with _lock:
        _plan = None
        _env_plan = None
