"""Failure classification and bounded retry with backoff and deadlines
(the port of the JAX package's ``resilience/policy.py``).

Every fallible path of the package classifies its failures the same way:

- ``TRANSIENT``: worth retrying in place (an interrupted read, a busy
  peer, injected chaos). The default for anything unrecognised: a
  misclassified transient costs one wasted retry.
- ``RESOURCE``: the attempt was too big for the machine ("CUDA out of
  memory", host ``MemoryError``). Retrying the same shape is futile.
- ``PERMANENT``: this configuration can never work on this runtime
  (``NotImplementedError``; on the card, a sticky CUDA context error, such
  as an illegal memory access or an unspecified launch failure, a missing
  kernel image, or a failed ``nvcc`` build of the kernels).

The JAX package's signature tables are kept as they are, so the same
exception gets the same kind in both packages; the card's own signatures
stand beside them.

``RetryPolicy`` is the one retry loop of the package: bounded attempts,
exponential backoff with deterministic jitter (a crc32 of site, attempt
and seed: the same schedule as the JAX package's for the same site and
seed), an optional wall-clock deadline, and per-site budgets from
``XGBTPU_RETRY`` (a bare int, or ``site=N,*=M``). Every failure counts in
``faults_total{site,kind}`` and every retry in ``retries_total{site}``.
"""

from __future__ import annotations

import os
import time
import zlib
from typing import Callable, Optional, Sequence, Tuple

__all__ = [
    "TRANSIENT", "RESOURCE", "PERMANENT", "KINDS",
    "classify", "record_failure", "retry_budget", "RetryPolicy",
    "is_worker_loss", "should_reroute",
]

TRANSIENT = "transient"
RESOURCE = "resource"
PERMANENT = "permanent"
KINDS = (TRANSIENT, RESOURCE, PERMANENT)

_ENV_RETRY = "XGBTPU_RETRY"

# the JAX package's compiler-layer signatures, checked before the resource
# ones ("vmem ... exhausted" is a permanent reject there)
_PERMANENT_TYPES = ("NotImplementedError", "MosaicError")
_PERMANENT_SUBSTRINGS = ("vmem", "mosaic")
# the card's: errors that poison the CUDA context for the life of the
# process, and a kernel build that failed (``_build.py``)
_CUDA_PERMANENT_SUBSTRINGS = (
    "illegal memory access", "unspecified launch failure",
    "no kernel image", "cuda kernel build failed",
    "the cuda kernels cannot be built",
)

# allocator-layer signatures ("CUDA out of memory" reads through
# "out of memory")
_RESOURCE_SUBSTRINGS = (
    "resource_exhausted", "resource exhausted", "out of memory", "oom",
    "bytes_limit", "failed to allocate", "allocation failure",
)

# peer-death signatures: a collective that broke because the far end went
# away. Retrying in place is futile and unsafe (a one-sided retry desyncs
# the ranks), so the elastic layer resizes the world instead.
_WORKER_LOSS_SUBSTRINGS = (
    "connection closed by peer", "connection reset", "connection refused",
    "broken pipe", "socket closed", "peer closed",
    # specific gloo op failures only: a bare "gloo" would classify setup
    # errors ("gloo transport is not available") as deaths
    "gloo all-reduce failed", "gloo allgather failed",
    "gloo all-gather failed", "gloo broadcast failed", "gloo reduce failed",
    "heartbeat timeout", "task has failed", "worker_lost",
)


def is_worker_loss(exc: BaseException) -> bool:
    """Whether ``exc``'s signature reads as a dead communication peer.
    Chaos faults at the ``worker_kill`` / ``heartbeat_drop`` sites count
    as peer loss (they script exactly that failure)."""
    site = getattr(exc, "site", None)
    if site in ("worker_kill", "heartbeat_drop"):
        return True
    msg = str(exc).lower()
    return any(t in msg for t in _WORKER_LOSS_SUBSTRINGS)


def should_reroute(exc: BaseException) -> bool:
    """The serving fleet's verdict on a request that failed in transit to
    a replica (``serving/fleet/router.py``): True when the failure reads
    as a lost or draining peer, a bare connection exception (reset,
    refused, broken pipe, EOF mid-response), a socket timeout, or any
    :func:`is_worker_loss` signature. The router then retries the request
    once on a healthy replica: a predict is idempotent, so a re-route can
    duplicate work but never corrupt an answer. A failure the replica
    itself reported (a typed ``RequestError``, a shed) rides the response
    line and is never re-routed: the replica is alive and classified it."""
    if isinstance(exc, (ConnectionError, EOFError, TimeoutError)):
        return True
    return is_worker_loss(exc)


def classify(exc: BaseException) -> str:
    """Map an exception to a failure kind. Chaos faults carry their
    scripted kind (``chaos.ChaosError``); everything else is recognised by
    type name or message signature, with TRANSIENT as the default (a
    ``RuntimeError`` from torch wraps transient failures as well as
    permanent ones, so the type alone condemns nothing)."""
    scripted = getattr(exc, "chaos_kind", None)
    if scripted in KINDS:
        return scripted
    if isinstance(exc, MemoryError):
        return RESOURCE
    name = type(exc).__name__
    msg = str(exc).lower()
    if name in _PERMANENT_TYPES or any(
            t in msg for t in _PERMANENT_SUBSTRINGS
            + _CUDA_PERMANENT_SUBSTRINGS):
        return PERMANENT
    if any(t in msg for t in _RESOURCE_SUBSTRINGS):
        return RESOURCE
    return TRANSIENT


def record_failure(site: str, exc: Optional[BaseException] = None,
                   kind: Optional[str] = None) -> str:
    """Classify (unless ``kind`` is given) and account one failure at
    ``site``: ``faults_total{site,kind}`` and an instant on the active
    trace. Returns the kind."""
    if kind is None:
        kind = classify(exc) if exc is not None else TRANSIENT
    from ..observability import trace
    from ..observability.metrics import REGISTRY

    REGISTRY.counter(
        "faults_total", "Failures observed at resilience sites by kind",
    ).labels(site=site, kind=kind).inc()
    trace.instant("fault", site=site, kind=kind,
                  error=type(exc).__name__ if exc is not None else "")
    return kind


def retry_budget(site: str) -> Optional[int]:
    """Retry count for ``site`` per ``XGBTPU_RETRY``, or None when the
    variable is unset or names neither the site nor ``*``. Grammar: a bare
    int, or ``site=N,*=M``; a malformed entry is skipped."""
    raw = os.environ.get(_ENV_RETRY)
    if not raw:
        return None
    default: Optional[int] = None
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
            iv = int(v)
        except ValueError:
            continue  # a malformed variable must never break training
        if k == site:
            return iv
        if k == "*":
            default = iv
    return default


def _jitter(site: str, attempt: int, seed: int) -> float:
    """Deterministic jitter factor in [0.5, 1.0), hashed from (site,
    attempt, seed): processes with different seeds spread their retries,
    a rerun repeats its schedule exactly."""
    h = zlib.crc32(f"{site}:{attempt}:{seed}".encode()) & 0xFFFFFFFF
    return 0.5 + (h / 2**32) * 0.5


class RetryPolicy:
    """Bounded retry for one site.

    ``retries`` is the number of retries after the first attempt;
    ``XGBTPU_RETRY`` overrides it when it names the site (or ``*``). Only
    failures whose kind is in ``retry_kinds`` are retried (TRANSIENT by
    default), and with ``retry_types`` only those exception types.
    ``deadline`` bounds the total wall clock, backoff sleeps included.
    """

    def __init__(self, site: str, retries: int = 0, *,
                 backoff_base: float = 0.05, backoff_cap: float = 2.0,
                 deadline: Optional[float] = None, seed: int = 0,
                 retry_kinds: Sequence[str] = (TRANSIENT,),
                 retry_types: Optional[Tuple[type, ...]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.site = site
        self.retries = retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.deadline = deadline
        self.seed = seed
        self.retry_kinds = tuple(retry_kinds)
        self.retry_types = retry_types
        self._sleep = sleep

    def attempts(self) -> int:
        env = retry_budget(self.site)
        n = self.retries if env is None else env
        return 1 + max(0, int(n))

    def backoff(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based): exponential from
        ``backoff_base``, capped, times the deterministic jitter."""
        raw = min(self.backoff_base * (2 ** (attempt - 1)), self.backoff_cap)
        return raw * _jitter(self.site, attempt, self.seed)

    def run(self, fn: Callable, *args, **kwargs):
        """Call ``fn`` under the policy. A kind or type that is not
        retried, an exhausted budget or a blown deadline re-raises the
        original exception."""
        from ..observability.metrics import REGISTRY

        attempts = self.attempts()
        t0 = time.monotonic()
        for attempt in range(1, attempts + 1):
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                kind = record_failure(self.site, e)
                if (self.retry_types is not None
                        and not isinstance(e, self.retry_types)) \
                        or kind not in self.retry_kinds \
                        or attempt >= attempts:
                    raise
                delay = self.backoff(attempt)
                if self.deadline is not None and (
                        time.monotonic() - t0 + delay) > self.deadline:
                    raise
                REGISTRY.counter(
                    "retries_total", "Retry attempts issued by RetryPolicy",
                ).labels(site=self.site).inc()
                self._sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover

