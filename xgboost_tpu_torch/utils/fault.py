"""Scripted fault injection for recovery testing (the port of the JAX
package's ``utils/fault.py``).

Analog of rabit's mock engine (reference ``rabit/src/allreduce_mock.h:20-50``,
built with ``RABIT_MOCK``): the mock kills a worker when a scripted
``(rank, version, seqno, ntrial)`` tuple matches the current collective
call, and the fault-tolerance tests assert that training recovers from the
last checkpoint. Here the interception points are the host-side boundaries
of each round: ``version`` is the boosting round (rabit's model version),
``seqno`` counts the injection sites hit within the round (rabit's
collective sequence number), and ``ntrial`` is how many times the fault
fires before the trigger is spent. The sites are the learner's
``gradient``, ``grow`` and ``eval`` boundaries.

Usage::

    with fault_injection({(5, 1): 2}):          # version 5, seqno 1, twice
        for attempt in range(max_restarts):
            try:
                bst = train(..., xgb_model=last_checkpoint)
                break
            except InjectedFault:
                continue                         # restart from checkpoint
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Tuple

__all__ = ["InjectedFault", "fault_injection", "inject", "begin_version"]

_state = threading.local()


class InjectedFault(RuntimeError):
    """The scripted fault: the mock engine's ``exit(-2)`` at a matching
    (version, seqno), but recoverable in-process so tests can exercise the
    restart loop."""

    def __init__(self, site: str, version: int, seqno: int, trial: int):
        super().__init__(
            f"injected fault at site={site!r} version={version} "
            f"seqno={seqno} (trial {trial})"
        )
        self.site = site
        self.version = version
        self.seqno = seqno
        self.trial = trial


class _FaultSpec:
    def __init__(self, triggers: Dict[Tuple[int, int], int]):
        # {(version, seqno): remaining_trials}
        self.triggers = dict(triggers)
        self.version = -1
        self.seqno = 0
        self.fired = []  # [(site, version, seqno)] audit log


@contextlib.contextmanager
def fault_injection(triggers: Dict[Tuple[int, int], int]) -> Iterator[_FaultSpec]:
    """Arm scripted faults: ``{(version, seqno): ntrial}``. The spec object
    is yielded so tests can inspect ``spec.fired``."""
    prev = getattr(_state, "spec", None)
    spec = _FaultSpec(triggers)
    _state.spec = spec
    try:
        yield spec
    finally:
        _state.spec = prev


def begin_version(version: int) -> None:
    """Round boundary: resets the seqno counter (rabit's version bump at
    CheckPoint, ``allreduce_base.h:155``). Called by ``Booster.update``."""
    spec = getattr(_state, "spec", None)
    if spec is not None:
        spec.version = version
        spec.seqno = 0


def inject(site: str) -> None:
    """Injection site: no-op unless a spec is armed and the current
    (version, seqno) has remaining trials. Sites are the per-round host
    boundaries (gradient/grow/eval), the places the reference mock
    intercepts collectives. They double as chaos sites of the same names,
    so ``XGBTPU_CHAOS="grow:transient:3"`` fails a round's dispatch
    without a fault spec."""
    from ..resilience import chaos

    chaos.hit(site)
    spec = getattr(_state, "spec", None)
    if spec is None:
        return
    key = (spec.version, spec.seqno)
    spec.seqno += 1
    remaining = spec.triggers.get(key, 0)
    if remaining > 0:
        spec.triggers[key] = remaining - 1
        trial = remaining
        spec.fired.append((site, key[0], key[1]))
        raise InjectedFault(site, key[0], key[1], trial)
