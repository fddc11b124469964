"""The pipelined round loop's bounded in-flight window (the port of the JAX
package's ``pipeline.py``).

CUDA launches are asynchronous: a round's kernels are queued on the
stream and the host returns as soon as it has nothing of the round left
to read. :class:`RoundPipeline` bounds how far the host may run ahead:

- ``admit(round_idx, handles)`` registers a round's completion handles
  without waiting. When more than ``depth`` rounds are in flight, the
  oldest is waited for first, so at most ``depth`` rounds are queued on
  the card behind the host.
- ``drain()`` waits for every admitted round: the sync points are the
  eval / checkpoint / callback boundaries and the end of training.
- a failed round (a chaos fault, an error surfacing at the wait) is
  re-raised with the round that was being waited for attributed: on the
  exception (``.pipeline_round``), as a ``pipeline_fault`` flight event
  and as a ``pipeline_fault`` trace instant.

``XGBTPU_PIPELINE_DEPTH`` bounds the window (default 2; 0 = synchronous,
every round waited for at once; a value that is not an integer gives the
default). The seconds spent waiting go to the flight recorder's ``sync``
stage.

A handle is a ``torch.cuda.Event`` recorded on the stream after the
round's last launch (``completion_probe``). The JAX package's probe is a
small copy of the margin, because its margin buffer is donated into the
next round's program; the port donates no buffer, so an event is enough,
and no handle is ever skipped as donated or deleted. A CPU tensor's
round has finished when its call returns: its probe is None, which
``admit`` ignores.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

__all__ = ["RoundPipeline", "pipeline_depth", "completion_probe"]

_ENV_DEPTH = "XGBTPU_PIPELINE_DEPTH"
_DEFAULT_DEPTH = 2


def pipeline_depth() -> int:
    """The configured in-flight round bound (>= 0)."""
    try:
        return max(0, int(os.environ.get(_ENV_DEPTH, _DEFAULT_DEPTH)))
    except ValueError:
        return _DEFAULT_DEPTH


def completion_probe(t):
    """A handle whose completion implies that the work producing ``t`` has
    finished: a ``torch.cuda.Event`` recorded on the current stream of
    ``t``'s card; None for None or a tensor off the card."""
    if t is None or t.device.type != "cuda":
        return None
    import torch

    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


class RoundPipeline:
    """Bounded in-flight window over asynchronously launched rounds.

    Not thread-safe: owned by one training loop. A handle is anything with
    ``synchronize()`` (a ``torch.cuda.Event``); None is ignored."""

    def __init__(self, depth: Optional[int] = None) -> None:
        self.depth = pipeline_depth() if depth is None else max(0, depth)
        self._inflight: Deque[Tuple[int, List[Any]]] = deque()

    def __len__(self) -> int:
        return len(self._inflight)

    def admit(self, round_idx: int, handles: Any) -> None:
        """Register round ``round_idx``'s handles; wait for the oldest
        rounds first while more than ``depth`` are in flight (depth 0:
        this round at once)."""
        hs = [h for h in (handles if isinstance(handles, (list, tuple))
                          else [handles]) if h is not None]
        self._inflight.append((int(round_idx), hs))
        while len(self._inflight) > self.depth:
            self._sync_oldest()

    def drain(self) -> None:
        """Wait for every admitted round (eval / checkpoint / callback
        boundaries, the end of training)."""
        while self._inflight:
            self._sync_oldest()

    def abandon(self) -> None:
        """Drop the in-flight rounds without waiting (abort paths, where
        the error already surfaced and waiting again would re-raise)."""
        self._inflight.clear()

    def _sync_oldest(self) -> None:
        round_idx, hs = self._inflight.popleft()
        t0 = time.perf_counter()
        try:
            from .resilience import chaos

            # a scripted hit stands in for a device fault surfacing at
            # this wait: it comes back attributed to this round
            chaos.hit("pipeline_sync")
            for h in hs:
                wait = getattr(h, "synchronize", None)
                if wait is not None:
                    wait()
        except Exception as e:
            self._attribute(round_idx, e)
            try:
                e.pipeline_round = round_idx  # type: ignore[attr-defined]
            except Exception:
                pass
            raise
        finally:
            from .observability import flight

            flight.note("sync", time.perf_counter() - t0)

    @staticmethod
    def _attribute(round_idx: int, exc: BaseException) -> None:
        try:
            from .observability import flight, trace

            flight.RECORDER.event(
                "pipeline_fault", round=int(round_idx),
                error=type(exc).__name__, detail=str(exc)[:200])
            trace.instant("pipeline_fault", round=int(round_idx),
                          error=type(exc).__name__)
        except Exception:
            pass  # attribution must never mask the fault itself
