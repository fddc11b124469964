"""Per-round flight recorder: the always-on black box of training.

The port of the JAX package's ``observability/flight.py``, with its record
format (``xgbtpu-flight-v1``), so one reader serves both packages' files:

- **Always-on ring buffer** of per-round records: the round's wall time,
  its stage times (``grow``, ``eval``, ``sketch``, ``ingest``, ...), the
  collective operations and bytes of the round (``observability.comms``'s
  counters), the host's peak RSS and the card's allocator peak. Recording
  costs a few dict operations and two clock reads a round;
  ``XGBTPU_FLIGHT=0`` turns it off.
- **Durable sink** (``configure(run_dir, rank)``): each rank appends every
  completed record as one JSON line to ``run_dir/obs/rank<k>/flight.jsonl``
  (line-buffered: a SIGKILL loses at most the round in flight), refreshes
  ``metrics.json`` (the registry's snapshot) and sends the span trace to
  ``trace.jsonl`` with its clock base (``clock.json``).
- **Black-box dump** (``RECORDER.dump(reason)``): the whole ring and the
  registry's snapshot, written atomically to ``blackbox.json``; ``train``
  fires it on any abort (``abort_dump``).
- **Profiling window**: ``XGBTPU_PROFILE=<dir>`` captures a
  ``torch.profiler`` trace (host and, with a card, CUDA activity) of the
  first ``XGBTPU_PROFILE_ROUNDS`` (default 5) rounds of the next training
  loop into ``<dir>/profile.json``.

What differs from the JAX package: a round record has no ``retraces``
field (it counts JAX recompilations, which have no counterpart here); the
device watermark ``dev_peak_mb`` is ``torch.cuda.max_memory_allocated``
of the current card, read from the caching allocator's counters (a host
read: no synchronization), and present only once CUDA is initialised; a
black box has no ``dispatch`` table (the JAX package's routing seam).

Nothing here reads a tensor, so the recorder never synchronizes the
device: ``wall_s`` and the stage times are host-clock intervals.

File formats (parseable line by line):

- ``flight.jsonl``: first a ``{"t": "meta", ...}`` line (rank, pid, clock
  base), then ``{"t": "round", ...}`` and ``{"t": "event", ...}`` records,
  one a line;
- ``blackbox.json``: one JSON object, the meta fields, ``records`` and
  ``metrics``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import trace as _trace
from .metrics import REGISTRY

__all__ = [
    "FlightRecorder", "RECORDER", "enabled", "note", "configure",
    "stage_totals", "profile_tick", "profile_stop", "atomic_write_json",
]

_ENV_FLIGHT = "XGBTPU_FLIGHT"
_ENV_BUFFER = "XGBTPU_FLIGHT_BUFFER"
_ENV_PROFILE = "XGBTPU_PROFILE"
_ENV_PROFILE_ROUNDS = "XGBTPU_PROFILE_ROUNDS"

FORMAT = "xgbtpu-flight-v1"

_ROUND_SECONDS_HELP = "Wall time per boosting round (flight recorder)"


def enabled() -> bool:
    """Whether recording is on (``XGBTPU_FLIGHT=0`` turns it off)."""
    return os.environ.get(_ENV_FLIGHT) != "0"


_enabled = enabled


def _rank() -> int:
    """This process's rank in the initialised ``torch.distributed`` world
    (0 without one)."""
    from .. import collective

    return collective.get_rank()


def atomic_write_json(path: str, doc: Dict[str, Any]) -> bool:
    """Replace-write ``doc`` as JSON (a temporary file and a rename; no
    fsync). Best effort: returns False instead of raising, because a dump
    must never mask the abort it documents."""
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return True
    except (OSError, ValueError, TypeError):
        return False


def _rss_peak_mb() -> float:
    """Host peak RSS in MB (``ru_maxrss`` is KB on Linux)."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    except Exception:
        return 0.0


def _dev_peak_mb() -> Optional[float]:
    """The caching allocator's peak on the current card in MB, or None
    before CUDA is initialised (never initialises it)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class FlightRecorder:
    """Ring buffer of per-round records plus the durable sink. One
    process-wide instance (``RECORDER``); every method is thread-safe."""

    def __init__(self, maxlen: Optional[int] = None) -> None:
        if maxlen is None:
            try:
                maxlen = int(os.environ.get(_ENV_BUFFER, "4096") or 4096)
            except ValueError:
                maxlen = 4096
        self._lock = threading.RLock()
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=max(maxlen, 16))
        self._open: Optional[Dict[str, Any]] = None
        self._depth = 0  # nested begin_round (update_many under train)
        self._generation = 0  # the elastic generation (set_generation)
        self._t0 = 0.0
        # cumulative per-stage seconds of the whole process, stage time
        # outside any round (the first sketch) included
        self._stage_totals: Dict[str, float] = {}
        # deltas against the previous round's absolute totals
        self._last_coll = (0.0, 0.0)
        # sink state (configure)
        self._dir: Optional[str] = None
        self._rank: Optional[int] = None
        self._file = None

    # ------------------------------------------------------------------
    def _coll_totals(self) -> tuple:
        ops = by = 0.0
        for name in ("collective_ops_total", "collective_bytes_total"):
            fam = REGISTRY.get(name)
            if fam is None:
                continue
            total = sum(child.value for _, child in fam.series())
            if name.endswith("ops_total"):
                ops = total
            else:
                by = total
        return ops, by

    # ------------------------------------------------------------------
    # the round's lifecycle (the training loop's three calls)
    # ------------------------------------------------------------------
    def set_generation(self, generation: int) -> None:
        """The elastic generation stamped in ``gen`` on every later round
        record and event (``elastic_train`` sets it at every resize, so
        the fleet table keys replayed rounds as (gen, round))."""
        with self._lock:
            self._generation = int(generation)

    def begin_round(self, round_idx: int, rounds: int = 1) -> bool:
        """Open a round record. Returns True when this call owns the
        record; a nested begin (``update_many`` inside ``train``'s loop)
        returns False, and its caller then skips its own stage notes for
        work the owner already times."""
        if not _enabled():
            return False
        with self._lock:
            if self._open is not None:
                self._depth += 1
                return False
            if self._dir is None:
                env = os.environ.get(_ENV_FLIGHT)
                if env and env not in ("0", "1"):
                    self._configure_locked(env, None)
            self._t0 = time.perf_counter()
            self._open = {
                "t": "round", "round": int(round_idx), "rounds": int(rounds),
                "gen": self._generation,
                "unix_ms": time.time() * 1e3,
                "stages": {},
            }
            return True

    def note(self, stage: str, seconds: float) -> None:
        """Charge ``seconds`` of wall time to ``stage``, in the open round
        record (if any) and in the process's stage totals."""
        if not _enabled():
            return
        with self._lock:
            self._stage_totals[stage] = (
                self._stage_totals.get(stage, 0.0) + seconds)
            if self._open is not None:
                st = self._open["stages"]
                st[stage] = st.get(stage, 0.0) + seconds

    def annotate(self, key: str, value: Any) -> None:
        """Attach a JSON-able sub-record to the open round record under
        ``key`` (a repeat overwrites); dropped when no round is open."""
        if not _enabled():
            return
        with self._lock:
            if self._open is not None:
                self._open[key] = value

    def end_round(self) -> Optional[Dict[str, Any]]:
        if not _enabled():
            return None
        with self._lock:
            if self._depth:
                self._depth -= 1
                return None
            rec = self._open
            if rec is None:
                return None
            self._open = None
            wall = time.perf_counter() - self._t0
            rec["wall_s"] = round(wall, 6)
            rec["stages"] = {k: round(v, 6)
                             for k, v in rec["stages"].items()}
            ops, by = self._coll_totals()
            rec["coll_ops"] = ops - self._last_coll[0]
            rec["coll_bytes"] = by - self._last_coll[1]
            self._last_coll = (ops, by)
            rec["rss_peak_mb"] = round(_rss_peak_mb(), 1)
            dev = _dev_peak_mb()
            if dev is not None:
                rec["dev_peak_mb"] = round(dev, 1)
            self._ring.append(rec)
            self._write_line(rec)
        REGISTRY.histogram(
            "round_seconds", _ROUND_SECONDS_HELP).observe(wall)
        if self._dir is not None:
            self._refresh_sidecars()
        return rec

    def event(self, name: str, **args: Any) -> None:
        """An event (an abort, a fault): recorded in the ring and the
        sink."""
        if not _enabled():
            return
        rec = {"t": "event", "name": name,
               "unix_ms": time.time() * 1e3}
        if args:
            rec["args"] = dict(args)
        with self._lock:
            rec["gen"] = self._generation
            self._ring.append(rec)
            self._write_line(rec)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def last(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            for rec in reversed(self._ring):
                if rec.get("t") == "round":
                    return rec
            return None

    def stage_totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._stage_totals)

    @property
    def run_dir(self) -> Optional[str]:
        with self._lock:
            return self._dir

    # ------------------------------------------------------------------
    # sink
    # ------------------------------------------------------------------
    def configure(self, run_dir: str, rank: Optional[int] = None) -> str:
        """Attach the durable sink at ``run_dir/obs/rank<k>/`` (``rank``
        default: ``collective.get_rank()``). The first caller wins;
        returns the rank's directory."""
        with self._lock:
            if self._dir is None:
                self._configure_locked(run_dir, rank)
            return self._dir  # type: ignore[return-value]

    def _configure_locked(self, run_dir: str, rank: Optional[int]) -> None:
        rank = _rank() if rank is None else int(rank)
        d = os.path.join(run_dir, "obs", f"rank{rank}")
        try:
            os.makedirs(d, exist_ok=True)
            self._file = open(os.path.join(d, "flight.jsonl"), "a")
        except OSError:
            self._file = None
            return
        self._dir = d
        self._rank = rank
        meta = {
            "t": "meta", "format": FORMAT, "rank": rank,
            "pid": os.getpid(), "unix_ms": time.time() * 1e3,
            "clock": _trace.clock_base(),
        }
        self._write_line(meta)
        try:
            with open(os.path.join(d, "clock.json"), "w") as f:
                json.dump(_trace.clock_base(), f)
        except OSError:
            pass
        # the span trace goes to the same rank directory (a destination
        # set by XGBTPU_TRACE or set_config still wins)
        _trace.set_sink(os.path.join(d, "trace.jsonl"))

    def _write_line(self, rec: Dict[str, Any]) -> None:
        if self._file is None:
            return
        try:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        except (OSError, ValueError):
            pass

    def _refresh_sidecars(self) -> None:
        """Refresh ``metrics.json`` and flush the trace ring, so a SIGKILL
        between rounds leaves current sidecars on disk."""
        d = self._dir
        if d is None:
            return
        try:
            tmp = os.path.join(d, f".metrics.tmp.{os.getpid()}")
            with open(tmp, "w") as f:
                json.dump(REGISTRY.snapshot(), f)
            os.replace(tmp, os.path.join(d, "metrics.json"))
        except (OSError, ValueError):
            pass
        try:
            if _trace.enabled():
                _trace.flush()
        except Exception:
            pass

    # ------------------------------------------------------------------
    # black box
    # ------------------------------------------------------------------
    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the whole ring and the registry's snapshot as one atomic
        JSON file (``blackbox.json`` in the rank's directory unless
        ``path`` is given). Best effort. Returns the written path, or None
        when no sink is configured and no path was given."""
        if not _enabled():
            return None
        with self._lock:
            if path is None:
                if self._dir is None:
                    return None
                path = os.path.join(self._dir, "blackbox.json")
            doc = {
                "format": FORMAT, "reason": reason,
                "rank": self._rank if self._rank is not None else _rank(),
                "pid": os.getpid(), "unix_ms": time.time() * 1e3,
                "clock": _trace.clock_base(),
                "stage_totals_s": {k: round(v, 6) for k, v
                                   in self._stage_totals.items()},
                "records": list(self._ring),
            }
        try:
            doc["metrics"] = REGISTRY.snapshot()
        except Exception:
            doc["metrics"] = {}
        if not atomic_write_json(path, doc):
            return None
        self._refresh_sidecars()
        return path

    def abort_dump(self, exc: BaseException) -> None:
        """The training loop's abort hook: record the abort as an event,
        then dump the black box, both best effort."""
        try:
            self.event("train_abort", error=type(exc).__name__,
                       detail=str(exc)[:200])
            self.dump(f"abort:{type(exc).__name__}")
        except Exception:
            pass

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Tests: drop records and totals, detach the sink and the trace
        sink."""
        with self._lock:
            self._ring.clear()
            self._open = None
            self._depth = 0
            self._generation = 0
            self._stage_totals.clear()
            self._last_coll = (0.0, 0.0)
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
            self._file = None
            self._dir = None
            self._rank = None
        _trace.set_sink(None)


RECORDER = FlightRecorder()


def note(stage: str, seconds: float) -> None:
    RECORDER.note(stage, seconds)


def configure(run_dir: str, rank: Optional[int] = None) -> str:
    return RECORDER.configure(run_dir, rank)


def stage_totals() -> Dict[str, float]:
    return RECORDER.stage_totals()


# ---------------------------------------------------------------------------
# the profiling window: XGBTPU_PROFILE=<dir> captures a torch.profiler trace
# of the first XGBTPU_PROFILE_ROUNDS rounds of the next training loop
# ---------------------------------------------------------------------------

_prof_lock = threading.RLock()  # reentrant: _stop_locked re-enters
_prof_state: Dict[str, Any] = {"active": False, "stop_after": -1,
                               "used": False, "profiler": None}


def profile_tick(round_idx: int) -> None:
    """Called at each round boundary by the training loop. Starts the
    window on the first tick (once per process) and stops it after
    ``XGBTPU_PROFILE_ROUNDS`` rounds. Never raises into training."""
    directory = os.environ.get(_ENV_PROFILE)
    if not directory:
        return
    with _prof_lock:
        if _prof_state["active"]:
            if round_idx >= _prof_state["stop_after"]:
                _stop_locked()
            return
        if _prof_state["used"]:
            return
        try:
            rounds = max(1, int(os.environ.get(_ENV_PROFILE_ROUNDS, "5")))
        except ValueError:
            rounds = 5
        try:
            import torch

            os.makedirs(directory, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        except Exception as e:
            from ..utils import console_logger

            console_logger.warning(f"flight: profiler window failed to "
                                   f"start ({e}); continuing unprofiled")
            _prof_state["used"] = True
            return
        _prof_state.update(active=True, used=True, profiler=prof,
                           stop_after=round_idx + rounds)
        _trace.instant("profile_window_start", dir=directory, rounds=rounds)


def _stop_locked() -> None:
    prof = _prof_state["profiler"]
    try:
        prof.__exit__(None, None, None)
        out = os.path.join(os.environ.get(_ENV_PROFILE, "."),
                           "profile.json")
        prof.export_chrome_trace(out)
        from ..utils import console_logger

        console_logger.info(f"flight: torch.profiler window captured into "
                            f"{out}")
    except Exception:
        pass
    with _prof_lock:  # re-entrant: callers already hold it
        _prof_state.update(active=False, profiler=None)
    _trace.instant("profile_window_stop")


def profile_stop() -> None:
    """Close a still-open window (the training loop's ``finally``): a
    profile of fewer rounds beats an unterminated capture."""
    with _prof_lock:
        if _prof_state["active"]:
            _stop_locked()


def profile_reset() -> None:
    """Tests: allow another window in the same process."""
    with _prof_lock:
        if _prof_state["active"]:
            _stop_locked()
        _prof_state["used"] = False
        _prof_state["stop_after"] = -1
