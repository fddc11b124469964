"""Crash-safe model checkpoints: atomic writes, checksums, previous-good
fallback (the port of the JAX package's ``resilience/checkpoint.py``; the
reference's rabit ``LoadCheckPoint`` / ``CheckPoint`` replay from the last
committed version).

- **Atomic**: the payload goes to a pid- and thread-unique tmp file, is
  fsync'd and ``os.replace``d into place, then the directory is fsync'd:
  a SIGKILL at any instant leaves the old file or the new one.
- **Self-verifying**: a one-line JSON header carries the payload's
  SHA-256 and byte count; a read re-hashes, so truncation and bit flips
  are both caught.
- **Previous-good fallback**: ``load_latest`` walks the checkpoints newest
  first and skips corrupt ones (``checkpoint_corrupt_total``); retention
  keeps the 2 newest, so a good snapshot survives the one being written.

The file format is the JAX package's, byte for byte, so a checkpoint
written by either package verifies and loads in the other:
``ckpt_<rounds:08d>.ckpt`` = ``{"format": "xgbtpu-ckpt-v1", "rounds": R,
"sha256": ..., "payload_bytes": N}\\n`` then ``Booster.save_raw()``'s
bytes.

``train(..., resume_from=dir)`` builds on these: rerunning the command
after a crash resumes from the last committed round and grows the trees
an uninterrupted run grows.

By default ``train`` commits through the async writer
(``AsyncCheckpointWriter``, the JAX package's): the round loop takes the
model's snapshot (``Booster.save_json()``, which copies the device trees
to the host: a sync point) on its own thread, and one writer thread
encodes, hashes, writes, fsyncs, renames and prunes, overlapping the next
rounds. The loop waits again only when the previous write is still in
flight at the next checkpoint (charged to the flight ``checkpoint``
stage; the writer's own seconds go to ``checkpoint_io``). A write that
exhausts its retries is parked under its directory and re-raised, with
``.checkpoint_rounds``, at that directory's next ``submit`` or ``wait``.
The bytes are ``save_checkpoint``'s. ``XGBTPU_ASYNC_CKPT=0`` writes on
the caller's thread. A reader of a directory's newest checkpoint calls
``settle(directory)`` first, so it never misses a write still in flight
in this process.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import chaos, policy

__all__ = [
    "FORMAT", "checkpoint_path", "save_checkpoint", "read_checkpoint",
    "load_latest", "list_checkpoints", "process_dir", "inspect_dir",
    "verify_checkpoint", "path_rounds", "atomic_write_bytes",
    "AsyncCheckpointWriter", "async_writer", "async_enabled", "settle",
]

FORMAT = "xgbtpu-ckpt-v1"
_NAME_RE = re.compile(r"^ckpt_(\d{8})\.ckpt$")


def checkpoint_path(directory: str, rounds: int) -> str:
    return os.path.join(directory, f"ckpt_{rounds:08d}.ckpt")


def process_dir(directory: str, shared: bool = False) -> str:
    """This process's checkpoint directory (created if missing). In a
    ``torch.distributed`` world of more than one rank each rank gets a
    ``rank<r>`` subdirectory: the model is the same on every rank, and
    each rank owning its files needs no coordination. ``shared=True``
    keeps one directory for every rank (the tmp names are pid-unique, so
    ranks writing the same round commute)."""
    import torch.distributed as dist

    if not shared and dist.is_initialized() and dist.get_world_size() > 1:
        directory = os.path.join(directory, f"rank{dist.get_rank()}")
    os.makedirs(directory, exist_ok=True)
    return directory


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Durable atomic write: pid- and thread-unique tmp file, fsync,
    ``os.replace``, directory fsync (best effort: not every file system
    takes a directory fd)."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def _write_atomic(path: str, header: bytes, payload: bytes) -> None:
    chaos.hit("checkpoint_write")
    delay = os.environ.get("XGBTPU_TEST_CKPT_WRITE_DELAY")
    if delay:  # test hook: widen the SIGKILL-mid-write window
        time.sleep(float(delay))
    atomic_write_bytes(path, header + b"\n" + payload)


def save_checkpoint(directory: str, booster, rounds: int, *,
                    retain: int = 2) -> str:
    """Atomically write ``booster`` as the checkpoint of ``rounds``
    finished rounds, then prune to the ``retain`` newest. Transient write
    faults are retried (``XGBTPU_RETRY``, default 2 retries). The write's
    seconds go to the flight stage ``checkpoint``."""
    return _commit_payload(directory, booster.save_raw(), rounds, retain)


def _commit_payload(directory: str, payload: bytes, rounds: int,
                    retain: int, stage: str = "checkpoint") -> str:
    """Header, atomic write and pruning of an encoded model: the part of
    ``save_checkpoint`` the async writer runs on its thread, its seconds
    charged to ``stage``."""
    from ..observability import flight, trace
    from ..observability.metrics import REGISTRY

    header = json.dumps({
        "format": FORMAT,
        "rounds": int(rounds),
        "sha256": hashlib.sha256(payload).hexdigest(),
        "payload_bytes": len(payload),
    }).encode()
    path = checkpoint_path(directory, rounds)
    t0 = time.perf_counter()
    with trace.span("checkpoint_write", rounds=int(rounds),
                    bytes=len(payload)):
        policy.RetryPolicy("checkpoint_write", retries=2).run(
            _write_atomic, path, header, payload)
    flight.note(stage, time.perf_counter() - t0)
    REGISTRY.counter(
        "checkpoints_written_total", "Atomic checkpoints committed").inc()
    for old in list_checkpoints(directory)[:-retain] if retain else []:
        try:
            os.unlink(old)
        except OSError:
            pass
    return path


_ASYNC_ENV = "XGBTPU_ASYNC_CKPT"


def async_enabled() -> bool:
    """Whether ``train`` commits through the writer thread
    (``XGBTPU_ASYNC_CKPT=0``: on the caller's thread)."""
    return os.environ.get(_ASYNC_ENV) != "0"


class AsyncCheckpointWriter:
    """One-slot background checkpoint committer, thread-safe; one per
    process (``async_writer``). Failures are parked by directory: two
    trainings in one process share the thread, and one's exhausted
    retries surface at its own next sync point, never in the other's
    run."""

    def __init__(self) -> None:
        self._cond = threading.Condition(threading.Lock())
        self._task: Optional[Tuple[str, Dict[str, Any], int, int]] = None
        self._busy = False
        self._errors: Dict[str, BaseException] = {}
        self._thread: Optional[threading.Thread] = None
        self._newest: Dict[str, int] = {}  # directory -> newest submitted
        self._current: Optional[Tuple[str, int]] = None  # being written

    def submit(self, directory: str, booster, rounds: int, *,
               retain: int = 2) -> None:
        """Take ``booster``'s snapshot on this thread and queue its commit.
        Waits only while the previous write is in flight (charged to the
        flight ``checkpoint`` stage); re-raises a failure parked for
        ``directory``."""
        from ..observability import flight

        doc = booster.save_json()  # host lists only: the thread reads no tensor
        with self._cond:
            self._raise_pending_locked(directory)
            t0 = time.perf_counter()
            while self._busy:
                self._cond.wait()
            waited = time.perf_counter() - t0
            self._raise_pending_locked(directory)
            self._task = (directory, doc, int(rounds), int(retain))
            self._busy = True
            self._newest[directory] = int(rounds)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="xgbtpu-ckpt-writer", daemon=True)
                self._thread.start()
            self._cond.notify_all()
        if waited > 0:
            flight.note("checkpoint", waited)

    def wait(self, directory: Optional[str] = None) -> None:
        """Wait until the write in flight has landed and re-raise a parked
        failure: a checkpoint is durable once this returns. With
        ``directory``, waits only while that directory's write is in
        flight and raises only its failure; with None, every write and any
        failure."""
        from ..observability import flight

        with self._cond:
            t0 = time.perf_counter()
            while self._busy and (directory is None
                                  or self._inflight_dir() == directory):
                self._cond.wait()
            waited = time.perf_counter() - t0
            self._raise_pending_locked(directory)
        if waited > 0:
            flight.note("checkpoint", waited)

    def settle(self, directory: str) -> None:
        """Wait while ``directory``'s write is in flight, leaving a parked
        failure for its run's own sync point (the readers' barrier).
        Paths compare as absolute paths."""
        want = os.path.abspath(directory)
        with self._cond:
            while self._busy and os.path.abspath(
                    self._inflight_dir() or "") == want:
                self._cond.wait()

    def _inflight_dir(self) -> Optional[str]:
        """The directory of the queued or running write (lock held)."""
        if self._task is not None:
            return self._task[0]
        return self._current[0] if self._current is not None else None

    def covered(self, directory: str, rounds: int) -> bool:
        """The probe before a write: True when the commit of ``(directory,
        rounds)`` is queued or being written, or was submitted here and
        its file is still on disk (a directory wiped since re-commits)."""
        with self._cond:
            if self._newest.get(directory) != int(rounds):
                return False
            if self._task is not None and self._task[0] == directory \
                    and self._task[2] == int(rounds):
                return True
            if self._current == (directory, int(rounds)):
                return True
        return os.path.exists(checkpoint_path(directory, rounds))

    def reset(self) -> None:
        """Tests: wait without raising, drop parked failures and the
        submitted-rounds memo."""
        with self._cond:
            while self._busy:
                self._cond.wait()
            self._errors.clear()
            self._newest.clear()

    def _raise_pending_locked(self, directory: Optional[str]) -> None:
        if directory is None:
            for d in list(self._errors):
                raise self._errors.pop(d)
            return
        e = self._errors.pop(directory, None)
        if e is not None:
            raise e

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._task is None:
                    self._cond.wait()
                directory, doc, rounds, retain = self._task
                self._task = None
                self._current = (directory, rounds)
            try:
                payload = json.dumps(doc).encode()  # save_raw()'s bytes
                _commit_payload(directory, payload, rounds, retain,
                                stage="checkpoint_io")
            except BaseException as e:  # parked for the next sync point
                try:
                    e.checkpoint_rounds = rounds  # type: ignore[attr-defined]
                except Exception:
                    pass
                with self._cond:
                    self._errors.setdefault(directory, e)
                try:
                    from ..observability import flight

                    flight.RECORDER.event(
                        "checkpoint_fault", rounds=int(rounds),
                        error=type(e).__name__, detail=str(e)[:200])
                except Exception:
                    pass  # attribution must never mask the fault
            finally:
                with self._cond:
                    self._busy = False
                    self._current = None
                    self._cond.notify_all()


_writer_lock = threading.Lock()
_writer: Optional[AsyncCheckpointWriter] = None


def async_writer() -> AsyncCheckpointWriter:
    """The process's checkpoint writer (made at the first call)."""
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = AsyncCheckpointWriter()
        return _writer


def settle(directory: str) -> None:
    """Wait until no write of ``directory`` is in flight in this process
    (a no-op before the writer's first use); a parked failure stays
    parked."""
    w = _writer
    if w is not None:
        w.settle(directory)


def list_checkpoints(directory: str) -> List[str]:
    """Checkpoint paths in ``directory``, oldest first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = [n for n in names if _NAME_RE.match(n)]
    return [os.path.join(directory, n) for n in sorted(out)]


def _verify(path: str) -> Tuple[Optional[bytes], str, int]:
    """(payload or None, detail, rounds) of one checkpoint file."""
    with open(path, "rb") as f:
        header_line = f.readline(1 << 16)
        payload = f.read()
    try:
        header = json.loads(header_line)
    except ValueError:
        return None, "unparsable header", -1
    rounds = int(header.get("rounds", -1))
    if header.get("format") != FORMAT:
        return None, f"unknown format {header.get('format')!r}", rounds
    if len(payload) != header.get("payload_bytes"):
        return None, (f"truncated: {len(payload)} of "
                      f"{header.get('payload_bytes')} payload bytes"), rounds
    if hashlib.sha256(payload).hexdigest() != header.get("sha256"):
        return None, "checksum mismatch (bit corruption)", rounds
    return payload, "ok", rounds


def read_checkpoint(path: str) -> Optional[Tuple[bytes, int]]:
    """(payload, rounds) if ``path`` verifies, else None: a corrupt,
    truncated or foreign file is counted in ``checkpoint_corrupt_total``
    and logged, never raised; an absent one is not counted."""
    from ..observability.metrics import REGISTRY
    from ..utils import console_logger

    try:
        payload, detail, rounds = _verify(path)
    except FileNotFoundError:
        return None
    except OSError as e:
        payload, detail = None, f"unreadable ({e})"
    if payload is None:
        REGISTRY.counter(
            "checkpoint_corrupt_total",
            "Checkpoints rejected by verification").inc()
        console_logger.warning(f"checkpoint {path}: {detail}; skipping")
        return None
    return payload, rounds


def load_latest(directory: str) -> Optional[Tuple[bytes, int]]:
    """The newest verified checkpoint in ``directory`` as (payload,
    rounds), falling back past corrupt ones; None when none is usable."""
    for path in reversed(list_checkpoints(directory)):
        got = read_checkpoint(path)
        if got is not None:
            return got
    return None


def verify_checkpoint(path: str) -> Tuple[bool, str, int]:
    """(verified, detail, rounds) of one checkpoint file, the reason given
    rather than logged."""
    try:
        payload, detail, rounds = _verify(path)
    except OSError as e:
        return False, f"unreadable ({e})", -1
    return payload is not None, detail, rounds


def path_rounds(path: str) -> Optional[int]:
    """The rounds a checkpoint's file name advertises, without I/O (a hint:
    the verified header is the authority)."""
    m = _NAME_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else None


def inspect_dir(directory: str) -> List[dict]:
    """One record per checkpoint file of ``directory`` and its ``rank<r>``
    subdirectories: path, rounds, bytes, verified, detail, and
    ``newest_verified`` on the one ``load_latest`` would resume from in
    each directory. A write of this process still in flight to any of
    those directories lands first (``settle``)."""
    dirs = [directory]
    try:
        for name in sorted(os.listdir(directory)):
            sub = os.path.join(directory, name)
            if name.startswith("rank") and os.path.isdir(sub):
                dirs.append(sub)
    except OSError:
        return []
    records: List[dict] = []
    for d in dirs:
        settle(d)
        best = None
        recs = []
        for path in list_checkpoints(d):
            ok, detail, rounds = verify_checkpoint(path)
            rec = {"path": path, "rounds": rounds,
                   "bytes": os.path.getsize(path), "verified": ok,
                   "detail": detail, "newest_verified": False}
            recs.append(rec)
            if ok:
                best = rec
        if best is not None:
            best["newest_verified"] = True
        records.extend(recs)
    return records
