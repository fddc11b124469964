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

Writes run on the caller's thread. The JAX package's async writer
(``XGBTPU_ASYNC_CKPT``) is not ported: there it overlaps the write with
the pipelined round loop, which the port does not have, and on the
port's host-bound round its thread's JSON encoding and hashing cost as
much as they hide.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from typing import List, Optional, Tuple

from . import chaos, policy

__all__ = [
    "FORMAT", "checkpoint_path", "save_checkpoint", "read_checkpoint",
    "load_latest", "list_checkpoints", "process_dir", "inspect_dir",
    "verify_checkpoint", "path_rounds", "atomic_write_bytes",
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
    from ..observability import flight, trace
    from ..observability.metrics import REGISTRY

    payload = booster.save_raw()
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
    flight.note("checkpoint", time.perf_counter() - t0)
    REGISTRY.counter(
        "checkpoints_written_total", "Atomic checkpoints committed").inc()
    for old in list_checkpoints(directory)[:-retain] if retain else []:
        try:
            os.unlink(old)
        except OSError:
            pass
    return path


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
    each directory."""
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
