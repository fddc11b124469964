"""File-based worker membership and heartbeats for elastic training (the
port of the JAX package's ``parallel/membership.py``).

The reference's rabit tracker knows which workers live and restarts the
dead ones. ``torch.distributed`` has no such organ: a collective with a
dead peer raises (gloo) or waits for its timeout. This module keeps the
membership in a shared directory (local disk on one host, a network file
system across hosts), so it works under every backend and needs no server:

- every worker runs a **heartbeat agent subprocess** that writes
  ``<dir>/rank<r>.hb`` (JSON: rank, pid, seq, generation) every
  ``XGBTPU_HEARTBEAT`` seconds (default 1.0). A process, not a thread: a
  worker inside a blocking collective or a long kernel launch may hold the
  interpreter lock, and beats from a thread would stop exactly when
  liveness matters. The agent exits within one interval of its parent's
  death (it polls its parent pid), so a SIGKILL stops the beats and
  nothing else does;
- a daemon **monitor** thread in the worker scans the peers: a rank whose
  ``seq`` has not moved for ``XGBTPU_HEARTBEAT_DEADLINE`` seconds
  (default 5x the interval) is declared dead; a peer never seen gets a
  doubled allowance (its agent may still be starting);
- detection is **observable**: ``worker_alive{rank=}`` gauges, the
  ``membership_changes_total`` counter, trace instants and flight events
  on every transition;
- a death is made **durable** by a ``rank<r>.dead`` tombstone, so later
  generations and restarted processes agree on membership without timing
  out again; a live worker that finds its own tombstone is **fenced**
  (``Membership.fenced``) and must exit rather than split the run;
- the ``heartbeat_drop`` chaos site skips scripted beats in the agent.

Liveness is judged by ``seq`` moving on the local monotonic clock, never by
comparing file times across hosts. The file formats and environment keys
are the JAX package's, so workers of either package read each other's
heartbeats and tombstones.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Membership", "WorkerLost", "hb_interval", "hb_deadline"]

_ENV_INTERVAL = "XGBTPU_HEARTBEAT"
_ENV_DEADLINE = "XGBTPU_HEARTBEAT_DEADLINE"

# The heartbeat agent: a direct child of the worker that beats while (and
# only while) its parent lives. Standard library only: importing the
# package (and torch with it) would delay the first beat by seconds, longer
# than a short deadline. It carries its own copy of the chaos predicate for
# the ``heartbeat_drop`` site: the grammar and the crc32(site:hit:seed) hash
# of ``resilience/chaos.py``, which tests/test_torch_elastic.py holds it to.
_AGENT_SRC = r"""
import json, os, sys, time, zlib
path = sys.argv[1]
rank = int(sys.argv[2])
gen = int(sys.argv[3])
interval = float(sys.argv[4])
ppid = int(sys.argv[5])

SITE = "heartbeat_drop"


def _preds(cfg):
    out = []
    for clause in (cfg or "").split(";"):
        parts = [p.strip() for p in clause.split(":", 2)]
        if len(parts) != 3 or parts[0] != SITE:
            continue
        for tok in parts[2].split(","):
            tok = tok.strip()
            if not tok:
                continue
            try:
                if tok.startswith("p"):
                    ps, _, ss = tok[1:].partition("@")
                    prob, seed = float(ps), int(ss) if ss else 0
                    out.append(lambda n, p=prob, s=seed: (zlib.crc32(
                        ("%s:%d:%d" % (SITE, n, s)).encode())
                        & 0xFFFFFFFF) / 2**32 < p)
                elif tok.startswith("%"):
                    out.append(lambda n, k=int(tok[1:]): n % k == 0)
                elif tok.endswith("+"):
                    out.append(lambda n, lo=int(tok[:-1]): n >= lo)
                elif "-" in tok:
                    lo, _, hi = tok.partition("-")
                    out.append(lambda n, lo=int(lo), hi=int(hi):
                               lo <= n <= hi)
                else:
                    out.append(lambda n, t=int(tok): n == t)
            except ValueError:
                pass
    return out


preds = _preds(os.environ.get("XGBTPU_CHAOS"))
seq = 0
hit = 0
while os.getppid() == ppid:
    hit += 1
    if not any(p(hit) for p in preds):
        seq += 1
        tmp = path + ".tmp." + str(os.getpid())
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps({"rank": rank, "pid": ppid,
                                    "seq": seq, "generation": gen}))
            os.replace(tmp, path)
        except OSError:
            pass
    time.sleep(interval)
"""


def hb_interval() -> float:
    """Heartbeat write and scan period in seconds (``XGBTPU_HEARTBEAT``,
    default 1.0, at least 0.05)."""
    try:
        return max(0.05, float(os.environ.get(_ENV_INTERVAL, 1.0)))
    except ValueError:
        return 1.0


def hb_deadline() -> float:
    """Seconds of heartbeat silence that mean death
    (``XGBTPU_HEARTBEAT_DEADLINE``, default 5x the interval: a couple of
    dropped beats is jitter, five is a death)."""
    try:
        raw = os.environ.get(_ENV_DEADLINE)
        if raw is not None:
            return max(hb_interval(), float(raw))
    except ValueError:
        pass
    return 5.0 * hb_interval()


class WorkerLost(RuntimeError):
    """One or more peers died (heartbeat silence or a tombstone). Carries
    the dead base ranks and the round at which the loss was observed: the
    signal the elastic loop quiesces and resizes on."""

    def __init__(self, ranks: List[int], round: int = -1):
        super().__init__(
            f"worker_lost: rank(s) {sorted(ranks)} dead"
            + (f" (observed at round {round})" if round >= 0 else ""))
        self.ranks = sorted(ranks)
        self.round = round


class Membership:
    """Heartbeat writer and peer monitor of one worker.

    ``rank`` is the worker's base rank, its identity for the whole elastic
    run, never renumbered by a resize; ``peers`` is the base-rank set of
    the current generation, this worker included."""

    def __init__(self, directory: str, rank: int, peers: List[int],
                 generation: int = 0):
        self.directory = directory
        self.rank = int(rank)
        self.peers = sorted(int(p) for p in peers)
        self.generation = int(generation)
        self.round = 0  # set by the training guard at each round boundary
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._agent: Optional[subprocess.Popen] = None
        # peer base rank -> [last seq seen, monotonic time it was seen]
        self._seen: Dict[int, List[float]] = {}
        self._dead: set = set()
        self.fenced = False
        self._grace_until = 0.0

    def _hb_path(self, rank: int) -> str:
        return os.path.join(self.directory, f"rank{rank}.hb")

    def _tomb_path(self, rank: int) -> str:
        return os.path.join(self.directory, f"rank{rank}.dead")

    def _spawn_agent(self) -> subprocess.Popen:
        """Start the beat agent as a direct child; ``XGBTPU_CHAOS`` rides
        along in the inherited environment. ``-S``: no ``site`` import, so
        no site customization delays the first beat."""
        return subprocess.Popen(
            [sys.executable, "-S", "-c", _AGENT_SRC, self._hb_path(self.rank),
             str(self.rank), str(self.generation), str(hb_interval()),
             str(os.getpid())],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def _read_seq(self, rank: int) -> Optional[int]:
        try:
            with open(self._hb_path(rank)) as f:
                return int(json.load(f).get("seq", 0))
        except (OSError, ValueError):
            return None

    def scan(self) -> List[int]:
        """One monitoring pass: refresh the peers' liveness, publish the
        ``worker_alive`` gauges and return the dead set. A peer is dead
        when tombstoned, or when its ``seq`` has not moved for one
        deadline (a missing file counts from the start of the grace
        window, so a peer that never comes up is found too)."""
        from ..observability import flight, trace
        from ..observability.metrics import REGISTRY
        from ..utils import console_logger

        now = time.monotonic()
        deadline = hb_deadline()
        newly_dead: List[int] = []
        with self._lock:
            for p in self.peers:
                if p == self.rank or p in self._dead:
                    continue
                if os.path.exists(self._tomb_path(p)):
                    self._dead.add(p)
                    newly_dead.append(p)
                    continue
                seq = self._read_seq(p)
                # a peer never seen gets a doubled allowance: its agent may
                # still be starting while ours already beats
                ent = self._seen.setdefault(
                    p, [-1, (self._grace_until or now) + deadline])
                if seq is not None and seq != ent[0]:
                    ent[0], ent[1] = seq, now
                elif now - ent[1] > deadline:
                    self._dead.add(p)
                    newly_dead.append(p)
            if os.path.exists(self._tomb_path(self.rank)):
                self.fenced = True
            dead = sorted(self._dead)
        alive = REGISTRY.gauge(
            "worker_alive", "Membership liveness by base rank "
            "(1 alive, 0 dead)")
        for p in self.peers:
            alive.labels(rank=p).set(0.0 if p in dead else 1.0)
        for p in newly_dead:
            REGISTRY.counter(
                "membership_changes_total",
                "Membership transitions (worker joins and losses)").inc()
            trace.instant("worker_lost", rank=p, generation=self.generation)
            flight.RECORDER.event("worker_lost", rank=p,
                                  generation=self.generation)
            console_logger.warning(
                f"membership: rank {p} declared dead (generation "
                f"{self.generation}, heartbeat silence > {deadline:g}s)")
        return dead

    def dead_ranks(self) -> List[int]:
        with self._lock:
            return sorted(self._dead)

    def alive_ranks(self) -> List[int]:
        dead = set(self.dead_ranks())
        return [p for p in self.peers if p not in dead]

    def declare_dead(self, rank: int) -> None:
        """Write ``rank``'s tombstone: later generations (and the fenced
        worker itself, should it still live) read membership from it
        instead of timing out again."""
        from ..observability import flight, trace
        from ..resilience.checkpoint import atomic_write_bytes

        path = self._tomb_path(rank)
        if not os.path.exists(path):
            try:
                atomic_write_bytes(path, json.dumps(
                    {"rank": rank, "by": self.rank,
                     "generation": self.generation}).encode())
            except OSError:
                pass
            trace.instant("worker_tombstoned", rank=rank, by=self.rank)
            flight.RECORDER.event("worker_tombstoned", rank=rank,
                                  by=self.rank)
        with self._lock:
            if rank != self.rank:
                self._dead.add(rank)

    def wait_dead(self, ranks: List[int], timeout: float) -> List[int]:
        """Scan until every rank of ``ranks`` is declared dead or
        ``timeout`` seconds pass; returns the confirmed-dead subset. It
        corroborates a failed collective before a resize: a transient
        network fault must not shrink the world."""
        t0 = time.monotonic()
        want = set(ranks)
        while True:
            dead = set(self.scan())
            if want <= dead or time.monotonic() - t0 > timeout:
                return sorted(want & dead)
            time.sleep(min(0.1, hb_interval() / 2))

    def start(self) -> "Membership":
        """Spawn the beat agent, wait (at most one deadline) for its first
        beat, so that peers see this worker before it enters any
        collective, then scan the peers on a daemon thread."""
        self._grace_until = time.monotonic()
        self._agent = self._spawn_agent()
        t0 = time.monotonic()
        while not os.path.exists(self._hb_path(self.rank)) \
                and time.monotonic() - t0 < hb_deadline():
            time.sleep(0.02)
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(hb_interval()):
                self.scan()

        self._thread = threading.Thread(
            target=loop, name=f"xgbt-monitor-r{self.rank}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the monitor and the agent (the beats end with it)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * hb_interval())
            self._thread = None
        if self._agent is not None:
            try:
                self._agent.terminate()
                self._agent.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._agent.kill()
                self._agent.wait()
            self._agent = None
