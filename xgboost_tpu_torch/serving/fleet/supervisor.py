"""Replica supervisor: spawn, watch, respawn and scale crash-only servers
(the port of the JAX package's ``serving/fleet/supervisor.py``).

``python -m xgboost_tpu_torch serve-fleet --replicas N --run-dir D --port
P`` is the one-command fleet: N ``python -m xgboost_tpu_torch serve``
children sharing ONE manifest (``D/manifest.json``, written by
``ModelServer._write_manifest``: versioned, merged on write, renamed into
place), behind the consistent-hash :class:`~.router.Router` on one TCP
port. Each replica is its own process, with its own interpreter lock and,
on the card, its own CUDA context; the supervising process (supervisor
and router) forwards JSON lines and makes no CUDA context. Layout::

    D/manifest.json          # shared: every replica's loads and swaps
    D/models/                # raw-source spill (written by replicas)
    D/fleet.json             # supervisor state: ids, ports, pids, generation
    D/replica<k>/            # each replica's own run_dir
        obs/server/...       #   its serving flight recorder (serve-report
        serve.log            #   merges every replica<k>/)

A replica that exits for any reason the supervisor did not start (SIGKILL,
a crash, an operator's SIGTERM drain) is respawned with ``--run-dir`` and
``--manifest`` only: it re-serves its whole model set from the shared
manifest. ``--model name=path`` seeds the manifest on the first boot only.
The router learns of every spawn and respawn (``set_endpoint``: the same
ring position, so a respawned replica takes back exactly its models) and
of every scale-down (``remove_endpoint`` before the SIGTERM drain, which
loses no admitted request).

A child that exits before its ``READY`` line (no card, a failed kernel
build) fails :meth:`FleetSupervisor._spawn` at once with a
``RuntimeError`` naming the replica and its ``serve.log``; the wait for
``READY`` is bounded by ``ready_timeout_s`` otherwise.
``XGBTPU_REPLICAS`` is the default count; ``fleet_replica_restarts_total``
counts unplanned respawns and ``fleet_replicas`` is the target gauge.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ...observability import flight as _flight
from ...observability import trace
from ...observability.metrics import REGISTRY
from .router import Router

__all__ = ["FleetSupervisor", "serve_fleet_main", "free_port"]

FLEET_FORMAT = "xgbtpu-fleet-v1"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def free_port(host: str = "127.0.0.1") -> int:
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Replica:
    """One supervised child: its process, its port and its state."""

    def __init__(self, rid: int, port: int,
                 proc: "subprocess.Popen") -> None:
        self.rid = rid
        self.port = port
        self.proc = proc
        self.ready = threading.Event()
        self.generation = 0
        self.expected_exit = False
        self.spawned_unix = time.time()
        self.ready_unix: Optional[float] = None

    @property
    def name(self) -> str:
        return f"r{self.rid}"


class FleetSupervisor:
    """Owns the replica processes. ``spawn_cmd(rid, port) -> argv`` can be
    given (tests supervise a standard-library stub); the default is the
    port's ``serve`` command."""

    def __init__(self, run_dir: str, *,
                 replicas: Optional[int] = None,
                 models: Optional[Dict[str, str]] = None,
                 host: str = "127.0.0.1",
                 serve_args: Optional[List[str]] = None,
                 spawn_cmd: Optional[Callable] = None,
                 ready_timeout_s: float = 180.0,
                 router: Optional[Router] = None) -> None:
        self.run_dir = os.path.abspath(run_dir)
        self.manifest = os.path.join(self.run_dir, "manifest.json")
        self.host = host
        self.models = dict(models or {})
        self.serve_args = list(serve_args or [])
        self.spawn_cmd = spawn_cmd
        self.ready_timeout_s = ready_timeout_s
        self.router = router
        self.target = max(1, replicas if replicas is not None
                          else _env_int("XGBTPU_REPLICAS", 2))
        self._lock = threading.Lock()
        self._replicas: Dict[int, _Replica] = {}
        self._stopping = False
        self._monitor: Optional[threading.Thread] = None
        self._g_replicas = REGISTRY.gauge(
            "fleet_replicas", "Supervised replica target count")
        self._c_restarts = REGISTRY.counter(
            "fleet_replica_restarts_total",
            "Replica processes respawned after an unplanned exit")
        self._c_restarts.inc(0)
        os.makedirs(self.run_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def _default_cmd(self, rid: int, port: int) -> List[str]:
        cmd = [sys.executable, "-m", "xgboost_tpu_torch", "serve",
               "--port", str(port), "--host", self.host,
               "--run-dir", os.path.join(self.run_dir, f"replica{rid}"),
               "--manifest", self.manifest] + self.serve_args
        if self.models and not os.path.exists(self.manifest):
            # the first boot only: afterwards the shared manifest IS the
            # model set, and a respawn must serve from it alone
            for name, path in sorted(self.models.items()):
                cmd += ["--model", f"{name}={path}"]
        return cmd

    def _spawn(self, rid: int, *, restart: bool = False) -> _Replica:
        port = free_port(self.host)
        cmd = (self.spawn_cmd or self._default_cmd)(rid, port)
        rdir = os.path.join(self.run_dir, f"replica{rid}")
        os.makedirs(rdir, exist_ok=True)
        t_spawn = time.time()
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        rep = _Replica(rid, port, proc)
        rep.spawned_unix = t_spawn
        log_path = os.path.join(rdir, "serve.log")

        def pump() -> None:
            # the replica's output -> its log; the first READY line sets
            # the event the spawner waits on
            try:
                with open(log_path, "a") as log:
                    for line in proc.stdout:
                        log.write(line)
                        log.flush()
                        if line.startswith("READY"):
                            rep.ready.set()
            except (OSError, ValueError):
                pass

        pumper = threading.Thread(target=pump,
                                  name=f"xgbtpu-fleet-log-{rid}",
                                  daemon=True)
        pumper.start()
        deadline = time.monotonic() + self.ready_timeout_s
        while not rep.ready.wait(0.05):
            if proc.poll() is not None:
                pumper.join(5)  # the log holds the child's last words
                if rep.ready.is_set():
                    break
                raise RuntimeError(
                    f"replica {rid} not READY: exited with code "
                    f"{proc.returncode} before READY (see {log_path})")
            if time.monotonic() >= deadline:
                proc.kill()
                proc.wait(10)
                raise RuntimeError(
                    f"replica {rid} not READY within {self.ready_timeout_s}s "
                    f"(see {log_path})")
        rep.ready_unix = time.time()
        with self._lock:
            old = self._replicas.get(rid)
            rep.generation = (old.generation + 1) if old else 0
            self._replicas[rid] = rep
        if restart:
            self._c_restarts.inc()
        trace.instant("replica_spawn", replica=rep.name, port=port,
                      pid=proc.pid, restart=restart)
        if self.router is not None:
            self.router.set_endpoint(rep.name, self.host, port)
        self._write_state()
        return rep

    # ------------------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        """Spawn the target count, one after another, then watch them. A
        replica that fails to come up stops the ones already up and
        raises its ``RuntimeError``."""
        self._g_replicas.set(self.target)
        try:
            for rid in range(self.target):
                self._spawn(rid)
        except BaseException:
            self.stop(drain_timeout_s=10)
            raise
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="xgbtpu-fleet-monitor",
            daemon=True)
        self._monitor.start()
        return self

    def _monitor_loop(self) -> None:
        while True:
            time.sleep(0.2)
            with self._lock:
                if self._stopping:
                    return
                dead = [rep for rep in self._replicas.values()
                        if rep.proc.poll() is not None]
            for rep in dead:
                with self._lock:
                    if self._stopping or rep.expected_exit:
                        continue
                    if self._replicas.get(rep.rid) is not rep:
                        continue  # already respawned
                rc = rep.proc.returncode
                trace.instant("replica_exit", replica=rep.name, rc=rc)
                if self.router is not None:
                    # the process is gone: no need to wait out a probe
                    self.router.mark_down(rep.name,
                                          why=f"process exit rc={rc}")
                try:
                    self._spawn(rep.rid, restart=True)
                except (OSError, RuntimeError) as e:
                    trace.instant("replica_respawn_failed",
                                  replica=rep.name, error=str(e))

    # ------------------------------------------------------------------
    def scale(self, n: int, drain_timeout_s: float = 60.0) -> None:
        """Spawn up to, or SIGTERM-drain down to, ``n`` replicas. A
        scale-down drains the highest-numbered replicas and takes them off
        the router before the signal, so no new request races the
        drain."""
        n = max(1, int(n))
        with self._lock:
            have = sorted(self._replicas)
            self.target = n
        self._g_replicas.set(n)
        for rid in range(len(have), n):
            self._spawn(rid)
        for rid in have[n:]:
            with self._lock:
                rep = self._replicas.get(rid)
                if rep is None:
                    continue
                rep.expected_exit = True
            if self.router is not None:
                self.router.remove_endpoint(rep.name)
            self._terminate(rep, drain_timeout_s)
            with self._lock:
                self._replicas.pop(rid, None)
        self._write_state()

    @staticmethod
    def _terminate(rep: _Replica, timeout_s: float) -> None:
        if rep.proc.poll() is None:
            try:
                rep.proc.send_signal(signal.SIGTERM)
            except OSError:
                return
        try:
            rep.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rep.proc.kill()
            rep.proc.wait(timeout=10)

    def stop(self, drain_timeout_s: float = 60.0) -> None:
        with self._lock:
            self._stopping = True
            reps = list(self._replicas.values())
            for rep in reps:
                rep.expected_exit = True
        for rep in reps:
            self._terminate(rep, drain_timeout_s)
        self._write_state()

    # ------------------------------------------------------------------
    def replicas(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"replica": rep.name, "port": rep.port,
                     "pid": rep.proc.pid, "generation": rep.generation,
                     "alive": rep.proc.poll() is None,
                     "ready_unix_ms": rep.ready_unix * 1e3,
                     "ready_s": rep.ready_unix - rep.spawned_unix}
                    for rep in sorted(self._replicas.values(),
                                      key=lambda r: r.rid)]

    def _write_state(self) -> None:
        """``fleet.json``: which pids and ports are live, written
        atomically like every shared file here. Beside the JAX package's
        keys, each replica carries ``ready_s`` (seconds from its spawn to
        its READY line) and ``ready_unix_ms``."""
        _flight.atomic_write_json(
            os.path.join(self.run_dir, "fleet.json"),
            {"format": FLEET_FORMAT, "unix_ms": time.time() * 1e3,
             "supervisor_pid": os.getpid(), "target": self.target,
             "manifest": self.manifest, "replicas": self.replicas()})


# ---------------------------------------------------------------------------
# the command line: python -m xgboost_tpu_torch serve-fleet
# ---------------------------------------------------------------------------

_USAGE = ("usage: python -m xgboost_tpu_torch serve-fleet --port N "
          "--run-dir D [--replicas K] [--model name=path ...] [--host H] "
          "[--arena-mb M] [--batch-wait-us U] [--max-queue Q] "
          "[--device cpu|cuda]")


def _parse_fleet_args(argv: List[str]) -> Dict[str, Any]:
    opts: Dict[str, Any] = {"models": {}, "port": None,
                            "host": "127.0.0.1", "replicas": None,
                            "run_dir": None, "serve_args": []}
    flags = {"--port": ("port", int), "--replicas": ("replicas", int),
             "--host": ("host", str), "--run-dir": ("run_dir", str)}
    # the replicas' own options; ``--device`` is the port's (the card
    # unless it says cpu)
    passthrough = {"--arena-mb", "--batch-wait-us", "--max-queue",
                   "--device"}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--model":
            i += 1
            name, sep, path = argv[i].partition("=")
            if not sep:
                raise ValueError("--model takes name=path")
            opts["models"][name] = path
        elif a in flags:
            key, conv = flags[a]
            i += 1
            opts[key] = conv(argv[i])
        elif a in passthrough:
            i += 1
            opts["serve_args"] += [a, argv[i]]
        else:
            raise ValueError(f"unknown serve-fleet option: {a!r}")
        i += 1
    if opts["port"] is None or not opts["run_dir"]:
        raise ValueError("serve-fleet needs --port N and --run-dir D")
    return opts


def serve_fleet_main(argv: List[str], stdout=None) -> int:
    """``python -m xgboost_tpu_torch serve-fleet``: supervisor and router
    in this process, the replicas as children. SIGTERM drains the whole
    fleet (the replicas first, losing no admitted request, then the
    router) and exits 0. A replica that cannot come up ends the command
    with exit status 1 and its error."""
    try:
        opts = _parse_fleet_args(argv)
    except (ValueError, IndexError) as e:
        print(f"serve-fleet: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 1
    stdout = stdout if stdout is not None else sys.stdout
    router = Router()
    sup = FleetSupervisor(
        opts["run_dir"], replicas=opts["replicas"], models=opts["models"],
        host=opts["host"], serve_args=opts["serve_args"], router=router)
    try:
        sup.start()
    except RuntimeError as e:
        print(f"serve-fleet: {e}", file=sys.stderr)
        return 1

    stopping = threading.Event()
    stop_lock = threading.Lock()

    def shutdown_fleet() -> None:
        # a second caller (the exit path after SIGTERM) waits for the
        # first one's drain, so no replica outlives this process
        with stop_lock:
            if stopping.is_set():
                return
            sup.stop()
            stopping.set()

    prev_term = None
    try:
        def _sigterm(signum, frame):
            threading.Thread(target=shutdown_fleet, daemon=True).start()
            router.request_shutdown()

        prev_term = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread (an in-process caller)

    reps = sup.replicas()
    banner = (f"READY fleet on {opts['host']}:{opts['port']} "
              f"({len(reps)} replicas: "
              + " ".join(f"{r['replica']}={r['port']}" for r in reps)
              + f" pid={os.getpid()})")
    try:
        return router.serve(opts["port"], opts["host"], stdout=stdout,
                            on_shutdown=shutdown_fleet, banner=banner)
    finally:
        shutdown_fleet()
        if prev_term is not None:
            try:
                signal.signal(signal.SIGTERM, prev_term)
            except ValueError:
                pass
