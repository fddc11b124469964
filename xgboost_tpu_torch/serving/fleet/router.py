"""The fleet's routing front: one TCP port, N crash-only replicas behind
it (the port of the JAX package's ``serving/fleet/router.py``).

It speaks the server's JSONL line protocol, so every client of ``serve``
works unchanged when pointed at the router instead. It forwards JSON lines
and touches no tensor: the process that runs it makes no CUDA context.
Per line:

- ``predict`` routes by **consistent hash of the model name**
  (``hashring.py``), so each model's arena residency concentrates on one
  replica; when the hash target is saturated (``XGBTPU_ROUTER_SPILL``
  outstanding requests, default 16) the request **spills to the least
  loaded** healthy replica instead (``fleet_spills_total``).
- a request in flight to a replica that dies is **re-routed exactly
  once** to a healthy replica (``resilience.policy.should_reroute``:
  connection loss, EOF, timeout; a predict is idempotent, so the retry can
  duplicate work but never corrupt an answer), and the replica is marked
  unhealthy at once, without waiting for the next probe. A replica
  answering ``shed: draining`` (a SIGTERM drain) re-routes the same way.
  ``fleet_reroutes_total`` counts both; a failed re-route comes back as a
  typed error line carrying the request's id.
- ``load`` / ``swap`` (and the delivery plane's ``promote``, ``rollback``,
  ``quarantine``, ``unload``) **broadcast** to every healthy replica, and
  the shared manifest makes the change durable for replicas that join
  later.
- ``metrics`` answers with the router's registry exposition (the
  ``fleet_*`` series); ``stats`` with the replica table and the routing
  counters; ``shutdown`` stops the fleet.

Replica health: a probe thread pings every replica each
``XGBTPU_ROUTER_HEALTH_S`` (default 0.5 s) with a
``XGBTPU_ROUTER_HEALTH_DEADLINE_S`` (default 2 s) timeout; a replica is
healthy when it answers and is not draining. ``fleet_replica_healthy
{replica=}`` is the gauge and each change is a ``replica_health`` trace
instant. An unhealthy replica's models fail over to their ring successors
and fail back when the probe sees it again, which is how a respawned
replica rejoins within one probe interval. ``XGBTPU_ROUTER_TIMEOUT_S``
(default 120 s) bounds one forwarded request.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import sys
import threading
from collections import deque
from typing import Any, Dict, List, Optional

from ...observability import trace
from ...observability.metrics import REGISTRY
from ...resilience import policy
from ..faults import record_serving_fault
from .hashring import HashRing

__all__ = ["Router", "ReplicaEndpoint"]

ROUTE_SITE = "fleet_route"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


class ReplicaEndpoint:
    """One replica as the router sees it: address, health, a small pool of
    connections, and the outstanding requests the spill rule reads."""

    def __init__(self, rid: str, host: str, port: int) -> None:
        self.id = rid
        self.host = host
        self.port = port
        self.healthy = True  # the caller registers endpoints it saw READY
        self.draining = False
        self.outstanding = 0
        self._lock = threading.Lock()
        self._pool: "deque" = deque()

    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _acquire(self, timeout: float):
        with self._lock:
            if self._pool:
                return self._pool.popleft()
        sock = socket.create_connection((self.host, self.port),
                                        timeout=timeout)
        return sock, sock.makefile("rb")

    def _release(self, conn) -> None:
        with self._lock:
            if len(self._pool) < 8:
                self._pool.append(conn)
                return
        self._close(conn)

    @staticmethod
    def _close(conn) -> None:
        sock, rfile = conn
        for c in (rfile, sock):
            try:
                c.close()
            except OSError:
                pass

    def reset(self) -> None:
        """Drop every pooled connection (the endpoint moved or died)."""
        with self._lock:
            conns, self._pool = list(self._pool), deque()
        for conn in conns:
            self._close(conn)

    def rpc(self, msg: Dict[str, Any], timeout: float) -> Dict[str, Any]:
        """One request line -> one response line. Raises ConnectionError
        on EOF (a dead replica), OSError / TimeoutError on a transport
        failure; never returns None."""
        conn = self._acquire(timeout)
        sock, rfile = conn
        try:
            sock.settimeout(timeout)
            sock.sendall((json.dumps(msg) + "\n").encode())
            line = rfile.readline()
            if not line:
                raise ConnectionError(
                    f"connection closed by peer (replica {self.id})")
            out = json.loads(line)
        except BaseException:
            self._close(conn)
            raise
        self._release(conn)
        return out


class Router:
    """The routing table and the forwarding. :meth:`serve` runs the TCP
    front; :meth:`handle` answers one line (tests drive it directly)."""

    def __init__(self, replicas: Optional[List[ReplicaEndpoint]] = None, *,
                 vnodes: int = 64,
                 spill_after: Optional[int] = None,
                 health_interval_s: Optional[float] = None,
                 health_deadline_s: Optional[float] = None,
                 request_timeout_s: Optional[float] = None) -> None:
        self.spill_after = max(1, int(
            spill_after if spill_after is not None
            else _env_float("XGBTPU_ROUTER_SPILL", 16)))
        self.health_interval_s = max(0.05, (
            health_interval_s if health_interval_s is not None
            else _env_float("XGBTPU_ROUTER_HEALTH_S", 0.5)))
        self.health_deadline_s = max(0.1, (
            health_deadline_s if health_deadline_s is not None
            else _env_float("XGBTPU_ROUTER_HEALTH_DEADLINE_S", 2.0)))
        self.request_timeout_s = max(1.0, (
            request_timeout_s if request_timeout_s is not None
            else _env_float("XGBTPU_ROUTER_TIMEOUT_S", 120.0)))
        self._lock = threading.Lock()
        self._ring = HashRing(vnodes=vnodes)
        self._eps: Dict[str, ReplicaEndpoint] = {}
        self._g_healthy = REGISTRY.gauge(
            "fleet_replica_healthy",
            "Routing-front health verdict per replica (1 healthy)")
        self._c_routed = REGISTRY.counter(
            "fleet_routed_requests_total",
            "Requests the router forwarded, by replica")
        self._c_reroutes = REGISTRY.counter(
            "fleet_reroutes_total",
            "In-flight requests retried on a healthy replica after the "
            "hash target was lost or draining")
        self._c_spills = REGISTRY.counter(
            "fleet_spills_total",
            "Requests routed off their hash target to the least-loaded "
            "replica because the target was saturated")
        self._c_reroutes.inc(0)
        self._c_spills.inc(0)
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        self._tcp = None
        for ep in (replicas or []):
            self.set_endpoint(ep.id, ep.host, ep.port)

    # ------------------------------------------------------------------
    # membership (the supervisor's side)
    # ------------------------------------------------------------------
    def set_endpoint(self, rid: str, host: str, port: int) -> None:
        """Register or move a replica (a spawn or a respawn). Its ring
        position depends only on ``rid``, so a respawned replica takes
        back exactly its old models."""
        with self._lock:
            ep = self._eps.get(rid)
            if ep is None:
                ep = self._eps[rid] = ReplicaEndpoint(rid, host, port)
                self._ring.add(rid)
            else:
                ep.reset()
                ep.host, ep.port = host, port
                ep.healthy, ep.draining = True, False
            self._g_healthy.labels(replica=rid).set(1)

    def remove_endpoint(self, rid: str) -> None:
        """Forget a replica (a scale-down): its ring points go, so only
        its models remap."""
        with self._lock:
            ep = self._eps.pop(rid, None)
            self._ring.remove(rid)
            self._g_healthy.labels(replica=rid).set(0)
        if ep is not None:
            ep.reset()

    def endpoints(self) -> List[ReplicaEndpoint]:
        with self._lock:
            return list(self._eps.values())

    def mark_down(self, rid: str, why: str = "") -> None:
        """A down verdict from outside (the supervisor saw the process
        exit): stop routing there now, not after a probe."""
        with self._lock:
            ep = self._eps.get(rid)
        if ep is not None:
            self._mark(ep, False, why=why)

    def _mark(self, ep: ReplicaEndpoint, healthy: bool,
              draining: bool = False, why: str = "") -> None:
        with self._lock:
            changed = ep.healthy != healthy
            ep.healthy = healthy
            ep.draining = draining
            self._g_healthy.labels(replica=ep.id).set(1 if healthy else 0)
        if changed:
            trace.instant("replica_health", replica=ep.id,
                          healthy=healthy, detail=why)
        if not healthy:
            ep.reset()

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def route(self, model: str,
              exclude: Optional[set] = None) -> Optional[ReplicaEndpoint]:
        """The replica for one request: the first healthy node on the
        ring from the model's position, the least loaded healthy one when
        that target is saturated; None when no replica is healthy."""
        exclude = exclude or set()
        with self._lock:
            healthy = [ep for ep in self._eps.values()
                       if ep.healthy and not ep.draining
                       and ep.id not in exclude]
            if not healthy:
                return None
            ok_ids = {ep.id for ep in healthy}
            target = None
            for rid in self._ring.walk(model):
                if rid in ok_ids:
                    target = self._eps[rid]
                    break
            if target is None:
                return None
            if target.outstanding >= self.spill_after:
                spill = min(healthy, key=lambda e: (e.outstanding, e.id))
                if spill is not target \
                        and spill.outstanding < target.outstanding:
                    self._c_spills.inc()
                    return spill
            return target

    def handle(self, msg: Dict[str, Any], shutdown=None) -> Dict[str, Any]:
        """One protocol line: the router's own ops are answered here,
        everything else goes to a replica."""
        op = msg.get("op", "predict")
        rid = msg.get("id")
        if op == "metrics":
            return self._with_id(rid, {"metrics": REGISTRY.exposition()})
        if op == "stats":
            return self._with_id(rid, {"stats": self.stats()})
        if op == "shutdown":
            if shutdown is not None:
                shutdown()
            return self._with_id(rid, {"ok": True})
        if op in ("load", "swap", "promote", "rollback", "quarantine",
                  "unload"):
            # the delivery control plane converges every replica; the
            # shared manifest covers a replica the broadcast missed
            return self._with_id(rid, self._broadcast(msg))
        # predict, and a ``deliver`` op attaching a controller, run on ONE
        # replica: a controller attached through the router publishes with
        # no broadcast, so its decisions reach the other replicas through
        # the shared manifest at their next restart or fault-in
        return self._forward(msg)

    @staticmethod
    def _with_id(rid, out: Dict[str, Any]) -> Dict[str, Any]:
        if rid is not None:
            out.setdefault("id", rid)
        return out

    def _broadcast(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """The op on every healthy replica; all must succeed."""
        results, errors = {}, {}
        for ep in self.endpoints():
            if not ep.healthy:
                continue
            try:
                r = ep.rpc(msg, self.request_timeout_s)
            except Exception as e:  # noqa: BLE001 — typed into the answer
                record_serving_fault(ROUTE_SITE, e)
                self._mark(ep, False, why=f"broadcast: {e}")
                errors[ep.id] = f"{type(e).__name__}: {e}"
                continue
            if r.get("error"):
                errors[ep.id] = r["error"]
            else:
                results[ep.id] = r.get("version")
        if errors:
            return {"error": f"{msg.get('op')} failed on "
                             f"{sorted(errors)}: {errors}",
                    "replicas_ok": sorted(results)}
        versions = sorted(set(v for v in results.values() if v))
        return {"ok": True, "version": versions[-1] if versions else None,
                "replicas": sorted(results)}

    def _forward(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        model = str(msg.get("model", "default"))
        rid = msg.get("id")
        tried: set = set()
        ep = self.route(model)
        for attempt in (0, 1):
            if ep is None:
                return self._with_id(rid, {
                    "error": "NoHealthyReplica: fleet has no healthy "
                             "replica for this request"})
            tried.add(ep.id)
            cur = ep  # the endpoint charged for this attempt
            with self._lock:
                cur.outstanding += 1
            try:
                resp = cur.rpc(msg, self.request_timeout_s)
            except Exception as e:  # noqa: BLE001 — classified below
                # transport loss: classify it (faults_total and
                # serving_faults_total at fleet_route) and decide whether
                # it reads as a dead peer worth one re-route
                record_serving_fault(ROUTE_SITE, e)
                self._mark(cur, False, why=f"{type(e).__name__}: {e}")
                if attempt == 0 and policy.should_reroute(e):
                    self._c_reroutes.inc()
                    trace.instant("fleet_reroute", replica=cur.id,
                                  model=model)
                    ep = self.route(model, exclude=tried)
                    continue
                return self._with_id(rid, {
                    "error": f"ReplicaLost({cur.id}): "
                             f"{type(e).__name__}: {e}"})
            finally:
                with self._lock:
                    cur.outstanding = max(0, cur.outstanding - 1)
            closing = resp.get("shed") == "draining" \
                or "model server is closed" in (resp.get("error") or "")
            if closing and attempt == 0:
                # the replica is leaving cleanly (a drain shed, or a
                # request that slipped into the close after the drain):
                # handled as a loss, with the same one retry
                self._mark(ep, False, draining=True, why="draining")
                self._c_reroutes.inc()
                trace.instant("fleet_reroute", replica=ep.id,
                              model=model, draining=True)
                ep = self.route(model, exclude=tried)
                continue
            self._c_routed.labels(replica=ep.id).inc()
            return resp
        raise AssertionError("unreachable")  # pragma: no cover

    # ------------------------------------------------------------------
    # health probes
    # ------------------------------------------------------------------
    def probe(self, ep: ReplicaEndpoint) -> bool:
        try:
            r = ep.rpc({"op": "ping"}, self.health_deadline_s)
        except Exception as e:  # noqa: BLE001 — a probe that fails is a verdict
            if ep.healthy:  # classify the change, not every probe after it
                record_serving_fault(ROUTE_SITE, e, kind=policy.TRANSIENT)
            self._mark(ep, False, why=f"probe: {type(e).__name__}")
            return False
        healthy = bool(r.get("ok")) and not r.get("draining")
        self._mark(ep, healthy, draining=bool(r.get("draining")),
                   why="probe")
        return healthy

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            for ep in self.endpoints():
                if self._stop.is_set():
                    return
                self.probe(ep)

    def start(self) -> "Router":
        """Start the health-probe thread (idempotent)."""
        if self._prober is None or not self._prober.is_alive():
            self._stop.clear()
            self._prober = threading.Thread(
                target=self._probe_loop, name="xgbtpu-fleet-prober",
                daemon=True)
            self._prober.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for ep in self.endpoints():
            ep.reset()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            reps = [{"replica": ep.id, "address": ep.address(),
                     "healthy": ep.healthy, "draining": ep.draining,
                     "outstanding": ep.outstanding}
                    for ep in sorted(self._eps.values(),
                                     key=lambda e: e.id)]
        return {
            "replicas": reps,
            "reroutes": self._c_reroutes.labels().value,
            "spills": self._c_spills.labels().value,
            "spill_after": self.spill_after,
        }

    # ------------------------------------------------------------------
    # the TCP front
    # ------------------------------------------------------------------
    def serve(self, port: int, host: str = "127.0.0.1", *,
              stdout=None, on_shutdown=None, banner: str = "") -> int:
        """Serve the line protocol until a ``shutdown`` op or
        :meth:`request_shutdown` (``supervisor.serve_fleet_main`` calls it
        on SIGTERM, after draining the replicas). Returns 0."""
        router = self
        stdout = stdout if stdout is not None else sys.stdout

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                for raw in self.rfile:
                    line = raw.decode("utf-8", "replace").strip()
                    if not line:
                        continue
                    try:
                        msg = json.loads(line)
                    except ValueError as e:
                        out = {"error": f"bad json: {e}"}
                    else:
                        out = router.handle(msg, shutdown)
                    try:
                        self.wfile.write((json.dumps(out) + "\n").encode())
                        self.wfile.flush()
                    except OSError:
                        return  # the client went away mid-response

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        tcp = Srv((host, port), Handler)
        self._tcp = tcp

        def shutdown() -> None:
            threading.Thread(target=tcp.shutdown, daemon=True).start()
            if on_shutdown is not None:
                on_shutdown()

        self.start()
        bound_host, bound_port = tcp.server_address[:2]
        print(banner or f"READY fleet router on {bound_host}:{bound_port} "
              f"({len(self.endpoints())} replicas, pid={os.getpid()})",
              file=stdout, flush=True)
        try:
            tcp.serve_forever(poll_interval=0.1)
        except KeyboardInterrupt:
            pass
        finally:
            tcp.server_close()
            self.stop()
        return 0

    def request_shutdown(self) -> None:
        """Stop a running :meth:`serve` from another thread."""
        tcp = self._tcp
        if tcp is not None:
            threading.Thread(target=tcp.shutdown, daemon=True).start()
