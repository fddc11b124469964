"""The port's serving fleet (``xgboost_tpu_torch/serving/fleet/``) against
the JAX package's: ``HashRing`` placement key for key, ``should_reroute``
verdicts, the ``Router`` over two in-process port replicas (answers,
owners, a re-route on the owner's loss), the JAX package's ``Router`` in
front of the port's replicas, the supervisor against a standard-library
stub, ``obs-report`` on a fleet directory, and one ``serve-fleet --device
cpu`` subprocess run with a SIGTERM mid-wave.

Every port comes from ``bind(0)``, every test has its own run directory,
and every wait polls against a deadline. In-process replicas run
``serve_main`` on threads (no SIGTERM handler there), so they stop through
``{"op": "shutdown"}``.
"""

import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xgbt
from xgboost_tpu.observability import fleet as jfleet
from xgboost_tpu.resilience import policy as jpolicy
from xgboost_tpu.serving import fleet as jfl
from xgboost_tpu.serving.fleet import supervisor as jsup
from xgboost_tpu_torch.observability import REGISTRY
from xgboost_tpu_torch.observability import fleet as tfleet
from xgboost_tpu_torch.resilience import chaos, policy
from xgboost_tpu_torch.serving import RequestError
from xgboost_tpu_torch.serving import fleet as tfl
from xgboost_tpu_torch.serving.fleet import supervisor as tsup
from xgboost_tpu_torch.serving.server import serve_main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16}


def _counter(name, **labels):
    fam = REGISTRY.get(name)
    return 0.0 if fam is None else fam.labels(**labels).value


def _train(seed, flip=False):
    X = np.random.RandomState(7).randn(400, 5).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    if flip:
        y = 1.0 - y
    return xgbt.train(dict(PARAMS, seed=seed),
                      xgbt.DMatrix(X, y, device="cpu"), 3), X


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Two models saved as JSON (``m`` and ``m2`` answer differently)."""
    d = tmp_path_factory.mktemp("fleet_models")
    bst, X = _train(seed=1)
    bst2, _ = _train(seed=2, flip=True)
    paths = {"m": str(d / "m.json"), "m2": str(d / "m2.json")}
    bst.save_model(paths["m"])
    bst2.save_model(paths["m2"])
    return {"m": bst, "m2": bst2}, paths, X


# ---------------------------------------------------------------------------
# HashRing and should_reroute against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vnodes", [1, 8, 64])
@pytest.mark.parametrize("replicas", [1, 2, 3, 4, 5])
def test_hashring_places_every_key_as_the_jax_package(replicas, vnodes):
    nodes = [f"r{i}" for i in range(replicas)]
    keys = [f"model-{i}" for i in range(2000)]
    ring = tfl.HashRing(nodes, vnodes=vnodes)
    jring = jfl.HashRing(nodes, vnodes=vnodes)

    def same():
        for k in keys:
            assert ring.lookup(k) == jring.lookup(k), k
            assert list(ring.walk(k)) == list(jring.walk(k)), k

    same()
    before = {k: ring.lookup(k) for k in keys}
    ring.remove(nodes[-1])
    jring.remove(nodes[-1])
    if replicas == 1:
        with pytest.raises(KeyError):
            ring.lookup("m")
        assert list(ring.walk("m")) == list(jring.walk("m")) == []
    else:
        same()
    ring.add(nodes[-1])
    jring.add(nodes[-1])
    same()
    assert {k: ring.lookup(k) for k in keys} == before
    assert ring.nodes() == jring.nodes() and len(ring) == len(jring)


_REROUTE_CASES = {
    "connection_reset": lambda: ConnectionResetError("reset"),
    "connection_refused": lambda: ConnectionRefusedError("refused"),
    "broken_pipe": lambda: BrokenPipeError("pipe"),
    "connection_error": lambda: ConnectionError("closed by peer (r0)"),
    "eof": lambda: EOFError("eof"),
    "timeout": lambda: TimeoutError("timed out"),
    "socket_timeout": lambda: socket.timeout("timed out"),
    "os_error_reset": lambda: OSError("Connection reset by peer"),
    "runtime_worker_lost": lambda: RuntimeError("worker_lost: rank 1"),
    "runtime_heartbeat": lambda: RuntimeError("heartbeat timeout on r1"),
    "chaos_worker_kill": lambda: chaos.ChaosCrash("worker_kill", 1),
    "chaos_heartbeat_drop": lambda: chaos.ChaosTransient("heartbeat_drop",
                                                         2),
    "value_error": lambda: ValueError("bad json"),
    "key_error": lambda: KeyError("m"),
    "runtime_other": lambda: RuntimeError("CUDA out of memory"),
    "request_error": lambda: RequestError("serving_dispatch", "permanent",
                                          "poison row", request_id="q"),
    "chaos_transient": lambda: chaos.ChaosTransient("fleet_route", 1),
}


@pytest.mark.parametrize("case", sorted(_REROUTE_CASES))
def test_should_reroute_gives_the_jax_packages_verdict(case):
    exc = _REROUTE_CASES[case]()
    assert policy.should_reroute(exc) == jpolicy.should_reroute(exc)


def test_should_reroute_verdicts():
    assert policy.should_reroute(ConnectionResetError())
    assert policy.should_reroute(EOFError())
    assert policy.should_reroute(RuntimeError("Broken pipe"))
    assert not policy.should_reroute(ValueError("bad json"))
    assert not policy.should_reroute(
        RequestError("serving_dispatch", "permanent", "poison row"))


# ---------------------------------------------------------------------------
# in-process replicas behind the router
# ---------------------------------------------------------------------------


class _ReadySink(io.StringIO):
    """A replica's stdout: notes the port of its READY line."""

    def __init__(self):
        super().__init__()
        self.port = None
        self.ready = threading.Event()

    def write(self, s):
        m = re.search(r"READY serving on [^:\s]+:(\d+)", s)
        if m:
            self.port = int(m.group(1))
            self.ready.set()
        return super().write(s)


def _rpc(port, msg, timeout=30):
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as c:
        c.sendall((json.dumps(msg) + "\n").encode())
        return json.loads(c.makefile("rb").readline())


class _Replicas:
    """``n`` port replicas on threads (``serve_main --port 0 --device
    cpu``), each with its own run directory under ``root`` and one shared
    manifest."""

    def __init__(self, root, paths, n=2):
        self.ports, self.threads = {}, []
        manifest = str(root / "manifest.json")
        for k in range(n):
            sink = _ReadySink()
            argv = ["--port", "0", "--device", "cpu",
                    "--run-dir", str(root / f"replica{k}"),
                    "--manifest", manifest]
            for name, path in sorted(paths.items()):
                argv += ["--model", f"{name}={path}"]
            t = threading.Thread(target=serve_main, args=(argv,),
                                 kwargs={"stdout": sink}, daemon=True)
            t.start()
            assert sink.ready.wait(60), f"replica {k} never READY"
            self.ports[f"r{k}"] = sink.port
            self.threads.append(t)

    def endpoints(self, cls):
        return [cls(rid, "127.0.0.1", p)
                for rid, p in sorted(self.ports.items())]

    def shutdown(self, rid):
        try:
            _rpc(self.ports[rid], {"op": "shutdown"}, timeout=10)
        except OSError:
            pass

    def close(self):
        for rid in self.ports:
            self.shutdown(rid)
        for t in self.threads:
            t.join(60)


def _bits(bst, rows):
    return np.asarray(bst.inplace_predict(rows), np.float32).astype(
        np.float64)


def test_router_answers_places_and_reroutes(models, tmp_path):
    """Answers == the port's ``inplace_predict`` bit for bit and the JAX
    package's within 1e-5; every model's owner == the JAX package's
    ``Router`` over the same endpoints; the owner's shutdown re-routes
    its next request, its health gauge 0, the survivor's 1."""
    import xgboost_tpu as jxgb

    bsts, paths, X = models
    reps = _Replicas(tmp_path, paths)
    # no probe thread: the loss must show through the request itself
    router = tfl.Router(reps.endpoints(tfl.ReplicaEndpoint))
    jrouter = jfl.Router(reps.endpoints(jfl.ReplicaEndpoint))
    try:
        for name in ("m", "m2"):
            jb = jxgb.Booster(model_file=paths[name])
            for i, (lo, n) in enumerate(((0, 1), (5, 7), (100, 33))):
                r = router.handle({"op": "predict", "id": f"{name}-{i}",
                                   "model": name, "tenant": "t",
                                   "data": X[lo:lo + n].tolist()})
                assert r["id"] == f"{name}-{i}"
                got = np.asarray(r["result"], np.float64)
                assert np.array_equal(got, _bits(bsts[name], X[lo:lo + n]))
                np.testing.assert_allclose(
                    got, np.asarray(jb.inplace_predict(X[lo:lo + n])),
                    rtol=0, atol=1e-5)
        for key in ["m", "m2"] + [f"model-{i}" for i in range(50)]:
            assert router.route(key).id == jrouter.route(key).id, key
        owner = router.route("m").id
        survivor = next(rid for rid in reps.ports if rid != owner)
        rr0 = _counter("fleet_reroutes_total")
        reps.shutdown(owner)
        deadline = time.monotonic() + 30
        while True:  # the owner's port closes once its drain is done
            try:
                socket.create_connection(
                    ("127.0.0.1", reps.ports[owner]), timeout=1).close()
            except OSError:
                break
            assert time.monotonic() < deadline, "owner never went away"
            time.sleep(0.05)
        r = router.handle({"op": "predict", "id": "after-loss",
                           "model": "m", "data": X[:4].tolist()})
        assert np.array_equal(np.asarray(r["result"], np.float64),
                              _bits(bsts["m"], X[:4])), r
        assert _counter("fleet_reroutes_total") - rr0 == 1
        assert _counter("fleet_replica_healthy", replica=owner) == 0
        assert router.route("m").id == survivor
        assert _counter("fleet_replica_healthy", replica=survivor) == 1
        r = router.handle({"op": "stats"})
        assert {x["replica"]: x["healthy"]
                for x in r["stats"]["replicas"]} == {owner: False,
                                                     survivor: True}
        router.mark_down(survivor, why="test")
        r = router.handle({"op": "predict", "id": "none-left", "model": "m",
                           "data": X[:1].tolist()})
        assert r["id"] == "none-left"
        assert r["error"].startswith("NoHealthyReplica"), r
    finally:
        router.stop()
        jrouter.stop()
        reps.close()


def test_router_reroutes_a_request_in_flight_on_transport_loss(models,
                                                               tmp_path):
    """A request whose replica connection breaks is re-routed once to the
    other replica (``fleet_reroutes_total`` + 1, the owner marked down at
    once, the answer the survivor's); a broadcast ``load`` reaches both
    replicas."""
    bsts, paths, X = models
    reps = _Replicas(tmp_path, paths)
    router = tfl.Router(reps.endpoints(tfl.ReplicaEndpoint),
                        health_interval_s=30)
    try:
        owner = router.route("m").id
        ep = next(e for e in router.endpoints() if e.id == owner)
        real = ep.rpc

        def lost(msg, timeout):
            ep.rpc = real
            raise ConnectionResetError("Connection reset by peer")

        ep.rpc = lost
        rr0 = _counter("fleet_reroutes_total")
        routed0 = _counter("fleet_routed_requests_total",
                           replica=next(r for r in reps.ports if r != owner))
        r = router.handle({"op": "predict", "id": "q", "model": "m",
                           "data": X[:3].tolist()})
        assert np.array_equal(np.asarray(r["result"], np.float64),
                              _bits(bsts["m"], X[:3]))
        assert _counter("fleet_reroutes_total") - rr0 == 1
        assert _counter("fleet_replica_healthy", replica=owner) == 0
        assert _counter("fleet_routed_requests_total", replica=next(
            r for r in reps.ports if r != owner)) - routed0 == 1
        assert router.probe(ep) and _counter("fleet_replica_healthy",
                                             replica=owner) == 1
        r = router.handle({"op": "load", "id": "l", "model": "m3",
                           "path": paths["m2"]})
        assert r == {"ok": True, "version": "m3@v1",
                     "replicas": sorted(reps.ports), "id": "l"}
        for rid, port in reps.ports.items():
            got = _rpc(port, {"op": "predict", "model": "m3",
                              "data": X[:2].tolist()})
            assert np.array_equal(np.asarray(got["result"], np.float64),
                                  _bits(bsts["m2"], X[:2])), rid
        assert "fleet_reroutes_total" in router.handle(
            {"op": "metrics"})["metrics"]
    finally:
        router.stop()
        reps.close()


def test_jax_router_in_front_of_port_replicas(models, tmp_path):
    """The line protocol across packages: the JAX package's ``Router``
    forwards to the port's replicas and gets the port's answers."""
    bsts, paths, X = models
    reps = _Replicas(tmp_path, paths)
    jrouter = jfl.Router(reps.endpoints(jfl.ReplicaEndpoint))
    try:
        for name in ("m", "m2"):
            for lo, n in ((0, 1), (40, 25)):
                r = jrouter.handle({"op": "predict", "id": "j",
                                    "model": name,
                                    "data": X[lo:lo + n].tolist()})
                assert r["id"] == "j"
                assert np.array_equal(np.asarray(r["result"], np.float64),
                                      _bits(bsts[name], X[lo:lo + n]))
    finally:
        jrouter.stop()
        reps.close()


def test_obs_report_folds_in_the_replicas(models, tmp_path, capsys):
    """``collect`` on a fleet directory gives the JAX package's members
    (ranks, paths, titles), replicas after the training ranks; the
    port's ``obs-report`` rolls both replicas up."""
    bsts, paths, X = models
    reps = _Replicas(tmp_path, paths)
    try:
        for rid, port in reps.ports.items():
            _rpc(port, {"op": "predict", "model": "m",
                        "data": X[:2].tolist()})
    finally:
        reps.close()
    got = [(r.rank, r.path, r.title) for r in tfleet.collect(str(tmp_path))]
    want = [(r.rank, r.path, r.title) for r in jfleet.collect(str(tmp_path))]
    assert got == want and [g[2] for g in got] == ["replica0", "replica1"]
    assert [g[0] for g in got] == [0, 1]
    # beside two training ranks, the replicas take pids 2 and 3
    for k in (0, 1):
        d = tmp_path / "obs" / f"rank{k}"
        d.mkdir(parents=True)
        (d / "flight.jsonl").write_text(json.dumps({"t": "meta"}) + "\n")
    got = [(r.rank, r.title) for r in tfleet.collect(str(tmp_path))]
    assert got == [(r.rank, r.title) for r in jfleet.collect(str(tmp_path))]
    assert got == [(0, "rank 0"), (1, "rank 1"), (2, "replica0"),
                   (3, "replica1")]
    assert tfleet.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "4 rank(s)" in out and "replica0" in out and "replica1" in out


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------


def _stub(tmp_path, body):
    path = tmp_path / "stub.py"
    path.write_text(body)
    return lambda rid, port: [sys.executable, str(path), str(port), str(rid)]


_READY_STUB = ("import sys, time\n"
               "print(f'READY stub on 127.0.0.1:{sys.argv[1]}', flush=True)\n"
               "time.sleep(600)\n")


def _fleet_state(run_dir):
    with open(os.path.join(run_dir, "fleet.json")) as f:
        return json.load(f)


def test_supervisor_respawns_and_scales(tmp_path):
    sup = tsup.FleetSupervisor(str(tmp_path), replicas=2,
                               spawn_cmd=_stub(tmp_path, _READY_STUB),
                               ready_timeout_s=30)
    r0 = _counter("fleet_replica_restarts_total")
    sup.start()
    try:
        st = _fleet_state(tmp_path)
        assert st["format"] == "xgbtpu-fleet-v1" and st["target"] == 2
        assert [r["replica"] for r in st["replicas"]] == ["r0", "r1"]
        assert all(r["alive"] for r in st["replicas"])
        assert all(0 < r["ready_s"] < 30 for r in st["replicas"])
        assert _counter("fleet_replicas") == 2
        pid0 = st["replicas"][0]["pid"]
        os.kill(pid0, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while True:
            rep = _fleet_state(tmp_path)["replicas"][0]
            if rep["pid"] != pid0 and rep["alive"] \
                    and rep["generation"] == 1:
                break
            assert time.monotonic() < deadline, f"no respawn: {rep}"
            time.sleep(0.05)
        assert _counter("fleet_replica_restarts_total") - r0 == 1
        sup.scale(1, drain_timeout_s=1)  # the stub ignores nothing: killed
        st = _fleet_state(tmp_path)
        assert len(st["replicas"]) == 1 and st["target"] == 1
        sup.scale(2)
        st = _fleet_state(tmp_path)
        assert [r["replica"] for r in st["replicas"]] == ["r0", "r1"]
        assert st["replicas"][1]["generation"] == 0
    finally:
        sup.stop(drain_timeout_s=1)
    assert all(not r["alive"] for r in _fleet_state(tmp_path)["replicas"])


def test_supervisor_raises_at_once_when_a_child_dies_before_ready(
        tmp_path):
    """A child that exits before READY raises within seconds (not after
    ``ready_timeout_s``), naming the replica and its log; ``start`` stops
    the replicas already up."""
    dying = ("import sys\n"
             "if sys.argv[2] == '1':\n"
             "    print('no card here', flush=True)\n"
             "    sys.exit(3)\n" + _READY_STUB)
    sup = tsup.FleetSupervisor(str(tmp_path), replicas=2,
                               spawn_cmd=_stub(tmp_path, dying),
                               ready_timeout_s=180)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as exc:
        sup.start()
    assert time.monotonic() - t0 < 20
    log = str(tmp_path / "replica1" / "serve.log")
    assert "replica 1 not READY" in str(exc.value) and log in str(exc.value)
    assert "code 3" in str(exc.value)
    with open(log) as f:
        assert "no card here" in f.read()
    st = _fleet_state(tmp_path)
    assert [r["replica"] for r in st["replicas"]] == ["r0"]
    assert not st["replicas"][0]["alive"]


def test_serve_fleet_reports_a_replica_that_cannot_start(tmp_path, capsys):
    """``serve-fleet`` on replicas that die before READY (an unknown
    option here) exits 1 at once with the supervisor's error."""
    t0 = time.monotonic()
    rc = tsup.serve_fleet_main(
        ["--port", "0", "--run-dir", str(tmp_path), "--replicas", "1",
         "--device", "cpu", "--batch-wait-us", "not-a-number"])
    assert rc == 1 and time.monotonic() - t0 < 60
    err = capsys.readouterr().err
    assert "replica 0 not READY" in err and "serve.log" in err
    with open(tmp_path / "replica0" / "serve.log") as f:
        assert "serve: invalid literal" in f.read()


def test_default_command_is_the_ports_serve(tmp_path):
    """``_default_cmd`` is the JAX package's with ``-m xgboost_tpu_torch``,
    passes ``--device`` on, and drops ``--model`` once the manifest
    exists."""
    opts = tsup._parse_fleet_args(
        ["--port", "7", "--run-dir", str(tmp_path), "--replicas", "3",
         "--model", "m=/x/m.json", "--device", "cpu",
         "--batch-wait-us", "500", "--arena-mb", "64", "--max-queue", "9"])
    assert opts["serve_args"] == ["--device", "cpu", "--batch-wait-us",
                                  "500", "--arena-mb", "64",
                                  "--max-queue", "9"]
    assert opts["replicas"] == 3 and opts["models"] == {"m": "/x/m.json"}
    jopts = jsup._parse_fleet_args(
        ["--port", "7", "--run-dir", str(tmp_path), "--model", "m=/x/m.json",
         "--batch-wait-us", "500"])
    with pytest.raises(ValueError):
        jsup._parse_fleet_args(["--port", "7", "--run-dir", "d",
                                "--device", "cpu"])
    for bad in (["--run-dir", "d"], ["--port", "1"], ["--model", "m"],
                ["--port", "1", "--run-dir", "d", "--nope", "1"]):
        with pytest.raises(ValueError):
            tsup._parse_fleet_args(bad)
    sup = tsup.FleetSupervisor(str(tmp_path), models=opts["models"],
                               serve_args=opts["serve_args"])
    jsv = jsup.FleetSupervisor(str(tmp_path), models=jopts["models"],
                               serve_args=jopts["serve_args"])
    cmd = sup._default_cmd(1, 4242)
    assert cmd[:4] == [sys.executable, "-m", "xgboost_tpu_torch", "serve"]
    jcmd = jsv._default_cmd(1, 4242)
    assert jcmd[:4] == [sys.executable, "-m", "xgboost_tpu", "serve"]
    drop = ["--device", "cpu", "--arena-mb", "64", "--max-queue", "9"]
    assert [a for a in cmd[4:] if a not in drop] \
        == [a for a in jcmd[4:]]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[-2:] == ["--model", "m=/x/m.json"]
    (tmp_path / "manifest.json").write_text("{}")
    cmd = sup._default_cmd(0, 4242)
    assert "--model" not in cmd
    assert cmd[cmd.index("--manifest") + 1] == str(tmp_path / "manifest.json")
    assert cmd[cmd.index("--run-dir") + 1] == str(tmp_path / "replica0")
    assert sup.target == 2  # XGBTPU_REPLICAS's default


# ---------------------------------------------------------------------------
# serve-fleet end to end, in subprocesses on the CPU
# ---------------------------------------------------------------------------


class _Lines:
    """A process's stdout read on a thread, lines kept in order."""

    def __init__(self, stream):
        self.lines = []
        self._cv = threading.Condition()
        threading.Thread(target=self._pump, args=(stream,),
                         daemon=True).start()

    def _pump(self, stream):
        for line in stream:
            with self._cv:
                self.lines.append(line)
                self._cv.notify_all()

    def wait_for(self, prefix, timeout):
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                for ln in self.lines:
                    if ln.startswith(prefix):
                        return ln
                left = deadline - time.monotonic()
                assert left > 0, f"no {prefix!r} line: {self.lines}"
                self._cv.wait(left)


def _poll(fn, timeout, what):
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if got:
            return got
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().split(b"\0")
    except OSError:
        return None


def test_serve_fleet_end_to_end_on_the_cpu(models, tmp_path):
    """``python -m xgboost_tpu_torch serve-fleet --device cpu --replicas
    2``: the hash owner of ``m`` SIGTERMed mid-wave loses no request,
    every answer keeps its bits, the supervisor respawns it (a new pid,
    generation 1, no ``--model``), and the respawn serves both models from
    the manifest alone; SIGTERM to the fleet exits 0 with no replica
    left."""
    bsts, paths, X = models
    run = tmp_path / "fleet"
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XGBTPU_ROUTER_HEALTH_S="0.2",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "xgboost_tpu_torch", "serve-fleet",
         "--port", str(port), "--replicas", "2", "--run-dir", str(run),
         "--model", f"m={paths['m']}", "--model", f"m2={paths['m2']}",
         "--batch-wait-us", "200", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    out = _Lines(proc.stdout)
    pids = []
    try:
        banner = out.wait_for("READY fleet", 90)
        assert f"pid={proc.pid}" in banner
        st = _fleet_state(run)
        assert [r["replica"] for r in st["replicas"]] == ["r0", "r1"]
        assert all(r["alive"] for r in st["replicas"])
        pids = [r["pid"] for r in st["replicas"]]
        owner = tfl.HashRing(["r0", "r1"]).lookup("m")
        k = int(owner[1:])
        old_pid = st["replicas"][k]["pid"]

        answers, errors, sent = {}, [], [0]
        stop = threading.Event()
        lock = threading.Lock()

        def client(t):
            rng = np.random.RandomState(t)
            try:
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=60) as c:
                    rf = c.makefile("rb")
                    i = 0
                    while not stop.is_set() or i < 20:
                        name = ("m", "m2")[i % 2]
                        lo, n = int(rng.randint(0, 380)), int(
                            rng.randint(1, 20))
                        c.sendall((json.dumps(
                            {"op": "predict", "id": f"{t}-{i}",
                             "model": name,
                             "data": X[lo:lo + n].tolist()}) + "\n").encode())
                        r = json.loads(rf.readline())
                        with lock:
                            answers[f"{t}-{i}"] = (name, lo, n, r)
                            sent[0] += 1
                        i += 1
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        _poll(lambda: sent[0] >= 40, 60, "the wave never started")
        os.kill(old_pid, signal.SIGTERM)

        def respawned():
            rep = _fleet_state(run)["replicas"][k]
            return rep if (rep["pid"] != old_pid and rep["alive"]
                           and rep["generation"] >= 1) else None

        rep = _poll(respawned, 60, "the owner was not respawned")
        at_respawn = sent[0]
        _poll(lambda: sent[0] >= at_respawn + 40, 60,
              "no traffic after the respawn")
        stop.set()
        for t in threads:
            t.join(60)
        assert not errors, errors
        assert len(answers) == sent[0] >= 120
        for rid, (name, lo, n, r) in answers.items():
            assert r.get("id") == rid and "result" in r, r
            assert np.array_equal(np.asarray(r["result"], np.float64),
                                  _bits(bsts[name], X[lo:lo + n])), rid
        pids.append(rep["pid"])
        # the respawn was given no model: both come from the manifest
        argv = _cmdline(rep["pid"])
        assert argv is not None and b"--model" not in argv, argv
        for name in ("m", "m2"):
            r = _rpc(rep["port"], {"op": "predict", "model": name,
                                   "data": X[:5].tolist()})
            assert np.array_equal(np.asarray(r["result"], np.float64),
                                  _bits(bsts[name], X[:5])), r
        stats = _rpc(port, {"op": "stats"})["stats"]
        assert {r["replica"] for r in stats["replicas"]} == {"r0", "r1"}
        metrics = _rpc(port, {"op": "metrics"})["metrics"]
        assert "fleet_replica_restarts_total 1" in metrics, metrics
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
    for pid in pids:
        _poll(lambda: _cmdline(pid) in (None, [b""]), 30,
              f"replica {pid} outlived the fleet")
    st = _fleet_state(run)
    assert all(not r["alive"] for r in st["replicas"])
