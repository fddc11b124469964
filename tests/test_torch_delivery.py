"""Continuous train-to-serve delivery in the port (``xgboost_tpu_torch/
serving/delivery.py``): arena pinning, a fractional canary that promotes,
a corrupt checkpoint skipped, a shadow canary rejected by the AUC gate
and discarded, a post-promotion breaker trip rolled back and quarantined
(across a restart), the deterministic SLO gates, the protocol's delivery
ops and the ``deliver`` command line, shadow failures kept off the live
fault plane, the watcher's steady state, and quarantined version numbers.

Checkpoints come from the port's ``train(resume_from=...)`` (3 rounds,
then 2 appended). The controller is driven by hand (``poll()``) where it
can be, with live traffic from a thread; every wait is bounded.
"""

import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch.observability import REGISTRY
from xgboost_tpu_torch.resilience import checkpoint as ckpt
from xgboost_tpu_torch.serving import (
    CanaryState, DeliveryController, ModelRegistry, ModelServer,
    RequestError, RequestShed,
)
from xgboost_tpu_torch.serving import faults

torch.set_num_threads(1)

PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16,
          "seed": 5}


def _counter(name, **labels):
    fam = REGISTRY.get(name)
    return 0.0 if fam is None else fam.labels(**labels).value


def _data(n=400, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    X, y = _data()
    base = str(tmp_path_factory.mktemp("ckpts"))
    d = xgbt.DMatrix(X, y, device="cpu")
    xgbt.train(PARAMS, d, 3, resume_from=base, verbose_eval=False)
    raw3 = open(ckpt.checkpoint_path(base, 3), "rb").read()
    model3 = ckpt.read_checkpoint(ckpt.checkpoint_path(base, 3))[0]
    bst5 = xgbt.train(PARAMS, d, 2, resume_from=base, resume_mode="append",
                      verbose_eval=False)
    raw5 = open(ckpt.checkpoint_path(base, 5), "rb").read()
    return {"X": X, "y": y, "raw3": raw3, "raw5": raw5, "bst5": bst5,
            "model3": model3}


def _write_ckpt(watch_dir, raw, rounds):
    path = ckpt.checkpoint_path(watch_dir, rounds)
    ckpt.atomic_write_bytes(path, raw)
    return path


def _server(tmp_path, setup, **kw):
    watch = str(tmp_path / "watch")
    os.makedirs(watch, exist_ok=True)
    _write_ckpt(watch, setup["raw3"], 3)
    srv = ModelServer({"m": ckpt.checkpoint_path(watch, 3)},
                      run_dir=str(tmp_path / "srv"), batch_wait_us=0,
                      device="cpu", **kw)
    return srv, watch


class _Traffic:
    """Live requests from a thread until stopped; every request must
    resolve (ok or a typed error): an unanswered one is a dropped
    request."""

    def __init__(self, srv, X, rows=4):
        self.srv, self.X, self.rows = srv, X, rows
        self.stop = threading.Event()
        self.ok, self.failed, self.dropped = [], [], []
        self._t = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self._t.join(30)

    def _run(self):
        i = 0
        while not self.stop.is_set():
            i += 1
            off = (i * 7) % 300
            try:
                out = self.srv.predict("m", self.X[off:off + self.rows],
                                       timeout=30, request_id=f"r{i}")
                self.ok.append((off, out))
            except TimeoutError:
                self.dropped.append(i)
            except Exception as e:  # noqa: BLE001 — collected
                self.failed.append(e)
            self.stop.wait(0.001)


def _until(predicate, timeout=60):
    """Bounded wait on a condition another thread makes true."""
    ev = threading.Event()
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            return False
        ev.wait(0.01)
    return True


def _events(srv):
    return [r["name"] for r in srv.obs.records() if r.get("t") == "event"]


def test_pinned_entry_survives_lru_eviction(setup):
    reg = ModelRegistry(arena_mb=1e-5, device="cpu")
    raw = setup["model3"]
    reg.load("a", raw)
    reg.pin("a", 1, True)
    reg.load("b", raw)
    assert "a@v1" in reg.resident()
    reg.pin("a", 1, False)
    reg.load("c", raw)
    assert "a@v1" not in reg.resident()


def test_fraction_canary_promotes(setup, tmp_path):
    X, y = setup["X"], setup["y"]
    srv, watch = _server(tmp_path, setup)
    try:
        assert srv.registry.live_version("m") == 1
        ctl = DeliveryController(
            srv, "m", watch, mode="fraction", fraction=0.5, min_requests=6,
            poll_s=0.02, bake_s=0.05, eval_data=(X[:200], y[:200]),
            canary_deadline_s=60, p99_ratio=10.0)
        p0 = _counter("delivery_promotions_total")
        _write_ckpt(watch, setup["raw5"], 5)
        with _Traffic(srv, X) as tr:
            assert ctl.poll() == "promoted"
        assert srv.registry.live_version("m") == 2
        assert _counter("delivery_promotions_total") == p0 + 1
        assert not tr.dropped and not tr.failed
        np.testing.assert_array_equal(srv.predict("m", X[:8], timeout=30),
                                      setup["bst5"].inplace_predict(X[:8]))
        events = _events(srv)
        for name in ("checkpoint_seen", "model_published", "canary_start",
                     "model_promoted"):
            assert name in events, (name, events)
        assert not any(e.pinned for e in srv.registry._entries.values())
        assert ctl.status()["history"][-1]["version"] == 2
        assert ctl.poll() is None  # nothing new
    finally:
        srv.close()


def test_corrupt_checkpoint_skipped_old_version_serves(setup, tmp_path):
    X = setup["X"]
    srv, watch = _server(tmp_path, setup)
    try:
        ctl = DeliveryController(srv, "m", watch, mode="fraction",
                                 fraction=0.5, min_requests=4, poll_s=0.02,
                                 bake_s=0.05, canary_deadline_s=30,
                                 p99_ratio=10.0)
        s0 = _counter("delivery_checkpoints_skipped_total", reason="corrupt")
        _write_ckpt(watch, setup["raw5"][:-20], 5)  # torn
        assert ctl.poll() is None
        assert ctl.poll() is None  # not counted twice
        assert _counter("delivery_checkpoints_skipped_total",
                        reason="corrupt") == s0 + 1
        assert srv.registry.live_version("m") == 1
        assert srv.predict("m", X[:4], timeout=30).shape == (4,)
        assert "checkpoint_skipped" in _events(srv)
        _write_ckpt(watch, setup["raw5"], 5)
        with _Traffic(srv, X):
            assert ctl.poll() == "promoted"
        assert srv.registry.live_version("m") == 2
    finally:
        srv.close()


def test_shadow_canary_gate_rejects_bad_model(setup, tmp_path):
    X, y = setup["X"], setup["y"]
    srv, watch = _server(tmp_path, setup)
    try:
        bad = xgbt.train(dict(PARAMS, seed=9),
                         xgbt.DMatrix(X, 1.0 - y, device="cpu"), 5)
        incumbent = xgbt.Booster(model_file=setup["model3"], device="cpu")
        fleet = []
        ctl = DeliveryController(
            srv, "m", watch, mode="shadow", fraction=1.0, min_requests=5,
            poll_s=0.02, bake_s=0.05, eval_data=(X[:200], y[:200]),
            canary_deadline_s=60, p99_ratio=10.0,
            broadcast=lambda msg: fleet.append(dict(msg)) or {"ok": True})
        d0 = _counter("delivery_canary_diffs_total")
        ckpt.save_checkpoint(watch, bad, 9)
        with _Traffic(srv, X) as tr:
            assert ctl.poll() == "rejected"
        st = ctl.status()
        assert "auc" in st["history"][-1]["detail"]["reasons"]
        assert srv.registry.live_version("m") == 1
        assert _counter("delivery_canary_rejected_total", reason="auc") >= 1
        assert not tr.dropped and not tr.failed
        for off, out in tr.ok[:20]:  # live answers are the incumbent's
            np.testing.assert_array_equal(
                out, incumbent.inplace_predict(X[off:off + 4]))
        assert _counter("delivery_canary_diffs_total") > d0
        assert "model_discarded" in _events(srv)
        assert ("m", 2) not in srv.registry.sources_snapshot()
        doc = json.load(open(str(tmp_path / "srv" / "manifest.json")))
        assert "2" not in doc["models"]["m"]["versions"]
        spill = str(tmp_path / "srv" / "models" / "m@v2.json")
        assert not os.path.exists(spill)
        by_op = {m["op"]: m for m in fleet}
        assert by_op["load"]["path"] == spill and by_op["load"]["live"] is False
        assert by_op["unload"]["version"] == 2
    finally:
        srv.close()


def test_breaker_trip_rolls_back_and_quarantines(setup, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("XGBTPU_BREAKER_MIN", "4")
    monkeypatch.setenv("XGBTPU_BREAKER_WINDOW", "8")
    X, y = setup["X"], setup["y"]
    srv, watch = _server(tmp_path, setup)
    try:
        ctl = DeliveryController(
            srv, "m", watch, mode="fraction", fraction=0.5, min_requests=5,
            poll_s=0.02, bake_s=30.0, eval_data=(X[:200], y[:200]),
            canary_deadline_s=60, p99_ratio=10.0)
        r0 = _counter("delivery_rollbacks_total")
        outcome = []
        _write_ckpt(watch, setup["raw5"], 5)
        with _Traffic(srv, X) as tr:
            t = threading.Thread(target=lambda: outcome.append(ctl.poll()))
            t.start()
            assert _until(lambda: srv.registry.live_version("m") == 2)
            monkeypatch.setenv("XGBTPU_CHAOS_MODEL", "m@v2")  # regression
            t.join(60)
            monkeypatch.delenv("XGBTPU_CHAOS_MODEL")
        assert outcome == ["rolled_back"]
        assert srv.registry.live_version("m") == 1
        assert _counter("delivery_rollbacks_total") == r0 + 1
        assert srv.quarantined_versions("m")[2]["rounds"] == 5
        assert not tr.dropped
        assert all(isinstance(e, (RequestError, RequestShed))
                   for e in tr.failed), tr.failed
        assert srv.predict("m", X[:4], timeout=30).shape == (4,)
        for name in ("model_rolled_back", "model_quarantined"):
            assert name in _events(srv)
        with pytest.raises(KeyError):
            srv.registry.get("m", 2)
    finally:
        srv.close()
    srv2 = ModelServer(run_dir=str(tmp_path / "srv"), batch_wait_us=0,
                       device="cpu")
    try:
        assert srv2.registry.live_version("m") == 1
        assert 2 in srv2.quarantined_versions("m")
        with pytest.raises(KeyError):
            srv2.registry.get("m", 2)
        q0 = _counter("delivery_checkpoints_skipped_total",
                      reason="quarantined")
        ctl2 = DeliveryController(srv2, "m", watch, from_rounds=3,
                                  poll_s=0.02, bake_s=0.05)
        assert ctl2.poll() is None
        assert _counter("delivery_checkpoints_skipped_total",
                        reason="quarantined") == q0 + 1
        assert srv2.registry.live_version("m") == 1
    finally:
        srv2.close()


def test_gate_p99_and_error_rate_deterministic(setup, tmp_path):
    srv, watch = _server(tmp_path, setup)
    try:
        ctl = DeliveryController(srv, "tgate", watch, from_rounds=0,
                                 min_requests=4, p99_ratio=1.25,
                                 poll_s=0.02, bake_s=0.05)
        fam = REGISTRY.histogram("predict_latency_seconds")
        for _ in range(50):
            fam.labels(model="tgate@v1").observe(0.001)
            fam.labels(model="tgate@v2").observe(0.1)
            fam.labels(model="tgate@v3").observe(0.001)
            fam.labels(model="tgate@v4").observe(0.001)
        verdicts = []
        for version, cand_ok in ((2, lambda i: True), (3, lambda i: i % 2),
                                 (4, lambda i: True)):
            state = CanaryState("tgate", version, 1, mode="fraction",
                                fraction=0.5)
            for i in range(10):
                state.observe("candidate", bool(cand_ok(i)))
                state.observe("incumbent", True)
            verdicts.append(ctl._gate(state))
        assert verdicts[0][0] is False
        assert verdicts[0][1]["reasons"] == ["p99"]
        assert verdicts[1][0] is False
        assert "error_rate" in verdicts[1][1]["reasons"]
        assert verdicts[2][0] is True, verdicts[2][1]
    finally:
        srv.close()


def test_protocol_delivery_ops(setup, tmp_path):
    from xgboost_tpu_torch.serving.server import _handle

    srv, watch = _server(tmp_path, setup)
    noop = lambda: None  # noqa: E731
    try:
        out = _handle(srv, {"op": "deliver", "action": "status", "id": 1},
                      noop)
        assert out["ok"] and out["delivery"] == {} and out["id"] == 1
        p5 = _write_ckpt(watch, setup["raw5"], 5)
        out = _handle(srv, {"op": "load", "model": "m", "path": p5,
                            "version": 2, "live": False}, noop)
        assert out["ok"] and out["version"] == "m@v2"
        assert srv.registry.live_version("m") == 1
        out = _handle(srv, {"op": "promote", "model": "m", "version": 2},
                      noop)
        assert out["ok"] and srv.registry.live_version("m") == 2
        out = _handle(srv, {"op": "rollback", "model": "m", "version": 1},
                      noop)
        assert out["ok"] and srv.registry.live_version("m") == 1
        out = _handle(srv, {"op": "quarantine", "model": "m", "version": 2,
                            "rounds": 5}, noop)
        assert out["ok"] and srv.quarantined_versions("m")[2]["rounds"] == 5
        out = _handle(srv, {"op": "promote", "model": "m", "version": 2},
                      noop)
        assert "quarantined" in out["error"]
        out = _handle(srv, {"op": "deliver", "model": "m", "watch": watch,
                            "min_requests": 4, "poll_s": 0.05}, noop)
        assert out["ok"] and "m" in srv.delivery_status()
        out = _handle(srv, {"op": "deliver", "action": "stop",
                            "model": "m"}, noop)
        assert out["ok"] and srv.delivery_status() == {}
    finally:
        srv.close()


def test_deliver_command_line_against_a_socket_server(setup, tmp_path,
                                                      capsys):
    """``serve --port 0`` in a thread and the ``deliver`` client over
    localhost: status, start, stop; then the protocol's ``shutdown``."""
    import socket

    from xgboost_tpu_torch.cli import cli_main
    from xgboost_tpu_torch.serving.server import serve_main

    watch = str(tmp_path / "watch")
    os.makedirs(watch)
    p3 = _write_ckpt(watch, setup["raw3"], 3)
    out = io.StringIO()
    rc = []
    t = threading.Thread(target=lambda: rc.append(serve_main(
        ["--port", "0", "--device", "cpu", "--model", f"m={p3}"],
        stdout=out)))
    t.start()
    assert _until(lambda: "READY" in out.getvalue())
    port = int(out.getvalue().split("127.0.0.1:")[1].split()[0])
    addr = f"127.0.0.1:{port}"
    try:
        assert cli_main(["deliver", "--connect", addr, "--status"]) == 0
        assert json.loads(capsys.readouterr().out)["delivery"] == {}
        assert cli_main(["deliver", "--connect", addr, "--model", "m",
                         "--watch", watch, "--poll-s", "0.05"]) == 0
        assert json.loads(capsys.readouterr().out)["ok"] is True
        assert cli_main(["deliver", "--connect", addr, "--status"]) == 0
        status = json.loads(capsys.readouterr().out)["delivery"]
        assert status["m"]["processed_rounds"] == 3
        assert cli_main(["deliver", "--connect", addr, "--stop",
                         "--model", "m"]) == 0
        capsys.readouterr()
        assert cli_main(["deliver", "--status"]) == 1  # no --connect
    finally:
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            s.sendall(b'{"op": "shutdown"}\n')
            s.makefile().readline()
        t.join(60)
    assert rc == [0]


def test_shadow_failures_never_shed_live_traffic(setup, tmp_path,
                                                 monkeypatch):
    X = setup["X"]
    srv, watch = _server(tmp_path, setup)
    try:
        monkeypatch.setenv("XGBTPU_CHAOS_MODEL", "m@v2")
        ctl = DeliveryController(srv, "m", watch, mode="shadow",
                                 fraction=1.0, min_requests=5, poll_s=0.02,
                                 bake_s=0.05, canary_deadline_s=60,
                                 p99_ratio=10.0)
        _write_ckpt(watch, setup["raw5"], 5)
        with _Traffic(srv, X) as tr:
            assert ctl.poll() == "rejected"
        detail = ctl.status()["history"][-1]["detail"]
        assert "error_rate" in detail["reasons"]
        assert srv.faults.breaker("m").state == faults.CLOSED
        assert srv.registry.live_version("m") == 1
        assert not tr.dropped and not tr.failed
    finally:
        srv.close()


def test_watch_steady_state_costs_no_file_io(setup, tmp_path, monkeypatch):
    assert ckpt.path_rounds(ckpt.checkpoint_path("/x", 3)) == 3
    assert ckpt.path_rounds("/x/notackpt.json") is None
    srv, watch = _server(tmp_path, setup)
    try:
        ctl = DeliveryController(srv, "m", watch, poll_s=0.02, bake_s=0.0)
        assert ctl.status()["processed_rounds"] == 3

        def _no_verify(p):
            raise AssertionError(f"steady-state poll verified {p!r}")

        monkeypatch.setattr(ckpt, "verify_checkpoint", _no_verify)
        assert ctl.poll() is None
        monkeypatch.undo()
        with open(ckpt.checkpoint_path(watch, 9), "wb") as f:
            f.write(setup["raw3"][:-20])
        s0 = _counter("delivery_checkpoints_skipped_total", reason="corrupt")
        assert ctl.poll() is None
        assert _counter("delivery_checkpoints_skipped_total",
                        reason="corrupt") == s0 + 1
        assert srv.registry.live_version("m") == 1
    finally:
        srv.close()


def test_quarantined_version_number_never_reused(setup, tmp_path):
    raw = setup["model3"]
    run = str(tmp_path / "srv")
    srv = ModelServer({"m": raw}, run_dir=run, batch_wait_us=0, device="cpu")
    srv.publish("m", raw)  # m@v2
    srv.quarantine_version("m", 2, rounds=5)
    srv.close()
    srv2 = ModelServer(run_dir=run, batch_wait_us=0, device="cpu")
    try:
        assert 2 in srv2.quarantined_versions("m")
        assert srv2.publish("m", raw) == "m@v3"
        assert srv2.promote("m", 3) == "m@v3"
    finally:
        srv2.close()
