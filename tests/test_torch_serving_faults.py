"""The port's self-healing serving plane (``xgboost_tpu_torch/serving/
faults.py``): batch fault isolation and bisection, the same-batch retry,
quarantine, the circuit breakers, admission validation, abandoned
futures, the batcher watchdog, the crash-only manifest and drain, and the
serving chaos sites' schedules against the JAX package's.

Every wait is bounded (``future.result(timeout)``, events); the breaker's
cooldowns are tens of milliseconds and waited out with a bounded sleep.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xgbt
from xgboost_tpu.resilience import chaos as jchaos
from xgboost_tpu_torch.observability import REGISTRY
from xgboost_tpu_torch.resilience import chaos, policy
from xgboost_tpu_torch.serving import ModelServer, RequestError, RequestShed
from xgboost_tpu_torch.serving.faults import (
    CLOSED, HALF_OPEN, OPEN, CircuitBreaker, Quarantine, fingerprint,
)

torch.set_num_threads(1)

PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16}
POISON = 1e30  # the poison sentinel value (XGBTPU_CHAOS_POISON)


def _counter(name, **labels):
    fam = REGISTRY.get(name)
    return 0.0 if fam is None else fam.labels(**labels).value


@pytest.fixture(scope="module")
def model():
    X = np.random.RandomState(7).randn(400, 5).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    return xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), 3), X


def _server(**kw):
    kw.setdefault("batch_wait_us", 0)
    return ModelServer(device="cpu", **kw)


class _Gate:
    """Holds the batcher's worker inside its next dispatch of ``entry``
    until released, so later requests queue behind it and coalesce."""

    def __init__(self, entry):
        self.entry, self.real = entry, entry.predict
        self.entered, self.go = threading.Event(), threading.Event()
        entry.predict = self._predict

    def _predict(self, X, **kw):
        self.entered.set()
        assert self.go.wait(30)
        self.entry.predict = self.real
        return self.real(X, **kw)


def test_poison_isolated_innocents_bit_identical(model, monkeypatch):
    bst, X = model
    N = 12
    inputs = [X[i:i + 1 + (i % 3)] for i in range(N)]
    monkeypatch.setenv("XGBTPU_CHAOS_POISON", str(POISON))
    f0 = _counter("serving_faults_total", site="serving_dispatch",
                  kind="permanent")
    p0 = _counter("serving_poison_requests_total")
    b0 = _counter("serving_bisect_dispatches_total")
    srv = _server(batch_wait_us=1000)
    try:
        srv.load("m", bst)
        gate = _Gate(srv.registry.get("m"))
        head = srv.predict_async("m", X[:1])
        assert gate.entered.wait(30)
        futs = [srv.predict_async("m", inputs[i], request_id=f"r{i}")
                for i in range(N // 2)]
        Xp = X[:1].copy()
        Xp[0, 2] = POISON
        pf = srv.predict_async("m", Xp, request_id="poison")
        futs += [srv.predict_async("m", inputs[i], request_id=f"r{i}")
                 for i in range(N // 2, N)]
        gate.go.set()
        head.result(60)
        with pytest.raises(RequestError) as exc:
            pf.result(60)
        assert exc.value.request_id == "poison"
        assert exc.value.site == "serving_dispatch"
        assert exc.value.kind == policy.PERMANENT
        for f, rows in zip(futs, inputs):
            np.testing.assert_array_equal(f.result(60),
                                          bst.inplace_predict(rows))
        # the 13 coalesced requests were bisected down to the poison one
        assert _counter("serving_bisect_dispatches_total") > b0
        assert _counter("serving_faults_total", site="serving_dispatch",
                        kind="permanent") > f0
        assert _counter("serving_poison_requests_total") == p0 + 1
        exp = srv.metrics()
        assert ('serving_faults_total{kind="permanent",'
                'site="serving_dispatch"}') in exp
        assert "serving_quarantined_inputs" in exp
        assert 'serving_breaker_state{model="m"}' in exp
    finally:
        srv.close()


def test_transient_dispatch_fault_retried_same_batch(model):
    bst, X = model
    srv = _server()
    try:
        srv.load("m", bst)
        r0 = _counter("serving_batch_retries_total")
        b0 = _counter("serving_bisect_dispatches_total")
        with chaos.configure("serving_dispatch:transient:1"):
            out = srv.predict("m", X[:4], timeout=60)
        np.testing.assert_array_equal(out, bst.inplace_predict(X[:4]))
        assert _counter("serving_batch_retries_total") == r0 + 1
        assert _counter("serving_bisect_dispatches_total") == b0
    finally:
        srv.close()


def test_quarantine_repeat_offender_shed_at_admission(model, monkeypatch):
    bst, X = model
    monkeypatch.setenv("XGBTPU_CHAOS_POISON", str(POISON))
    monkeypatch.setenv("XGBTPU_QUARANTINE_AFTER", "1")
    srv = _server()
    try:
        srv.load("m", bst)
        Xp = X[:2].copy()
        Xp[1, 0] = POISON
        with pytest.raises(RequestError):
            srv.predict("m", Xp, timeout=60)
        q0 = _counter("requests_shed_total", reason="quarantine")
        with pytest.raises(RequestShed) as exc:
            srv.predict("m", Xp, timeout=60)
        assert exc.value.reason == "quarantine"
        assert _counter("requests_shed_total", reason="quarantine") == q0 + 1
        np.testing.assert_array_equal(srv.predict("m", X[:2], timeout=60),
                                      bst.inplace_predict(X[:2]))
    finally:
        srv.close()


def test_fingerprint_is_content_keyed():
    a = np.arange(10, dtype=np.float32).reshape(2, 5)
    assert fingerprint(a) == fingerprint(a.copy())
    b = a.copy()
    b[1, 4] += 1
    assert fingerprint(a) != fingerprint(b)
    assert fingerprint(a) != fingerprint(a.reshape(5, 2))
    assert fingerprint([1.0, 2.0]) is None
    q = Quarantine(after=2, cap=8)
    fp = fingerprint(a)
    assert not q.note(fp)
    assert not q.quarantined(fp)
    assert q.note(fp)
    assert q.quarantined(fp)
    for i in range(20):  # the LRU cap drops the old offender
        q.note(1000 + i)
    assert not q.quarantined(fp)


def test_breaker_trip_halfopen_probe_matrix():
    events = []
    b = CircuitBreaker("t_bm", window=8, threshold=0.5, min_samples=4,
                       open_s=0.05,
                       on_event=lambda name, **a: events.append(
                           (a["frm"], a["to"])))
    for _ in range(3):
        b.record(ok=True)
    assert b.state == CLOSED
    for _ in range(4):  # 4 fails of 7 outcomes >= 0.5
        b.record(ok=False)
    assert b.state == OPEN
    assert b.allow() is False
    time.sleep(0.06)
    assert b.allow() is True  # the cooldown passed: this is the probe
    assert b.state == HALF_OPEN
    assert b.allow() is False  # a concurrent arrival is shed
    b.record(ok=False)
    assert b.state == OPEN
    time.sleep(0.06)
    assert b.allow() is True
    b.record(ok=True)
    assert b.state == CLOSED and b.allow() is True
    for _ in range(8):
        b.record(ok=True)
    assert b.state == CLOSED
    assert events == [("closed", "open"), ("open", "half_open"),
                      ("half_open", "open"), ("open", "half_open"),
                      ("half_open", "closed")]


def test_breaker_latency_trip_and_concurrent_feeds():
    b = CircuitBreaker("t_lm", window=8, threshold=0.5, min_samples=4,
                       open_s=30.0, latency_ms=5.0)
    for _ in range(4):
        b.record(ok=True, latency_s=0.05)
    assert b.state == OPEN
    t0 = _counter("serving_breaker_transitions_total", model="t_cm",
                  to="open")
    c = CircuitBreaker("t_cm", window=16, threshold=0.5, min_samples=4,
                       open_s=30.0)
    threads = [threading.Thread(
        target=lambda: [c.record(ok=False) for _ in range(10)])
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert c.state == OPEN
    assert _counter("serving_breaker_transitions_total", model="t_cm",
                    to="open") == t0 + 1


def test_breaker_open_sheds_at_admission_then_probe_recovers(model):
    bst, X = model
    srv = _server()
    try:
        srv.load("m", bst)
        b = srv.faults.breaker("m")
        b.open_s = 0.05
        for _ in range(b.min_samples):
            b.record(ok=False)
        assert b.state == OPEN
        s0 = _counter("requests_shed_total", reason="breaker")
        with pytest.raises(RequestShed) as exc:
            srv.predict("m", X[:2], timeout=60)
        assert exc.value.reason == "breaker"
        assert _counter("requests_shed_total", reason="breaker") == s0 + 1
        time.sleep(0.06)
        np.testing.assert_array_equal(srv.predict("m", X[:2], timeout=60),
                                      bst.inplace_predict(X[:2]))
        assert b.state == CLOSED
        assert srv.predict("m", X[:4], timeout=60).shape == (4,)
    finally:
        srv.close()


def test_invalid_payloads_rejected_before_the_queue(model, monkeypatch):
    bst, X = model
    monkeypatch.setenv("XGBTPU_MAX_REQUEST_ROWS", "8")
    srv = _server()
    try:
        srv.load("m", bst)
        a0 = _counter("serving_admitted_total")
        i0 = _counter("requests_shed_total", reason="invalid")
        cases = [(X[:2, :3], "wrong width"),
                 (np.full((1, 5), np.inf, np.float32), "inf values"),
                 (X[:0], "empty payload"), (X[:9], "oversized rows")]
        for bad, why in cases:
            with pytest.raises(RequestShed) as exc:
                srv.predict("m", bad, timeout=60)
            assert exc.value.reason == "invalid", why
        assert _counter("requests_shed_total",
                        reason="invalid") == i0 + len(cases)
        assert _counter("serving_admitted_total") == a0
        out = srv.predict("m", np.full((1, 5), np.nan, np.float32),
                          timeout=60)
        assert out.shape == (1,)
        with pytest.raises(TypeError, match="2-D"):
            srv.predict("m", X[0], timeout=60)
    finally:
        srv.close()


def test_abandoned_future_skipped_at_dispatch_assembly(model):
    bst, X = model
    srv = _server(batch_wait_us=1000)
    try:
        srv.load("m", bst)
        a0 = _counter("serving_requests_total", outcome="abandoned")
        gate = _Gate(srv.registry.get("m"))
        head = srv.predict_async("m", X[:1])
        assert gate.entered.wait(30)
        f1 = srv.predict_async("m", X[:1])
        assert f1.cancel()  # queued behind the held dispatch: never claimed
        f2 = srv.predict_async("m", X[1:3])
        gate.go.set()
        head.result(60)
        np.testing.assert_array_equal(f2.result(60),
                                      bst.inplace_predict(X[1:3]))
        assert f1.cancelled()
        # the outcome is counted on the recorder's writer thread: read it
        # behind the barrier its readers use
        assert srv.obs.drain(30)
        assert _counter("serving_requests_total",
                        outcome="abandoned") == a0 + 1
        assert srv.registry.get("m").inflight == 0
    finally:
        srv.close()


def test_watchdog_fails_wedged_futures_and_respawns(model, monkeypatch):
    bst, X = model
    monkeypatch.setenv("XGBTPU_BATCHER_WATCHDOG", "0.2")
    srv = _server()
    try:
        srv.load("m", bst)
        r0 = _counter("serving_worker_respawns_total")
        with chaos.configure("batcher_wedge:transient:1"):
            fut = srv.predict_async("m", X[:2], request_id="wedged")
            with pytest.raises(RequestError) as exc:
                fut.result(30)
            assert exc.value.site == "batcher_wedge"
            assert exc.value.request_id == "wedged"
            out = srv.predict("m", X[:2], timeout=30)
        np.testing.assert_array_equal(out, bst.inplace_predict(X[:2]))
        assert _counter("serving_worker_respawns_total") == r0 + 1
        assert _counter("serving_faults_total", site="batcher_wedge",
                        kind="transient") >= 1
    finally:
        srv.close()


def test_manifest_restart_refaults_lazily_and_drain_sheds(model, tmp_path):
    bst, X = model
    run_dir = str(tmp_path / "run")
    srv = ModelServer({"m": bst}, run_dir=run_dir, batch_wait_us=0,
                      device="cpu")
    try:
        ref = srv.predict("m", X[:4], timeout=60)
    finally:
        srv.close()
    man = json.load(open(os.path.join(run_dir, "manifest.json")))
    assert man["format"] == "xgbtpu-manifest-v1"
    assert man["models"]["m"]["live"] == 1
    spec = man["models"]["m"]["versions"]["1"]
    assert spec["kind"] == "file" and os.path.exists(spec["path"])
    srv2 = _server(run_dir=run_dir)
    try:
        assert srv2.registry.resident() == []
        m0 = _counter("serving_model_misses_total")
        np.testing.assert_array_equal(srv2.predict("m", X[:4], timeout=60),
                                      ref)
        assert _counter("serving_model_misses_total") == m0 + 1
        assert srv2.registry.resident() == ["m@v1"]
        srv2.begin_drain()
        with pytest.raises(RequestShed) as exc:
            srv2.predict("m", X[:4])
        assert exc.value.reason == "draining"
        assert srv2.stats()["draining"] is True
    finally:
        srv2.close()


def test_manifest_tracks_swap_live_version(model, tmp_path):
    bst, X = model
    y2 = (X[:, 1] > 0).astype(np.float32)
    bst2 = xgbt.train(dict(PARAMS, seed=9), xgbt.DMatrix(X, y2, device="cpu"),
                      2)
    run_dir = str(tmp_path / "run")
    srv = ModelServer({"m": bst}, run_dir=run_dir, batch_wait_us=0,
                      device="cpu")
    try:
        srv.swap("m", bst2)
    finally:
        srv.close()
    man = json.load(open(os.path.join(run_dir, "manifest.json")))
    assert man["models"]["m"]["live"] == 2
    assert set(man["models"]["m"]["versions"]) == {"1", "2"}
    srv2 = _server(run_dir=run_dir)
    try:
        np.testing.assert_array_equal(srv2.predict("m", X[:4], timeout=60),
                                      bst2.inplace_predict(X[:4]))
    finally:
        srv2.close()


def test_serving_chaos_sites_fire_where_the_jax_packages_do():
    """The serving sites' seeded schedules fire at the same hit indices in
    both packages (the grammar has no random state)."""
    cfg = ("serving_dispatch:transient:%5;"
           "serving_model_load:transient:p0.4@7;"
           "serving_swap:permanent:3;"
           "batcher_wedge:transient:2-4;"
           "pallas:permanent:1,7")
    sites = ("serving_dispatch", "serving_model_load", "serving_swap",
             "batcher_wedge", "pallas")

    def fired(mod):
        out = {}
        with mod.configure(cfg):
            for site in sites:
                hits = []
                for n in range(1, 41):
                    try:
                        mod.hit(site)
                    except mod.ChaosError:
                        hits.append(n)
                out[site] = hits
        return out

    local = fired(chaos)
    assert local["serving_dispatch"] == [5, 10, 15, 20, 25, 30, 35, 40]
    assert local["serving_swap"] == [3]
    assert local["batcher_wedge"] == [2, 3, 4]
    assert local["pallas"] == [1, 7]
    assert 0 < len(local["serving_model_load"]) < 40
    assert fired(jchaos) == local
