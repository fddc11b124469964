"""The port's model server (``xgboost_tpu_torch/serving/``): coalescing,
options that must not coalesce, the arena's LRU and fault-back-in,
multi-tenant traffic, hot swap under traffic, admission sheds, a kernel
launch fault under serving, per-model latency labels, the JSONL protocol,
and the two packages' servers against each other (the same stream, and
each other's crash-only manifests).

Every wait is bounded and no assertion depends on a coalescing window
winning a race: the batcher's worker is held inside a dispatch (an event)
while the requests that must coalesce are queued behind it.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import xgboost_tpu as jxgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch import predictor as tpred
from xgboost_tpu_torch.observability import REGISTRY
from xgboost_tpu_torch.resilience import chaos
from xgboost_tpu_torch.serving import (
    ModelRegistry, ModelServer, RequestError, RequestShed,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16}


def _counter(name, **labels):
    fam = REGISTRY.get(name)
    return 0.0 if fam is None else fam.labels(**labels).value


def _train(seed, rounds=3, flip=False):
    X = np.random.RandomState(7).randn(400, 5).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    if flip:
        y = 1.0 - y
    return xgbt.train(dict(PARAMS, seed=seed),
                      xgbt.DMatrix(X, y, device="cpu"), rounds), X


@pytest.fixture(scope="module")
def model():
    return _train(seed=1)


def _server(**kw):
    kw.setdefault("batch_wait_us", 0)
    return ModelServer(device="cpu", **kw)


class _Gate:
    """Holds the batcher's worker inside its next dispatch of ``entry``
    until :meth:`release`; records the rows of every dispatch."""

    def __init__(self, entry):
        self.entry = entry
        self.real = entry.predict
        self.entered = threading.Event()
        self.go = threading.Event()
        self.rows = []
        entry.predict = self._predict

    def _predict(self, X, **kw):
        self.rows.append(len(X))
        self.entered.set()
        assert self.go.wait(30), "gate never released"
        return self.real(X, **kw)

    def hold(self, fut):
        assert self.entered.wait(30), "the worker never dispatched"
        return fut

    def release(self):
        self.go.set()

    def close(self):
        self.go.set()
        self.entry.predict = self.real


def test_batcher_coalesces_64_one_row_requests(model):
    bst, X = model
    srv = _server(batch_wait_us=1000)
    try:
        srv.load("m", bst)
        gate = _Gate(srv.registry.get("m"))
        d0 = _counter("serving_dispatches_total")
        first = gate.hold(srv.predict_async("m", X[:1]))
        futs = [srv.predict_async("m", X[i:i + 1]) for i in range(64)]
        gate.release()
        out = np.concatenate([f.result(60) for f in futs])
        first.result(60)
        gate.close()
        # the 64 queued rows went out as ONE dispatch
        assert gate.rows == [1, 64]
        assert _counter("serving_dispatches_total") - d0 == 2
        np.testing.assert_array_equal(out, bst.inplace_predict(X[:64]))
    finally:
        srv.close()


def test_batcher_mixed_options_do_not_coalesce(model):
    bst, X = model
    srv = _server(batch_wait_us=1000)
    try:
        srv.load("m", bst)
        gate = _Gate(srv.registry.get("m"))
        first = gate.hold(srv.predict_async("m", X[:1]))
        bm = np.full(3, 0.25, np.float32)
        kinds = [
            ({}, 2), ({"predict_type": "margin"}, 2),
            ({"iteration_range": (0, 2)}, 2), ({"base_margin": bm}, 3),
            ({}, 2), ({"predict_type": "margin"}, 2)]
        futs = [(kw, srv.predict_async("m", X[10 * i:10 * i + n], **kw),
                 X[10 * i:10 * i + n]) for i, (kw, n) in enumerate(kinds)]
        gate.release()
        first.result(60)
        for kw, f, rows in futs:
            np.testing.assert_array_equal(f.result(60),
                                          bst.inplace_predict(rows, **kw))
        gate.close()
        # value and margin coalesce only with their own kind; the range
        # and the base margin each dispatch alone
        assert sorted(gate.rows[1:]) == [2, 3, 4, 4]
    finally:
        srv.close()


def test_registry_lru_eviction_and_fault_back_in(model):
    bst, X = model
    raw = bst.save_raw()
    reg = ModelRegistry(arena_mb=1e-5, device="cpu")  # one entry over budget
    e0 = _counter("serving_model_evictions_total")
    for name in ("a", "b", "c"):
        reg.load(name, raw)
    assert reg.resident() == ["c@v1"]
    assert _counter("serving_model_evictions_total") - e0 == 2
    h0 = _counter("serving_model_hits_total")
    m0 = _counter("serving_model_misses_total")
    calls = 0
    for name in ("a", "b", "c", "c", "a"):
        entry = reg.get(name)
        calls += 1
        assert entry.booster.device.type == "cpu"
        np.testing.assert_array_equal(entry.predict(X[:5]),
                                      bst.inplace_predict(X[:5]))
    hits = _counter("serving_model_hits_total") - h0
    misses = _counter("serving_model_misses_total") - m0
    assert hits + misses == calls and misses >= 3
    # the charge counts the snapshot's tensors, kernel B's node records
    # among them, and the model bytes
    forest, _ = reg.get("a").booster._forest_snapshot()
    assert forest.nodes is not None
    assert reg.get("a").nbytes >= forest.nodes.numel() * 4 + len(raw)


def test_multi_tenant_concurrent_no_bleed(model):
    bst1, X = model
    boosters = {"m1": bst1, "m2": _train(seed=2, flip=True)[0],
                "m3": _train(seed=3, rounds=4)[0]}
    refs = {n: b.inplace_predict(X) for n, b in boosters.items()}
    assert not np.array_equal(refs["m1"], refs["m2"])
    srv = _server(batch_wait_us=500)
    try:
        for name, b in boosters.items():
            srv.load(name, b)
        h0 = _counter("serving_model_hits_total")
        m0 = _counter("serving_model_misses_total")
        failures, calls = [], [0] * 4

        def traffic(k):
            rng = np.random.RandomState(k)
            names = list(boosters)
            try:
                for i in range(12):
                    name = names[(k + i) % 3]
                    lo, n = int(rng.randint(0, 300)), int(rng.randint(1, 64))
                    out = srv.predict(name, X[lo:lo + n], timeout=60,
                                      tenant=f"t{k % 2}")
                    calls[k] += 1
                    if not np.array_equal(out, refs[name][lo:lo + n]):
                        failures.append((k, i, name))
            except Exception as e:  # noqa: BLE001 — collected
                failures.append((k, repr(e)))

        threads = [threading.Thread(target=traffic, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not failures, failures[:5]
        hits = _counter("serving_model_hits_total") - h0
        misses = _counter("serving_model_misses_total") - m0
        assert hits + misses == sum(calls) == 48
        assert _counter("serving_tenant_dequeued_rows_total",
                        tenant="t0") > 0
    finally:
        srv.close()


def test_hot_swap_mid_traffic_loses_zero_requests(model):
    bst1, X = model
    bst2, _ = _train(seed=11, flip=True)
    ref1, ref2 = bst1.inplace_predict(X[:6]), bst2.inplace_predict(X[:6])
    srv = _server(batch_wait_us=200)
    s0 = _counter("model_swaps_total", model="m@v2")
    try:
        srv.load("m", bst1)
        results, failures = [], []
        started = threading.Semaphore(0)
        swapped = threading.Event()

        def traffic():
            try:
                for i in range(40):
                    results.append(srv.predict("m", X[:6], timeout=60))
                    if i == 3:
                        started.release()
                    if swapped.is_set() and i >= 10:
                        break
            except Exception as e:  # noqa: BLE001
                failures.append(repr(e))

        threads = [threading.Thread(target=traffic) for _ in range(3)]
        for t in threads:
            t.start()
        for _ in threads:
            assert started.acquire(timeout=60)
        assert srv.swap("m", bst2) == "m@v2"
        swapped.set()
        for t in threads:
            t.join(120)
        assert not failures, failures
        n_v2 = 0
        for out in results:
            if np.array_equal(out, ref2):
                n_v2 += 1
            else:
                np.testing.assert_array_equal(out, ref1)
        assert len(results) >= 3 * 11
        assert srv.registry.get("m", version=1).inflight == 0
        assert _counter("model_swaps_total", model="m@v2") - s0 == 1
        np.testing.assert_array_equal(srv.predict("m", X[:6]), ref2)
    finally:
        srv.close()


def test_admission_sheds_deadline_queue_and_slo(model):
    bst, X = model
    srv = _server(max_queue=3)
    try:
        srv.load("m", bst)
        with pytest.raises(RequestShed) as exc:
            srv.predict("m", X[:2], deadline_ms=0)
        assert exc.value.reason == "deadline"
        gate = _Gate(srv.registry.get("m"))
        real_p99 = srv.admission.p99_s
        srv.admission.p99_s = lambda model="": 1e-4
        blocked = gate.hold(srv.predict_async("m", X[:2]))
        aged = srv.predict_async("m", X[:2], deadline_ms=30)
        queued = [srv.predict_async("m", X[:2]) for _ in range(2)]
        with pytest.raises(RequestShed) as exc:
            srv.predict_async("m", X[:2])
        assert exc.value.reason == "queue_full"
        time.sleep(0.06)  # the aged request's 30 ms pass while it queues
        gate.release()
        assert blocked.result(60).shape == (2,)
        for f in queued:
            f.result(60)
        with pytest.raises(RequestShed) as exc:
            aged.result(60)
        assert exc.value.reason == "deadline"
        gate.close()
        srv.admission.p99_s = real_p99
        for _ in range(30):
            REGISTRY.histogram("predict_latency_seconds").labels(
                model="m@v1").observe(0.5)
        with pytest.raises(RequestShed) as exc:
            srv.predict("m", X[:2], deadline_ms=50)
        assert exc.value.reason == "slo"
        exp = srv.metrics()
        for reason in ("deadline", "queue_full", "slo"):
            assert f'requests_shed_total{{reason="{reason}"}}' in exp
        # no degrade route: the counter is registered and stays at 0
        assert not hasattr(srv.admission, "route_native")
        assert "serving_degraded_routes_total 0" in exp
    finally:
        srv.close()


@pytest.mark.parametrize("kind", ["transient", "permanent"])
def test_pallas_fault_under_serving_is_retried_or_typed(model, kind,
                                                        monkeypatch):
    """A fault at kernel B's launch site (``pallas``, which
    ``predict_margin`` passes on either device) under serving goes through
    the fault ladder: a transient one is retried on the same batch and
    served; a permanent one ends in a typed ``RequestError`` that the
    breaker records. No walk on the host ever serves the failed launch."""
    bst, X = model
    srv = _server()
    try:
        srv.load("m", bst)
        want = bst.inplace_predict(X[:4])
        walks = []
        real = tpred._predict_margin_plain
        monkeypatch.setattr(tpred, "_predict_margin_plain",
                            lambda *a: walks.append(1) or real(*a))
        r0 = _counter("serving_batch_retries_total")
        with chaos.configure(f"pallas:{kind}:1") as plan:
            fut = srv.predict_async("m", X[:4], request_id="kb")
            if kind == "transient":
                np.testing.assert_array_equal(fut.result(60), want)
                assert walks == [1]  # the retry's walk only
                assert _counter("serving_batch_retries_total") == r0 + 1
            else:
                with pytest.raises(RequestError) as exc:
                    fut.result(60)
                assert exc.value.kind == "permanent"
                assert exc.value.request_id == "kb"
                assert "pallas" in str(exc.value)
                assert walks == []
                snap = srv.faults.breaker("m").snapshot()
                assert snap["window_failures"] == 1
            assert plan.fired == [("pallas", 1, kind)]
        np.testing.assert_array_equal(srv.predict("m", X[:4]), want)
    finally:
        srv.close()


def test_per_model_latency_labels(model):
    bst, X = model
    srv = _server()
    try:
        srv.load("tenant", bst)
        for _ in range(3):
            srv.predict("tenant", X[:8], timeout=60)
        series = REGISTRY.snapshot()["predict_latency_seconds"]["series"]
        labelled = [s for s in series
                    if s["labels"].get("model") == "tenant@v1"]
        assert labelled and labelled[0]["count"] >= 3
        assert labelled[0]["p99"] is not None
        # the warm-up predict stays out of the model's series
        assert labelled[0]["count"] == 3
    finally:
        srv.close()


def _protocol(path, X):
    return [
        {"op": "load", "model": "m", "path": path},
        {"op": "predict", "id": "a", "model": "m", "data": X[:3].tolist()},
        {"op": "predict", "id": "b", "model": "m", "data": X[0].tolist()},
        {"op": "predict", "id": "c", "model": "nope", "data": [[0.0] * 5]},
        {"op": "stats"},
        {"op": "metrics"},
        {"op": "shutdown"},
        {"op": "predict", "id": "after", "model": "m",
         "data": X[:1].tolist()},
    ]


def _check_protocol(lines, bst, X):
    assert len(lines) == 7  # nothing after shutdown
    assert lines[0] == {"version": "m@v1", "ok": True}
    np.testing.assert_array_equal(
        lines[1]["result"], bst.inplace_predict(X[:3]).astype(np.float64))
    assert lines[1]["id"] == "a" and len(lines[2]["result"]) == 1
    assert "error" in lines[3]
    assert lines[4]["stats"]["arena"]["live"] == {"m": "m@v1"}
    assert "serving_dispatches_total" in lines[5]["metrics"]
    assert lines[6] == {"ok": True}


def test_serve_stdin_jsonl_in_process(model, tmp_path):
    from xgboost_tpu_torch.serving.server import serve_main

    bst, X = model
    path = str(tmp_path / "m.json")
    bst.save_model(path)
    stdin = io.StringIO("\n".join(json.dumps(r)
                                  for r in _protocol(path, X)) + "\n")
    stdout = io.StringIO()
    assert serve_main(["--stdin", "--device", "cpu"], stdin=stdin,
                      stdout=stdout) == 0
    _check_protocol([json.loads(ln) for ln in stdout.getvalue().splitlines()],
                    bst, X)
    assert serve_main([], stdin=io.StringIO(""), stdout=io.StringIO()) == 1


def test_serve_command_line_over_stdin(model, tmp_path):
    """``python -m xgboost_tpu_torch serve --stdin --device cpu``: the
    answers equal ``inplace_predict`` digit for digit."""
    bst, X = model
    path = str(tmp_path / "m.json")
    bst.save_model(path)
    msgs = "\n".join(json.dumps(r) for r in _protocol(path, X)) + "\n"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "xgboost_tpu_torch", "serve", "--stdin",
         "--device", "cpu"], input=msgs, cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    _check_protocol([json.loads(ln) for ln in out.stdout.splitlines()],
                    bst, X)


def test_servers_of_both_packages_answer_the_same_stream(model):
    bst, X = model
    raw = bst.save_raw()
    jsrv = jxgb.ModelServer(batch_wait_us=0)
    tsrv = _server()
    try:
        jsrv.load("m", raw)
        tsrv.load("m", raw)
        rng = np.random.RandomState(5)
        for i in range(16):
            lo, n = int(rng.randint(0, 300)), int(rng.randint(1, 40))
            kw = {"predict_type": "margin"} if i % 3 == 0 else {}
            if i % 4 == 1:
                kw["iteration_range"] = (0, 2)
            got = tsrv.predict("m", X[lo:lo + n], timeout=60, **kw)
            want = np.asarray(jsrv.predict("m", X[lo:lo + n], timeout=60,
                                           **kw))
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    finally:
        jsrv.close()
        tsrv.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_restores_the_others_manifest(model, tmp_path,
                                                     writer):
    bst, X = model
    bst2, _ = _train(seed=9, flip=True)
    run_dir = str(tmp_path / "run")
    make = {"jax": lambda **kw: jxgb.ModelServer(batch_wait_us=0, **kw),
            "port": lambda **kw: _server(**kw)}
    reader = "port" if writer == "jax" else "jax"
    srv = make[writer](run_dir=run_dir)
    try:
        srv.load("m", bst.save_raw())
        srv.swap("m", bst2.save_raw())
    finally:
        srv.close()
    man = json.load(open(os.path.join(run_dir, "manifest.json")))
    assert man["format"] == "xgbtpu-manifest-v1"
    assert man["models"]["m"]["live"] == 2
    srv2 = make[reader](run_dir=run_dir)
    try:
        assert srv2.registry.resident() == []  # lazy: faulted in on use
        got = np.asarray(srv2.predict("m", X[:8], timeout=60))
        np.testing.assert_allclose(got, bst2.inplace_predict(X[:8]),
                                   rtol=0, atol=1e-5)
        got1 = np.asarray(srv2.predict("m", X[:8], version=1, timeout=60))
        np.testing.assert_allclose(got1, bst.inplace_predict(X[:8]),
                                   rtol=0, atol=1e-5)
    finally:
        srv2.close()
