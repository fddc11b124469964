"""Request-scope serving observability in the port (``xgboost_tpu_torch/
serving/obs.py``): request ids, one access-log line per request, a trace
track per request and a span per dispatch linking exactly the coalesced
ids, the dispatch flight ring, the SLO ledger (deadline hits and misses,
burn, exemplars, the black box), the ``stats`` op, the per-model p99 of
admission, and the ``run_dir/obs/server/`` layout against the JAX
package's."""

import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import xgboost_tpu as jxgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch.observability import REGISTRY
from xgboost_tpu_torch.observability import trace as _trace
from xgboost_tpu_torch.serving import ModelServer, RequestShed

torch.set_num_threads(1)

PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16}


def _counter(name, **labels):
    fam = REGISTRY.get(name)
    return 0.0 if fam is None else fam.labels(**labels).value


@pytest.fixture(scope="module")
def model():
    X = np.random.RandomState(7).randn(400, 5).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    return xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), 3), X


def _own_trace(monkeypatch):
    """Spans go to the server's own ``run_dir`` sink."""
    if _trace.enabled():
        _trace.flush()
    monkeypatch.delenv("XGBTPU_TRACE", raising=False)


def _lines(run_dir, name):
    with open(os.path.join(run_dir, "obs", "server", name)) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _access(run_dir):
    return [r for r in _lines(run_dir, "access.jsonl") if r.get("t") == "req"]


def test_request_tracing_under_concurrency(model, tmp_path, monkeypatch):
    _own_trace(monkeypatch)
    bst, X = model
    n_threads, per = 4, 8
    rids = {f"t{k}-{i}" for k in range(n_threads) for i in range(per)}
    srv = ModelServer(batch_wait_us=500, run_dir=str(tmp_path), device="cpu")
    try:
        srv.load("m", bst)
        failures = []

        def client(k):
            try:
                for i in range(per):
                    rid = f"t{k}-{i}"
                    lo = (k * 17 + i * 7) % 300
                    fut = srv.predict_async("m", X[lo:lo + 1 + (i % 4)],
                                            request_id=rid)
                    assert fut.request_id == rid
                    fut.result(60)
            except Exception as e:  # noqa: BLE001 — collected
                failures.append(repr(e))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not failures, failures[:3]
    finally:
        srv.close()
    reqs = _access(str(tmp_path))
    assert len(reqs) == n_threads * per
    assert {r["id"] for r in reqs} == rids
    for r in reqs:
        assert r["outcome"] == "ok" and r["model"] == "m@v1"
        assert r["total_s"] > 0 and "dispatch_s" in r and "queue_wait_s" in r
        assert r["route"] == "torch" and r["bucket"] >= 16
        assert r["coalesced"] >= 1
    evs = _trace.load_trace(os.path.join(str(tmp_path), "obs", "server",
                                         "trace.jsonl"))
    begins = [e for e in evs if e.get("ph") == "b"
              and e.get("name") == "request"]
    assert {e["id"] for e in begins} == rids
    assert all(e.get("cat") == "serving" for e in begins)
    assert {e["id"] for e in evs if e.get("ph") == "e"
            and e.get("name") == "request"} == rids
    assert {e["id"] for e in evs if e.get("ph") == "b"
            and e.get("name") == "dispatch"} == rids
    disp = [e for e in evs if e.get("ph") == "X"
            and e.get("name") == "serving_dispatch"]
    assert sorted(rid for e in disp for rid in e["args"]["requests"]) \
        == sorted(rids)
    fl = _lines(str(tmp_path), "flight.jsonl")
    assert fl[0]["t"] == "meta" and "clock" in fl[0]
    drecs = [r for r in fl if r.get("t") == "dispatch"]
    assert len(drecs) == len(disp)
    assert sum(r["reqs"] for r in drecs) == n_threads * per
    for r in drecs:
        assert r["bucket"] >= 16 and r["route"] == "torch"
        assert "queue_depth" in r and r["arena_bytes"] > 0


def test_shed_error_outcomes_and_deadline_ledger(model, tmp_path):
    bst, X = model
    h0 = _counter("serving_deadline_total", outcome="hit")
    m0 = _counter("serving_deadline_total", outcome="miss")
    srv = ModelServer(batch_wait_us=0, run_dir=str(tmp_path), device="cpu")
    ledger = srv.obs.ledger
    try:
        srv.load("m", bst)
        srv.predict("m", X[:4], deadline_ms=60000, request_id="will-hit")
        with pytest.raises(RequestShed) as exc:
            srv.predict("m", X[:2], deadline_ms=0, request_id="will-shed")
        assert exc.value.reason == "deadline"
        assert exc.value.request_id == "will-shed"
        with pytest.raises(KeyError):
            srv.predict("nope", X[:2], request_id="no-model")
        entry = srv.registry.get("m")
        real = entry.predict

        def boom(Xq, **kw):
            raise RuntimeError("injected dispatch failure")

        entry.predict = boom
        with pytest.raises(RuntimeError):
            srv.predict("m", X[:2], request_id="will-error")
        entry.predict = real
    finally:
        srv.close()
    by_id = {r["id"]: r for r in _access(str(tmp_path))}
    assert len(by_id) == 4
    assert by_id["will-hit"]["outcome"] == "ok"
    assert by_id["will-shed"]["outcome"] == "shed"
    assert by_id["will-shed"]["shed"] == "deadline"
    assert by_id["no-model"]["outcome"] == "error"
    assert "KeyError" in by_id["no-model"]["error"]
    assert by_id["will-error"]["outcome"] == "error"
    assert "injected" in by_id["will-error"]["error"]
    assert _counter("serving_deadline_total", outcome="hit") - h0 == 1
    assert _counter("serving_deadline_total", outcome="miss") - m0 == 1
    assert ledger.burn() > 0
    ex = ledger.exemplars()
    assert 1 <= len(ex) <= ledger.top_k
    totals = [e["total_s"] for e in ex]
    assert totals == sorted(totals, reverse=True)
    with open(os.path.join(str(tmp_path), "obs", "server",
                           "blackbox.json")) as f:
        bb = json.load(f)
    assert bb["reason"] == "close" and bb["requests"] == 4
    assert bb["slo"]["deadline"]["miss"] >= 1
    assert "dispatch" in bb["slo"]["stages"]


def test_stats_op_exposes_slo_ledger(model, tmp_path):
    from xgboost_tpu_torch.serving.server import serve_main

    bst, X = model
    path = str(tmp_path / "m.json")
    bst.save_model(path)
    reqs = [{"op": "load", "model": "m", "path": path},
            {"op": "predict", "id": "q-1", "model": "m",
             "data": X[:3].tolist(), "deadline_ms": 60000,
             "tenant": "acme"},
            {"op": "stats"}, {"op": "ping"}, {"op": "shutdown"}]
    stdin = io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n")
    stdout = io.StringIO()
    assert serve_main(["--stdin", "--device", "cpu"], stdin=stdin,
                      stdout=stdout) == 0
    lines = [json.loads(ln) for ln in stdout.getvalue().splitlines()]
    assert lines[1]["id"] == "q-1" and lines[1]["request_id"] == "q-1"
    slo = lines[2]["stats"]["slo"]
    assert 0 < slo["target"] < 1
    assert "error_budget_burn" in slo
    assert set(slo["deadline"]) == {"hit", "miss"}
    for stage in ("queue_wait", "batch_wait", "dispatch"):
        assert {"p50", "p99"} <= set(slo["stages"][stage])
    assert any(k.startswith("dispatch_p99")
               for k in slo["per_model"].get("m@v1", {})), slo["per_model"]
    assert any(k.startswith("dispatch_p99")
               for k in slo["per_tenant"].get("acme", {}))
    assert lines[3]["ok"] is True and lines[3]["draining"] is False


def test_admission_p99_prefers_model_series():
    from xgboost_tpu_torch.serving.admission import AdmissionController

    fam = REGISTRY.histogram("predict_latency_seconds")
    for _ in range(50):
        fam.labels(model="hot@v9").observe(9.0)
    ac = AdmissionController()
    fleet_p99, hot_p99 = ac.p99_s(), ac.p99_s("hot@v9")
    assert hot_p99 >= 5.0 and hot_p99 > fleet_p99
    assert ac.p99_s("cold@v1") == fleet_p99
    mid_s = (fleet_p99 + hot_p99) / 2.0
    ac.admit(0, deadline=time.monotonic() + mid_s, model="cold@v1")
    with pytest.raises(RequestShed) as exc:
        ac.admit(0, deadline=time.monotonic() + mid_s, model="hot@v9")
    assert exc.value.reason == "slo"


def test_run_dir_layout_matches_the_jax_package(model, tmp_path,
                                                monkeypatch):
    """The same requests through each package's server leave the same
    files under ``run_dir/obs/server/`` and access lines with the same
    keys (the route's value is each package's own)."""
    _own_trace(monkeypatch)
    bst, X = model
    raw = bst.save_raw()
    dirs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    for kind, run_dir in dirs.items():
        srv = (ModelServer(batch_wait_us=0, run_dir=run_dir, device="cpu")
               if kind == "port" else
               jxgb.ModelServer(batch_wait_us=0, run_dir=run_dir))
        try:
            srv.load("m", raw)
            for i in range(3):
                srv.predict("m", X[i:i + 2], request_id=f"r{i}",
                            deadline_ms=60000, timeout=60)
            with pytest.raises(Exception):
                srv.predict("m", X[:2], deadline_ms=0, request_id="s")
        finally:
            srv.close()
    files = {k: sorted(os.listdir(os.path.join(d, "obs", "server")))
             for k, d in dirs.items()}
    assert files["port"] == files["jax"]
    assert {"access.jsonl", "flight.jsonl", "blackbox.json", "clock.json",
            "metrics.json"} <= set(files["port"])
    acc = {k: {r["id"]: r for r in _access(d)} for k, d in dirs.items()}
    assert set(acc["port"]) == set(acc["jax"]) == {"r0", "r1", "r2", "s"}
    for rid in acc["port"]:
        assert set(acc["port"][rid]) == set(acc["jax"][rid]), rid
    for k, d in dirs.items():
        man = json.load(open(os.path.join(d, "manifest.json")))
        assert man["format"] == "xgbtpu-manifest-v1", k


def test_one_request_dispatch_stays_within_its_host_budget(model):
    """What one served request costs each thread, counted by a profile
    hook on every thread over 20 one-request dispatches: the batcher's
    worker makes at most 3 metric registry lookups, 1 labelled child
    lookup and 24 lock releases (3, 1 and 21 when this was written; 4, 15
    and 41 with the program-cache counts and locked metric reads before
    them), the caller at most 18 lock releases and the writer 6."""
    from collections import Counter

    from xgboost_tpu_torch.observability import metrics

    bst, X = model
    names = {metrics.MetricsRegistry._family.__code__: "registry",
             metrics.MetricFamily.labels.__code__: "labels"}
    counts = {}

    def hook(frame, event, arg):
        key = None
        if event == "call":
            key = names.get(frame.f_code)
        elif event == "c_call" and getattr(arg, "__name__", "") in (
                "__exit__", "release", "_release_save") and type(
                    getattr(arg, "__self__", None)).__name__ in (
                        "lock", "RLock"):
            key = "locks"
        if key is not None:
            counts.setdefault(threading.current_thread().name,
                              Counter())[key] += 1

    srv = ModelServer(device="cpu", batch_wait_us=0)
    try:
        srv.load("m", bst)
        srv.predict("m", X[:4], timeout=60)
        srv.obs.drain()
        threading.setprofile_all_threads(hook)
        try:
            for _ in range(20):
                srv.predict("m", X[:4], timeout=60)
            srv.obs.drain()
        finally:
            threading.setprofile_all_threads(None)
        assert srv.batcher._dispatches.value >= 21
    finally:
        srv.close()
    per = {t: {k: v / 20 for k, v in c.items()} for t, c in counts.items()}
    worker = per["xgbtpu-serving-batcher"]
    assert worker.get("registry", 0) <= 3, worker
    assert worker.get("labels", 0) <= 1, worker
    assert worker["locks"] <= 24, worker
    assert per[threading.current_thread().name]["locks"] <= 18, per
    assert per["xgbtpu-serve-obs"]["locks"] <= 6, per
