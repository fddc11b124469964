"""``serve-report`` in the port (``xgboost_tpu_torch/observability/
serve_report.py``) against the JAX package's on the same directories:
one server's run directory written by the port's ``ModelServer`` (a shed
and a swap), a fleet of two replica directories (tenants, a drain), and a
JAX server's directory. Both reports write equal JSON and equal text; the
merged traces load with the same events; a torn last line is skipped; a
directory without serving observability exits 1.
"""

import json
import os

import numpy as np
import pytest
import torch

import xgboost_tpu as jxgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu.observability import serve_report as jsr
from xgboost_tpu_torch.observability import serve_report as tsr
from xgboost_tpu_torch.observability import trace as _trace
from xgboost_tpu_torch.serving import ModelServer, RequestShed

torch.set_num_threads(1)

PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16}


def _train(seed, flip=False):
    X = np.random.RandomState(7).randn(400, 5).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    if flip:
        y = 1.0 - y
    return xgbt.train(dict(PARAMS, seed=seed),
                      xgbt.DMatrix(X, y, device="cpu"), 3), X


@pytest.fixture(scope="module")
def models():
    bst, X = _train(seed=1)
    bst2, _ = _train(seed=11, flip=True)
    return bst, bst2, X


@pytest.fixture(autouse=True)
def _own_trace(monkeypatch):
    """Spans go to each server's own ``run_dir`` sink."""
    if _trace.enabled():
        _trace.flush()
    monkeypatch.delenv("XGBTPU_TRACE", raising=False)


def _serve_one(run_dir, bst, bst2, X, make=None):
    """Traffic with a shed and a swap through one server."""
    srv = (make or (lambda **kw: ModelServer(device="cpu", **kw)))(
        batch_wait_us=500, run_dir=run_dir)
    try:
        srv.load("m", bst.save_raw())
        for i in range(12):
            srv.predict("m", X[i:i + 1 + (i % 3)], request_id=f"r-{i}",
                        timeout=60)
        with pytest.raises(Exception):
            srv.predict("m", X[:2], deadline_ms=0, request_id="r-shed")
        assert srv.swap("m", bst2.save_raw()) == "m@v2"
        srv.predict("m", X[:4], request_id="r-post", timeout=60)
    finally:
        srv.close()


def _serve_fleet(root, bst, X):
    """Two replica directories; replica1 drains and sheds a request."""
    for k in range(2):
        srv = ModelServer(device="cpu", batch_wait_us=0,
                          run_dir=os.path.join(root, f"replica{k}"))
        try:
            srv.load("m", bst.save_raw())
            for i in range(6):
                srv.predict("m", X[i:i + 2], request_id=f"{k}-{i}",
                            tenant=("hot", "light")[i % 2], timeout=60)
            if k == 1:
                srv.begin_drain()
                with pytest.raises(RequestShed):
                    srv.predict("m", X[:1], request_id="late",
                                tenant="light")
        finally:
            srv.close()


def _both(argv, capsys, out_json, out_trace):
    """Each package's ``main`` on ``argv``: (rc, stdout, report, trace)
    for the port, then the JAX package."""
    got = []
    for main in (tsr.main, jsr.main):
        rc = main(list(argv))
        text = capsys.readouterr().out
        with open(out_json) as f:
            doc = json.load(f)
        got.append((rc, text, doc, _trace.load_trace(out_trace)))
    return got


def _server_outputs(run_dir):
    obs = os.path.join(run_dir, "obs")
    return (os.path.join(obs, "serve_report.json"),
            os.path.join(obs, "serve.trace.json"))


def test_one_servers_report_equals_the_jax_packages(models, tmp_path,
                                                    capsys):
    bst, bst2, X = models
    run = str(tmp_path / "srv")
    _serve_one(run, bst, bst2, X)
    port, jax = _both([run], capsys, *_server_outputs(run))
    assert port == jax
    rc, text, doc, events = port
    assert rc == 0
    assert text.startswith("serve-report: 14 request(s)")
    assert "m@v1" in text and "m@v2" in text
    assert "shed[deadline]=1" in text and "model_swap(m@v2)" in text
    assert "worst-request exemplars" in text
    s = doc["summary"]
    assert s["outcomes"] == {"ok": 13, "shed": 1}
    assert s["routes"] == {"torch": s["dispatches"]}
    assert s["cache_misses"] == 0
    assert all(row["native"] == 0 for row in doc["timeline"])
    assert s["models"]["m@v1"]["total_p99_s"] > 0
    assert s["coalesce_ratio"] >= 1.0
    assert set(doc) == {"summary", "tenants", "timeline", "delivery",
                        "exemplars"}
    names = {e.get("name") for e in events}
    assert {"model_swap", "server_close", "request"} <= names


def test_fleet_report_equals_the_jax_packages(models, tmp_path, capsys):
    bst, _, X = models
    root = str(tmp_path / "fleet")
    _serve_fleet(root, bst, X)
    obs = os.path.join(root, "obs")
    port, jax = _both([root], capsys,
                      os.path.join(obs, "fleet_serve_report.json"),
                      os.path.join(obs, "fleet_serve.trace.json"))
    assert port == jax
    rc, text, doc, events = port
    assert rc == 0
    assert text.startswith("fleet serve-report (2 replicas): 13 request(s)")
    assert "per-replica rollup" in text and "per-tenant rollup" in text
    assert "server_drain=1" in text
    assert [r["replica"] for r in doc["replicas"]] == ["replica0",
                                                       "replica1"]
    assert doc["replicas"][1]["shed_reasons"] == {"draining": 1}
    assert set(doc["tenants"]) == {"hot", "light"}
    assert doc["tenants"]["light"]["shed_reasons"] == {"draining": 1}
    assert doc["summary"]["cache_misses"] == 0
    assert "serving_requests_total" in json.dumps(doc["rollup"])
    assert {e.get("pid") for e in events} == {0, 1}
    assert {e["args"]["name"] for e in events if e.get("ph") == "M"} == {
        "xgboost_tpu replica0", "xgboost_tpu replica1"}


def test_report_on_a_jax_servers_directory(models, tmp_path, capsys):
    bst, bst2, X = models
    run = str(tmp_path / "jax_srv")
    _serve_one(run, bst, bst2, X, make=jxgb.ModelServer)
    port, jax = _both([run], capsys, *_server_outputs(run))
    assert port == jax and port[0] == 0
    assert port[2]["summary"]["outcomes"] == {"ok": 13, "shed": 1}


def test_torn_last_line_and_empty_directory(models, tmp_path, capsys):
    bst, bst2, X = models
    run = str(tmp_path / "srv")
    _serve_one(run, bst, bst2, X)
    with open(os.path.join(run, "obs", "server", "access.jsonl"), "a") as f:
        f.write('{"t": "req", "id": "torn", "outco')
    port, jax = _both([run], capsys, *_server_outputs(run))
    assert port == jax and port[0] == 0
    assert port[2]["summary"]["requests"] == 14
    empty = tmp_path / "nothing"
    empty.mkdir()
    assert tsr.main([str(empty)]) == 1
    assert jsr.main([str(empty)]) == 1
    assert "no serving observability" in capsys.readouterr().err
    assert tsr.main([]) == 1 and tsr.main(["--help"]) == 0
    assert tsr.main([run, "--top", "x"]) == 1


def test_expand_server_dirs_matches_the_jax_package(models, tmp_path):
    bst, _, X = models
    root = tmp_path / "fleet"
    _serve_fleet(str(root), bst, X)
    for k in (2, 10):  # replica10 sorts after replica2 (numerically)
        d = root / f"replica{k}" / "obs" / "server"
        d.mkdir(parents=True)
        (d / "flight.jsonl").write_text(json.dumps({"t": "meta"}) + "\n")
    (root / "replica3").mkdir()  # no sink: skipped
    args = [str(root), str(root / "replica0"), str(tmp_path / "missing")]
    got = tsr.expand_server_dirs(args)
    assert got == jsr.expand_server_dirs(args)
    assert [label for label, _ in got] == [
        "replica0", "replica1", "replica2", "replica10", "replica0"]
    obs, access = tsr.load_server_obs(str(root / "replica1"))
    assert len(access) == 7 and obs.rank == 0
    assert tsr.load_server_obs(str(tmp_path / "missing")) is None
