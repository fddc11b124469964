"""The port's telemetry (``xgboost_tpu_torch.observability`` and
``utils``) against the JAX package's.

- the metrics registry: the same operations on a registry of each package
  give byte-equal Prometheus exposition and equal JSON snapshots;
- span tracing: a disabled span is one shared no-op; spans nest, flush as
  Chrome trace-event lines and load back; ``XGBTPU_TRACE`` wins over
  ``set_config(trace_path=)``; the ring buffer drops its oldest events;
- a traced 3-round CPU run writes the JAX package's span names in the JAX
  package's order and nesting on the same data (``train`` > ``round`` >
  ``update`` > ``GetGradient`` / ``GetBinned`` > ``dmatrix_build`` >
  ``sketch`` / ``quantize`` / ``BoostOneRound`` > ``build_tree`` >
  ``grow_tree``, then ``eval``; ``predict``), and its trees and level
  calls equal the untraced run's;
- the ``Monitor`` adapter feeds the registry and the trace; ``comms``
  counts operations and bytes, and its byte counts are the port's int64
  wire; ``TrainingTelemetry`` records the JAX package's gauges with its
  values for the same model; ``rounds_total`` counts ``update`` and
  ``update_many`` rounds.
"""

import json
import time

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu.observability import metrics as jmetrics
from xgboost_tpu.observability import trace as jtrace
from xgboost_tpu_torch.observability import comms, metrics, trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    monkeypatch.delenv("XGBTPU_TRACE", raising=False)
    trace.reset()
    jtrace.reset()
    yield
    trace.reset()
    jtrace.reset()


def _data(n=400, F=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rng.randn(F)) > 0).astype(np.float32)
    return X, y


# ---------------------------------------------------------------- metrics

def _registry_script(reg):
    reg.counter("rounds_total", "rounds").inc()
    reg.counter("rounds_total").inc(4)
    reg.gauge("depth", "tree depth").set(6)
    reg.gauge("ratio").set(0.125)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.5, 50.0, 0.1):
        h.observe(v)
    d = reg.histogram("round_seconds", "Wall time per boosting round")
    for v in np.linspace(1e-4, 3.0, 17):
        d.observe(float(v))
    ops = reg.counter("collective_ops_total", "ops")
    ops.labels(op="psum_hist").inc(7)
    ops.labels(op="process_allgather").inc()
    by = reg.counter("collective_bytes_total", "bytes")
    by.labels(op="psum_hist").inc(12902424)
    g = reg.gauge("eval_score", "Latest eval metric value")
    g.labels(data="val", metric="auc").set(0.8396201)
    g.labels(data="val", metric="logloss").set(1e-7)
    with pytest.raises(ValueError):
        reg.gauge("rounds_total")
    with pytest.raises(ValueError):
        reg.counter("rounds_total").inc(-1)


def test_registry_exposition_byte_equal_to_jax():
    mine, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _registry_script(mine)
    _registry_script(theirs)
    text = mine.exposition()
    assert text == theirs.exposition()
    assert "# TYPE rounds_total counter" in text
    assert 'collective_ops_total{op="psum_hist"} 7' in text
    assert 'lat_seconds_bucket{le="+Inf"} 4' in text
    snap = mine.snapshot()
    assert json.dumps(snap, sort_keys=True) == json.dumps(
        theirs.snapshot(), sort_keys=True)
    assert snap["lat_seconds"]["series"][0]["count"] == 4
    mine.reset()
    assert mine.exposition() == ""


def test_registry_quantiles_match_jax():
    mine, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    rng = np.random.RandomState(3)
    for reg in (mine, theirs):
        h = reg.histogram("x_seconds")
        for v in rng.exponential(0.05, 500):
            h.observe(float(v))
        rng = np.random.RandomState(3)
    a = mine.histogram("x_seconds").labels()
    b = theirs.histogram("x_seconds").labels()
    for q in (0.5, 0.9, 0.99):
        assert a.quantile(q) == b.quantile(q)


# ---------------------------------------------------------------- tracing

def test_disabled_span_is_shared_noop():
    assert not trace.enabled()
    s1 = trace.span("a", k=1)
    s2 = trace.span("b")
    assert s1 is s2
    with s1:
        pass
    trace.instant("nothing")
    assert trace.flush() is None
    assert len(trace._buffer) == 0


def test_span_nesting_flush_and_chrome_format(tmp_path):
    out = tmp_path / "t.trace.json"
    xgbt.set_config(trace_path=str(out))
    try:
        assert trace.enabled()
        with trace.span("outer", phase="test"):
            with trace.span("inner"):
                time.sleep(0.002)
        trace.instant("mark", k=3)
        assert trace.flush() == str(out)
    finally:
        xgbt.set_config(trace_path=None)
    events = trace.load_trace(str(out))
    spans = {e["name"]: e for e in events if e.get("ph") == "X"}
    assert set(spans) == {"outer", "inner"}
    for e in spans.values():
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)
    o, i = spans["outer"], spans["inner"]
    assert i["dur"] >= 2000
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert any(e.get("ph") == "i" and e["name"] == "mark" for e in events)
    for ln in out.read_text().splitlines():
        if ln.strip() and ln.strip() != "[":
            json.loads(ln.rstrip(","))
    # the JAX package's reader takes the port's file
    assert [e["name"] for e in jtrace.load_trace(str(out))] == \
        [e["name"] for e in events]


def test_trace_env_var_wins(tmp_path, monkeypatch):
    out = tmp_path / "env.trace.json"
    monkeypatch.setenv("XGBTPU_TRACE", str(out))
    xgbt.set_config(trace_path=str(tmp_path / "config.json"))
    try:
        with trace.span("env_span"):
            pass
        assert trace.flush() == str(out)
    finally:
        xgbt.set_config(trace_path=None)
    assert any(e["name"] == "env_span" for e in trace.load_trace(str(out)))


def test_ring_buffer_drops_oldest(tmp_path, monkeypatch):
    from xgboost_tpu_torch.observability import REGISTRY

    monkeypatch.setenv("XGBTPU_TRACE", str(tmp_path / "rb.json"))
    cap = trace._buffer.maxlen
    base = trace.dropped_count()
    fam = REGISTRY.counter("trace_events_dropped_total")
    before = fam.value
    for k in range(cap + 10):
        with trace.span("s", k=k):
            pass
    assert trace.dropped_count() - base == 10
    assert fam.value - before == 10
    assert len(trace._buffer) == cap


def _x_events(path):
    return [e for e in jtrace.load_trace(str(path)) if e.get("ph") == "X"]


def _nesting(events, slack=2):
    """(name, parent name) per span in exit order: the parent is the
    shortest span whose interval holds the span's (within ``slack`` us of
    the floor rounding of the microsecond stamps)."""
    out = []
    for e in events:
        best = None
        for p in events:
            if p is e or p["dur"] <= e["dur"]:
                continue
            if p["ts"] <= e["ts"] and \
                    e["ts"] + e["dur"] <= p["ts"] + p["dur"] + slack:
                if best is None or p["dur"] < best["dur"]:
                    best = p
        out.append((e["name"], best["name"] if best else None))
    return out


def _run(pkg, X, y, **kw):
    d = pkg.DMatrix(X, y, **kw)
    dv = pkg.DMatrix(X[:100], y[:100], **kw)
    bst = pkg.train({"objective": "binary:logistic", "max_depth": 3,
                     "max_bin": 16, "eval_metric": "logloss"}, d, 3,
                    evals=[(dv, "val")], verbose_eval=False)
    bst.predict(dv)
    return bst


def test_traced_run_matches_jax_span_names_and_nesting(tmp_path,
                                                       monkeypatch):
    from xgboost_tpu_torch.tree import hist_kernel as thk

    calls = []
    plain = thk._fused_level_plain

    def counted(*a, **k):
        calls.append(k.get("K"))
        return plain(*a, **k)

    monkeypatch.setattr(thk, "_fused_level_plain", counted)
    X, y = _data()
    untraced = _run(xgbt, X, y, device="cpu")
    untraced_calls = list(calls)
    calls.clear()

    monkeypatch.setenv("XGBTPU_TRACE", str(tmp_path / "port.json"))
    traced = _run(xgbt, X, y, device="cpu")
    assert trace.flush() == str(tmp_path / "port.json")
    monkeypatch.setenv("XGBTPU_TRACE", str(tmp_path / "jax.json"))
    _run(xgb, X, y)
    assert jtrace.flush() == str(tmp_path / "jax.json")

    port, theirs = _x_events(tmp_path / "port.json"), \
        _x_events(tmp_path / "jax.json")
    # the port's own step/<op> spans (cat="step": the level loop's ops,
    # _level_update's sub-ops, the eval walk and metric, the one-hot plan)
    # aside, the spans are the JAX package's
    mine = [e for e in port if e.get("cat") != "step"]
    assert [e["name"] for e in mine] == [e["name"] for e in theirs]
    assert _nesting(mine) == _nesting(theirs)
    lu = "step/level_update"
    parents = {
        **{f"step/{op}": {"grow_tree"} for op in (
            "prep", "level_hist", "level_update", "level_partition",
            "finalize", "leaf_delta")},
        **{f"{lu}/{op}": {lu} for op in (
            "with_missing", "eval_splits", "heap_write")},
        f"{lu}/scan": {f"{lu}/with_missing", f"{lu}/eval_splits", lu},
        "step/eval_walk": {"eval"}, "step/eval_metric": {"eval"},
        "step/onehot": {"BoostOneRound"}}
    nested = [(n, p) for n, p in _nesting(port) if n.startswith("step/")]
    assert {n for n, _ in nested} == set(parents)
    for name, parent in nested:
        assert parent in parents[name], (name, parent)
    assert sum(n == f"{lu}/scan" for n, _ in nested) == 2 * 3 * 3
    names = {e["name"] for e in mine}
    assert {"train", "round", "update", "GetGradient", "GetBinned",
            "dmatrix_build", "sketch", "quantize", "BoostOneRound",
            "build_tree", "grow_tree", "eval", "predict"} <= names
    assert dict(_nesting(mine))["grow_tree"] == "build_tree"
    # the same trees and the same level calls as the untraced run
    assert traced.save_raw() == untraced.save_raw()
    assert calls == untraced_calls and len(calls) == 3 * 3


def test_traced_lossguide_run_matches_jax_span_names(tmp_path, monkeypatch):
    X, y = _data(seed=2)
    p = {"objective": "binary:logistic", "grow_policy": "lossguide",
         "max_leaves": 8, "max_bin": 16}
    monkeypatch.setenv("XGBTPU_TRACE", str(tmp_path / "port.json"))
    xgbt.train(p, xgbt.DMatrix(X, y, device="cpu"), 2, verbose_eval=False)
    trace.flush()
    monkeypatch.setenv("XGBTPU_TRACE", str(tmp_path / "jax.json"))
    xgb.train(p, xgb.DMatrix(X, y), 2, verbose_eval=False)
    jtrace.flush()
    mine = [e for e in _x_events(tmp_path / "port.json")
            if e["name"] != "grow_tree"]
    theirs = _x_events(tmp_path / "jax.json")
    assert [e["name"] for e in mine] == [e["name"] for e in theirs]
    assert [e["args"].get("policy") for e in mine
            if e["name"] == "build_tree"] == ["lossguide"] * 2


# ------------------------------------------------------ monitor and comms

def test_monitor_adapter_feeds_registry_and_trace(tmp_path, monkeypatch):
    from xgboost_tpu_torch.observability import REGISTRY
    from xgboost_tpu_torch.utils import Monitor

    out = tmp_path / "m.trace.json"
    monkeypatch.setenv("XGBTPU_TRACE", str(out))
    mon = Monitor("TestMon")
    with mon.section("Phase"):
        pass
    mon.start("open_only")  # never stopped: ignored
    assert mon.stats["Phase"][1] == 1
    assert "Phase" in mon.report()
    child = REGISTRY.histogram("monitor_seconds").labels(
        monitor="TestMon", section="Phase")
    assert child.count >= 1
    trace.flush()
    ev = [e for e in trace.load_trace(str(out)) if e.get("name") == "Phase"]
    assert ev and ev[0]["args"] == {"monitor": "TestMon"}


def test_comms_record_and_snapshot():
    before = comms.snapshot().get("allreduce", {"ops": 0, "bytes": 0})
    comms.record("allreduce", 4096)
    comms.record("allreduce", 100, n_ops=3)
    after = comms.snapshot()["allreduce"]
    assert after["ops"] - before["ops"] == 4
    assert after["bytes"] - before["bytes"] == 4196
    assert comms.kind_of("level_hist") == comms.kind_of(
        "lossguide_hist") == comms.kind_of("root_totals") == "psum_hist"
    assert comms.kind_of("grad_scale") == "pmax"
    assert comms.kind_of("metric_reduce") == "metric_reduce"
    # one record per call, read per kind (summed over sites) and per site
    sites = comms.snapshot(by="site")
    kinds = comms.snapshot()
    comms.record("level_hist", 800, seconds=0.25)
    comms.record("root_totals", 16)
    comms.record("hoist_plan", 40, op="process_allgather")
    sites2, kinds2 = comms.snapshot(by="site"), comms.snapshot()

    def grew(a, b, key, field):
        return b[key][field] - a.get(key, {}).get(field, 0.0)

    assert grew(sites, sites2, "level_hist", "bytes") == 800
    assert grew(sites, sites2, "level_hist", "seconds") == 0.25
    assert grew(sites, sites2, "root_totals", "ops") == 1
    assert grew(kinds, kinds2, "psum_hist", "bytes") == 816
    assert grew(kinds, kinds2, "process_allgather", "bytes") == 40
    assert "seconds" not in kinds2["psum_hist"]


def test_comms_bytes_are_the_int64_wire():
    """A depthwise tree at depth 6, 50 features, 256 bins reduces six
    int64 level histograms, the int64 root totals and the float32 scale:
    12,902,424 bytes (``chip_smoke.py`` checks the card's recorded bytes
    against it)."""
    assert comms.grow_psum_bytes(6, 50, 256) == 12_902_424
    assert comms.grow_psum_bytes(1, 3, 16) == 24 + 3 * 2 * 16 * 8


# ------------------------------------------------------------ callbacks

def test_training_telemetry_records_the_jax_packages_gauges():
    from xgboost_tpu.callback import TrainingTelemetry as JTelemetry
    from xgboost_tpu_torch.callback import TrainingTelemetry

    X, y = _data(seed=4)
    regs = []
    for pkg, cls, kw in ((xgbt, TrainingTelemetry, {"device": "cpu"}),
                         (xgb, JTelemetry, {})):
        reg = (metrics if pkg is xgbt else jmetrics).MetricsRegistry()
        d = pkg.DMatrix(X, y, **kw)
        res = {}
        pkg.train({"objective": "binary:logistic", "max_depth": 3,
                   "max_bin": 16, "eval_metric": "auc"}, d, 3,
                  evals=[(d, "train")], evals_result=res,
                  verbose_eval=False, callbacks=[cls(registry=reg)])
        regs.append(reg)
    mine, theirs = regs
    for name in ("trees_total", "tree_depth", "tree_leaves"):
        assert mine.gauge(name).value == theirs.gauge(name).value, name
    assert mine.gauge("trees_total").value == 3
    a = mine.histogram("split_gain").labels()
    b = theirs.histogram("split_gain").labels()
    assert a.count == b.count > 0
    np.testing.assert_allclose(a.sum, b.sum, rtol=1e-5)
    auc = mine.gauge("eval_score").labels(data="train", metric="auc")
    jauc = theirs.gauge("eval_score").labels(data="train", metric="auc")
    assert abs(auc.value - jauc.value) <= 1e-6
    assert mine.histogram("round_seconds").labels().count == 3


def test_training_telemetry_leaves_the_model_on_the_device():
    """The callback reads the last tree alone: the model keeps its device
    entries, so the next round's walk is the untelemetered run's."""
    from xgboost_tpu_torch.callback import TrainingTelemetry

    X, y = _data(seed=5)
    d = xgbt.DMatrix(X, y, device="cpu")
    p = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16}
    a = xgbt.train(p, d, 3, verbose_eval=False,
                   callbacks=[TrainingTelemetry(metrics.MetricsRegistry())])
    b = xgbt.train(p, d, 3, verbose_eval=False)
    assert not any(type(e).__name__ == "RegTree"
                   for e in a._gbm.model._entries)
    assert a.save_raw() == b.save_raw()


def test_rounds_total_counts_update_paths():
    from xgboost_tpu_torch.observability import REGISTRY

    X, y = _data(seed=6)
    d = xgbt.DMatrix(X, y, device="cpu")
    fam = REGISTRY.counter("rounds_total")
    before = fam.value
    bst = xgbt.Booster({"max_depth": 2, "max_bin": 16}, [d], device="cpu")
    bst.update(d, 0)
    bst.update_many(d, 1, 4, chunk=3)
    assert fam.value - before == 5
    assert bst.num_boosted_rounds() == 5
