"""The port's ``round_detail`` record and the step seam's three modes
(``xgboost_tpu_torch/observability/kernelprof.py``), on the CPU.

- a sampled round's ``round_detail`` holds ``_level_update``'s sub-ops at
  every depth (``scan.steps`` = 2B a level and tree) and the gradient, the
  eval walk and the metric once a round, the one-hot plan in round 0;
- the sub-ops' host time lies inside ``level_update``'s;
- profiling every round with the trace on, or tracing alone, leaves the
  trees byte-equal to an unprofiled, untraced run;
- the round-level brackets add nothing to ``grow_detail`` or
  ``host_syncs_total``;
- off (no trace, no profile) the seams read no clock and record nothing:
  the round's only clock reads are the Monitor sections';
- traced and unsampled, every op, sub-op and round-level op is a
  ``step/<op>`` span and nothing syncs or writes a ``grow/*`` span;
- a program span and ``torch.profiler``'s host events share one clock;
- ``grow-report --round-detail`` and ``trace-report --steps``.
"""

import json
import sys
import time

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch.observability import RECORDER, REGISTRY
from xgboost_tpu_torch.observability import kernelprof as tkp
from xgboost_tpu_torch.observability import report, trace
from xgboost_tpu_torch.utils import timer

torch.set_num_threads(1)

DEPTH, B, ROUNDS = 3, 16, 3
PARAMS = {"objective": "binary:logistic", "max_depth": DEPTH, "max_bin": B,
          "verbosity": 0}
SUB_OPS = ("level_update/with_missing", "level_update/eval_splits",
           "level_update/heap_write")
LOOP_OPS = ("prep", "level_hist", "level_update", "level_partition",
            "finalize", "leaf_delta")


def _data(n=1500, F=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = ((X @ rng.randn(F)) > 0).astype(np.float32)
    return X, y


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("XGBTPU_KERNEL_PROF", "XGBTPU_TRACE", "XGBTPU_FLIGHT"):
        monkeypatch.delenv(var, raising=False)
    RECORDER.reset()
    trace.reset()
    yield
    tkp.disarm()
    RECORDER.reset()
    trace.reset()


def _train(monkeypatch, spec=None, trace_file=None, rounds=ROUNDS,
           params=PARAMS):
    if spec is not None:
        monkeypatch.setenv("XGBTPU_KERNEL_PROF", spec)
    if trace_file is not None:
        monkeypatch.setenv("XGBTPU_TRACE", str(trace_file))
    X, y = _data()
    d = xgbt.DMatrix(X[:1200], y[:1200], device="cpu")
    v = xgbt.DMatrix(X[1200:], y[1200:], device="cpu")
    try:
        return xgbt.train(params, d, rounds, evals=[(v, "v")],
                          verbose_eval=False)
    finally:
        monkeypatch.delenv("XGBTPU_KERNEL_PROF", raising=False)
        monkeypatch.delenv("XGBTPU_TRACE", raising=False)


def _rounds():
    return {r["round"]: r for r in RECORDER.records() if r.get("t") == "round"}


def _by(rec):
    return {(b["op"], b["depth"]): b for b in rec["ops"]}


# ----------------------------------------------------------- the record

@pytest.mark.parametrize("trees", [1, 2])
def test_round_detail_holds_every_sub_op_and_round_op(monkeypatch, trees):
    _train(monkeypatch, "rounds=0,2",
           params=dict(PARAMS, num_parallel_tree=trees))
    recs = _rounds()
    assert "round_detail" not in recs[1]
    for i in (0, 2):
        rd = recs[i]["round_detail"]
        assert (rd["round"], rd["trees"]) == (i, trees)
        ops = _by(rd)
        for d in range(DEPTH):
            for op in SUB_OPS:
                assert ops[(op, d)]["count"] == trees
                assert ops[(op, d)]["inflight_s"] == 0.0
            scan = ops[("level_update/scan", d)]
            # one scan in with_missing, one in eval_splits, B bins each
            assert scan["count"] == 2 * trees
            assert scan["steps"] == 2 * B * trees
        for op in ("gradient", "eval_walk", "eval_metric"):
            assert ops[(op, -1)]["count"] == 1
            assert ops[(op, -1)]["impl"] == "plain"
        assert (("onehot", -1) in ops) == (i == 0)
        assert {k for k in ops if k[1] >= 0} == {
            (op, d) for op in SUB_OPS + ("level_update/scan",)
            for d in range(DEPTH)}
        fields = {"op", "depth", "impl", "count", "wall_s", "host_s",
                  "inflight_s", "gap_s"}
        for b in rd["ops"]:
            assert set(b) == fields | ({"steps"} if b["op"].endswith("scan")
                                       else set())
            assert abs(b["wall_s"] - b["host_s"] - b["inflight_s"]) < 2e-6


def test_sub_ops_lie_inside_level_update(monkeypatch):
    _train(monkeypatch, "every=1")
    for rec in _rounds().values():
        rd, gd = _by(rec["round_detail"]), _by(rec["grow_detail"])
        for d in range(DEPTH):
            lu = gd[("level_update", d)]["host_s"]
            subs = sum(rd[(op, d)]["host_s"] for op in SUB_OPS)
            assert subs <= lu + 2e-6, (d, subs, lu)
            scans = rd[("level_update/scan", d)]["host_s"]
            inner = (rd[("level_update/with_missing", d)]["host_s"]
                     + rd[("level_update/eval_splits", d)]["host_s"])
            assert scans <= inner + 2e-6


def test_round_brackets_leave_grow_detail_and_host_syncs_as_they_were(
        monkeypatch):
    fam = REGISTRY.get("host_syncs_total")
    before = ({} if fam is None else
              {lab["site"]: c.value for lab, c in fam.series()})
    _train(monkeypatch, "rounds=1")
    gd = _rounds()[1]["grow_detail"]
    per_tree = {"prep": 1, "level_hist": DEPTH, "level_update": DEPTH,
                "level_partition": 1, "finalize": 1, "leaf_delta": 1}
    assert gd["host_syncs"] == sum(per_tree.values())
    assert sorted((b["op"], b["depth"]) for b in gd["ops"]) == sorted(
        [(op, -1 if op == "prep" else DEPTH) for op in
         ("prep", "level_partition", "finalize", "leaf_delta")]
        + [(op, d) for op in ("level_hist", "level_update")
           for d in range(DEPTH)])
    after = {lab["site"]: c.value
             for lab, c in REGISTRY.get("host_syncs_total").series()}
    assert after == {s: before.get(s, 0) + n for s, n in per_tree.items()}


@pytest.mark.parametrize("spec", ["every=1", None])
def test_traced_and_profiled_trees_are_byte_equal(monkeypatch, tmp_path,
                                                  spec):
    clean = _train(monkeypatch)
    seen = _train(monkeypatch, spec, trace_file=tmp_path / "t.json")
    assert seen.save_raw() == clean.save_raw()
    assert trace.flush(str(tmp_path / "t.json"))


# ------------------------------------------------------------- off path

def test_off_path_reads_no_clock_and_records_nothing(monkeypatch):
    """No trace, no profile: the seams read no clock and write no trace
    record; the round's only ``perf_counter_ns`` reads are the Monitor
    sections' two each."""
    X, y = _data()
    d = xgbt.DMatrix(X[:1200], y[:1200], device="cpu")
    v = xgbt.DMatrix(X[1200:], y[1200:], device="cpu")
    bst = xgbt.Booster(PARAMS, cache=[d, v], device="cpu")
    bst.update(d, 0)  # the one-hot plan and first-use work outside the count
    bst.eval_set([(v, "v")], 0)

    def no_record(ev):
        raise AssertionError(f"trace record with the trace off: {ev}")

    monkeypatch.setattr(trace, "_record", no_record)
    callers, sections = [], []
    clock = time.perf_counter_ns

    def counted():
        f = sys._getframe(1)
        callers.append((f.f_code.co_filename, f.f_code.co_name))
        return clock()

    start = timer.Monitor.start

    def start_counted(self, name):
        sections.append(name)
        return start(self, name)

    monkeypatch.setattr(time, "perf_counter_ns", counted)
    monkeypatch.setattr(timer.Monitor, "start", start_counted)
    bst.update(d, 1)
    bst.eval_set([(v, "v")], 1)
    monkeypatch.undo()
    assert sections, "the round opened no Monitor section"
    assert {name for _, name in callers} <= {"start", "stop"}
    assert all(path == timer.__file__ for path, _ in callers)
    assert len(callers) == 2 * len(sections)


def test_level_update_off_calls_seq_cumsum_itself():
    """Off, ``_level_update`` hands ``seq_cumsum`` itself to the scans
    (no wrapper), as before the seam."""
    from xgboost_tpu_torch.tree import grow_fused as tgf

    seen = []
    orig = tgf.with_missing

    def spy(histC, Gtot, Htot, scan):
        seen.append(scan)
        return orig(histC, Gtot, Htot, scan=scan)

    rng = np.random.RandomState(3)
    bins = torch.as_tensor(rng.randint(0, B, (400, 4)).astype(np.uint8))
    g = torch.as_tensor(rng.randn(400).astype(np.float32))
    h = torch.ones(400)
    cuts = torch.as_tensor(np.sort(rng.randn(4, B).astype(np.float32), 1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgf, "with_missing", spy)
        tgf.grow_tree_fused(bins, g, h, cuts, 0.3, 0.0,
                            tgf.GrowParams(max_depth=DEPTH))
    assert seen == [tgf.seq_cumsum] * DEPTH


# ---------------------------------------------------------- traced mode

def test_traced_unsampled_rounds_write_step_spans(monkeypatch, tmp_path):
    def no_sync(*a, **k):
        raise AssertionError("an unsampled traced round synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    fam = REGISTRY.get("host_syncs_total")
    before = None if fam is None else [c.value for _, c in fam.series()]
    out = tmp_path / "t.json"
    _train(monkeypatch, trace_file=out)
    trace.flush(str(out))
    events = [e for e in trace.load_trace(str(out)) if e.get("ph") == "X"]
    assert not any(e.get("cat") == "grow" for e in events)
    fam = REGISTRY.get("host_syncs_total")
    assert (None if fam is None else [c.value for _, c in fam.series()]) \
        == before
    steps = {}
    for e in events:
        if e.get("cat") == "step":
            steps[e["name"]] = steps.get(e["name"], 0) + 1
    loop = {f"step/{op}": ROUNDS * (DEPTH if op in ("level_hist",
                                                    "level_update") else 1)
            for op in LOOP_OPS}
    subs = {f"step/{op}": ROUNDS * DEPTH for op in SUB_OPS}
    assert steps == {**loop, **subs,
                     "step/level_update/scan": 2 * ROUNDS * DEPTH,
                     "step/eval_walk": ROUNDS, "step/eval_metric": ROUNDS,
                     "step/onehot": 1}
    # the gradient keeps the Monitor's span alone
    assert sum(e["name"] == "GetGradient" for e in events) == ROUNDS
    assert all("depth" in e["args"] for e in events
               if e.get("cat") == "step")


def test_program_spans_share_the_profilers_clock(tmp_path):
    """A torch op run inside a program span starts, on the profiler's
    clock, inside the span mapped to unix time through ``clock_base`` (as
    ``portbench/devtrace.py`` maps it), within 1 ms."""
    a = torch.randn(128, 128)
    xgbt.set_config(trace_path=str(tmp_path / "t.json"))
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with trace.span("probe"):
                time.sleep(0.005)
                torch.mm(a, a)
                time.sleep(0.005)
        ev = next(e for e in trace._buffer if e["name"] == "probe")
    finally:
        xgbt.set_config(trace_path=None)
        trace.reset()
    base = trace.clock_base()["unix_ns"]
    s0 = base + ev["ts"] * 1000
    s1 = base + (ev["ts"] + ev["dur"]) * 1000
    starts = [int(e.start_ns()) for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert starts
    for t in starts:
        # the op starts 5 ms into the span and 5 ms before its end: two
        # clocks more than 1 ms apart would put it closer to either
        assert 4_000_000 <= t - s0 <= s1 - s0 - 4_000_000, (t - s0, s1 - s0)


# -------------------------------------------------------------- reports

def test_grow_report_prints_round_detail_on_request(monkeypatch, tmp_path,
                                                    capsys):
    from xgboost_tpu_torch.observability import flight

    run = str(tmp_path / "run")
    flight.configure(run, rank=0)
    _train(monkeypatch, "rounds=1")
    RECORDER.reset()  # closes the sink
    assert tkp.main([run]) == 0
    plain = capsys.readouterr().out
    assert "round detail" not in plain
    assert tkp.main([run, "--round-detail"]) == 0
    txt = capsys.readouterr().out
    assert txt.startswith(plain.rstrip("\n"))
    assert "round 1: round detail (1 tree(s)" in txt
    for op in SUB_OPS + ("level_update/scan", "gradient", "eval_walk",
                         "eval_metric"):
        assert op in txt
    assert f"({2 * B * DEPTH} steps); level_update host" in txt


def test_trace_report_steps_table_counts_nested_spans_once(tmp_path, capsys):
    def x(name, ts, dur, cat=None):
        e = {"name": name, "ph": "X", "ts": ts, "dur": dur, "tid": 0,
             "pid": 0}
        if cat:
            e["cat"] = cat
        return e

    events = [x("grow_tree", 0, 10_000),
              x("step/level_hist", 0, 2_000, "step"),
              x("step/level_update", 2_000, 7_000, "step"),
              x("step/level_update/with_missing", 2_000, 3_000, "step"),
              x("step/level_update/scan", 2_100, 2_500, "step"),
              x("step/level_update/eval_splits", 5_000, 3_000, "step"),
              x("eval", 10_000, 1_000),
              x("step/eval_walk", 10_000, 600, "step")]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(events))
    assert report.main([str(path)]) == 0
    plain = capsys.readouterr().out
    assert "step breakdown" not in plain
    assert report.main([str(path), "--steps"]) == 0
    txt = capsys.readouterr().out
    assert "step breakdown" in txt
    assert "step/level_update/scan" in txt and "step/eval_walk" in txt
    # 2 + 7 ms: the nested sub-ops and scans are not added again
    assert "level loop 9.000ms" in txt
    lines = txt.splitlines()
    first = lines.index(next(ln for ln in lines if "step breakdown" in ln))
    last = lines.index(next(ln for ln in lines
                            if ln.startswith("  level loop")))
    assert last - first == 7  # a row per step span name
    assert lines[:first] + lines[last + 1:] == plain.splitlines()
