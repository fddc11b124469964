"""The port's per-level grow profiler
(``xgboost_tpu_torch.observability.kernelprof``) against the JAX package's.

Both packages run on the same numpy data (4000 x 12, ``binary:logistic``,
depth 4, ``max_bin`` 32, 5 rounds), the JAX package pinned to its
per-level float route
(``XGBTPU_DISPATCH=tree_grow=level,sibling_sub=off,hist_acc=float``), the
port on the CPU:

- ``should_sample`` answers as the JAX package's for every spec of its own
  tests, malformed ones included;
- a port run profiling every round saves the unprofiled run's bytes, and
  its trees equal the JAX package's at the tolerance of the port's parity
  test of the same round loop (``tests/test_torch_pipeline.py``:
  structure, features and conditions exact, base weights within 1e-6 for
  the packages' float sums) and margins within 1e-5;
- ``rounds=1,3``: each sampled round's ``grow_detail`` holds the JAX
  record's multiset of ``(op, depth, count)`` (12 brackets, 12 host
  syncs), its keys and the op keys, ``wall = host + inflight`` within
  2e-6, ``impl`` ``plain`` on the CPU, the round's quantiser exponents;
  unsampled rounds carry none;
- paged, row-group, lossguide and ``update_many`` rounds carry none;
- ``host_syncs_total`` moves and the ``grow/*`` spans (the JAX package's
  names) appear only on profiled rounds, nested under their ``round``;
- the ≤2% unprofiled-probe pin;
- ``format_grow_detail``, ``format_grow_diff`` and ``main`` print the
  JAX package's text for the same records, and each package's
  ``grow-report`` reads the other's flight sink.
"""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu.observability import RECORDER as JRECORDER
from xgboost_tpu.observability import kernelprof as jkp
from xgboost_tpu.observability import trace as jtrace
from xgboost_tpu_torch.observability import RECORDER, REGISTRY, flight
from xgboost_tpu_torch.observability import kernelprof as tkp
from xgboost_tpu_torch.observability import trace

torch.set_num_threads(1)

PARAMS = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32,
          "verbosity": 0}
ROUNDS = 5
CPU = {"device": "cpu"}
SITES = ("prep", "level_hist", "level_update", "level_partition",
         "finalize", "leaf_delta")


def _data(n=4000, F=12, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = ((X @ rng.randn(F)) > 0).astype(np.float32)
    return X, y


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("XGBTPU_KERNEL_PROF", "XGBTPU_TRACE", "XGBTPU_FLIGHT"):
        monkeypatch.delenv(var, raising=False)
    for rec, tr in ((RECORDER, trace), (JRECORDER, jtrace)):
        rec.reset()
        tr.reset()
    yield
    tkp.disarm()  # a failing test must not leave a profile armed
    jkp.disarm()
    for rec, tr in ((RECORDER, trace), (JRECORDER, jtrace)):
        rec.reset()
        tr.reset()


def _rounds(rec):
    return {r["round"]: r for r in rec.records() if r.get("t") == "round"}


def _train(spec=None, params=PARAMS, rounds=ROUNDS, **kw):
    """A port run on the CPU, ``XGBTPU_KERNEL_PROF=spec`` (unset: None)."""
    X, y = _data()
    with pytest.MonkeyPatch.context() as mp:
        if spec is None:
            mp.delenv("XGBTPU_KERNEL_PROF", raising=False)
        else:
            mp.setenv("XGBTPU_KERNEL_PROF", spec)
        return xgbt.train(params, xgbt.DMatrix(X, y, **CPU), rounds,
                          verbose_eval=False, **kw)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX run, pinned to the per-level float route, profiling rounds
    1 and 3 and traced: its model, round records, exposition and spans."""
    trace_file = str(tmp_path_factory.mktemp("jtrace") / "trace.json")
    X, y = _data()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        mp.setenv("XGBTPU_KERNEL_PROF", "rounds=1,3")
        mp.setenv("XGBTPU_TRACE", trace_file)
        mp.delenv("XGBTPU_FLIGHT", raising=False)
        jax.clear_caches()
        JRECORDER.reset()
        jtrace.reset()
        try:
            bst = xgb.train(PARAMS, xgb.DMatrix(X, label=y), ROUNDS,
                            verbose_eval=False)
            jtrace.flush()
            rounds = _rounds(JRECORDER)
            events = jtrace.load_trace(trace_file)
        finally:
            JRECORDER.reset()
            jtrace.reset()
    jax.clear_caches()
    return {"bst": bst, "rounds": rounds, "events": events, "X": X}


# ------------------------------------------------------ sampling grammar

@pytest.mark.parametrize("spec", [None, "every=2", "every=1", "rounds=1,3",
                                  "rounds=0, 5", "", "every", "every=0",
                                  "every=x", "rounds=", "rounds=-1",
                                  "sometimes=3"])
def test_should_sample_matches_jax(monkeypatch, spec):
    """Well-formed specs sample the JAX package's rounds; a malformed one
    (or none) samples nothing, in both."""
    if spec is None:
        monkeypatch.delenv("XGBTPU_KERNEL_PROF", raising=False)
    else:
        monkeypatch.setenv("XGBTPU_KERNEL_PROF", spec)
    mine = [i for i in range(12) if tkp.should_sample(i)]
    assert mine == [i for i in range(12) if jkp.should_sample(i)]
    if spec in ("every=2", "rounds=1,3"):
        assert mine == ([0, 2, 4, 6, 8, 10] if spec == "every=2"
                        else [1, 3])


# ------------------------------------------- bit-identity + JAX trees

def _trees(bst):
    return json.loads(bst.save_raw())["learner"]["gradient_booster"][
        "model"]["trees"]


def test_profiled_run_is_byte_equal_and_matches_jax_trees(jax_run):
    clean = _train()
    profiled = _train("every=1")
    assert profiled.save_raw() == clean.save_raw(), \
        "a profiled round diverged from the unprofiled loop"
    jt, tt = _trees(jax_run["bst"]), _trees(profiled)
    assert len(jt) == len(tt) == ROUNDS
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        internal = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[internal],
            np.asarray(b["split_conditions"], np.float32)[internal])
        np.testing.assert_allclose(b["base_weights"], a["base_weights"],
                                   rtol=1e-6, atol=1e-6)
    X = jax_run["X"]
    np.testing.assert_allclose(
        profiled.predict(xgbt.DMatrix(X, **CPU), output_margin=True),
        jax_run["bst"].predict(xgb.DMatrix(X), output_margin=True),
        rtol=1e-5, atol=1e-5)


def test_grow_detail_matches_the_jax_record(jax_run):
    _train("rounds=1,3")
    mine, theirs = _rounds(RECORDER), jax_run["rounds"]
    assert set(mine) == set(theirs) == set(range(ROUNDS))
    for i in (0, 2, 4):
        assert "grow_detail" not in mine[i], \
            "unsampled rounds must not carry grow_detail"
        assert "grow_detail" not in theirs[i]
    for i in (1, 3):
        gd, jgd = mine[i]["grow_detail"], theirs[i]["grow_detail"]
        assert set(gd) == set(jgd)
        assert (gd["round"], gd["driver"], gd["trees"]) == (i, tkp.DRIVER,
                                                            1)
        assert tkp.DRIVER == jkp.DRIVER
        assert (gd["route"], gd["sibling_sub"], gd["hist_acc"]) == \
            ("level", False, "quant")

        def shape(rec):
            return sorted((b["op"], b["depth"], b["count"])
                          for b in rec["ops"])

        assert shape(gd) == shape(jgd)
        assert len(gd["ops"]) == 12 and gd["host_syncs"] == 12
        assert gd["host_syncs"] == jgd["host_syncs"]
        for b, jb in zip(gd["ops"], jgd["ops"]):
            assert set(b) == set(jb)
            assert b["impl"] == "plain"
            assert b["wall_s"] >= 0 and b["host_s"] >= 0
            assert abs(b["wall_s"] - b["host_s"] - b["inflight_s"]) < 2e-6
        assert abs(gd["sum_s"] - sum(b["wall_s"] for b in gd["ops"])) < 1e-3
        qs = gd["quant_scales"]
        assert set(qs) == {"g_exp", "h_exp"}
        assert all(isinstance(v, int) for v in qs.values())
        # record order: by depth, then op name (the JAX package's sort)
        assert [(b["depth"], b["op"]) for b in gd["ops"]] == \
            [(b["depth"], b["op"]) for b in jgd["ops"]]


def test_quant_scales_are_the_trees_grid():
    """``quant_scales`` is the grid ``quantize_gradients`` chose for the
    sampled tree (the port's 30-bit grid: ``E = 30 - frexp exponent``)."""
    from xgboost_tpu_torch.tree import grow_fused as tgf
    from xgboost_tpu_torch.tree import hist_kernel as thk
    from xgboost_tpu_torch.tree.grow import GrowParams

    rng = np.random.RandomState(3)
    n, F, B = 512, 4, 16
    bins = torch.as_tensor(rng.randint(0, B, (n, F)).astype(np.uint8))
    g = torch.as_tensor(rng.randn(n).astype(np.float32) * 3.0)
    h = torch.as_tensor(rng.rand(n).astype(np.float32) * 0.25)
    cuts = torch.as_tensor(np.sort(rng.randn(F, B).astype(np.float32), 1))
    cfg = GrowParams(max_depth=3)
    tkp.arm(0)
    tree = tkp.grow_tree_fused_profiled(bins, g, h, cuts, 0.3, 0.0, cfg)
    rec = tkp.disarm()
    exp = thk.quantize_gradients(g, h).exp.tolist()
    assert rec["quant_scales"] == {"g_exp": exp[0], "h_exp": exp[1]}
    assert exp[0] == 30 - int(np.frexp(np.abs(g.numpy()).max())[1])
    plain = tgf.grow_tree_fused(bins, g, h, cuts, 0.3, 0.0, cfg)
    for a, b in zip(tree, plain):
        assert torch.equal(a, b)


# ------------------------------------------------------ uncovered rounds

def _paged_matrix(tmp_path):
    X, y = _data(n=3000)

    class It(xgbt.DataIter):
        def __init__(self):
            super().__init__()
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self, input_data):
            if self.i >= 3:
                return 0
            lo = self.i * 1000
            input_data(data=X[lo:lo + 1000], label=y[lo:lo + 1000])
            self.i += 1
            return 1

    return xgbt.ExternalMemoryQuantileDMatrix(
        It(), cache_prefix=str(tmp_path / "pages"), max_bin=32,
        page_rows=1024, **CPU)


@pytest.mark.parametrize("case", ["paged", "lossguide", "update_many",
                                  "row_group"])
def test_uncovered_rounds_carry_no_grow_detail(case, tmp_path, monkeypatch):
    monkeypatch.setenv("XGBTPU_KERNEL_PROF", "every=1")
    if case in ("paged", "lossguide"):
        params = dict(PARAMS)
        if case == "lossguide":
            params.update(grow_policy="lossguide", max_leaves=8)
            d = xgbt.DMatrix(*_data(), **CPU)
        else:
            d = _paged_matrix(tmp_path)
        xgbt.train(params, d, 2, verbose_eval=False)
        recs = _rounds(RECORDER)
        assert len(recs) == 2
        assert not any("grow_detail" in r for r in recs.values())
        return
    if case == "update_many":
        d = xgbt.DMatrix(*_data(), **CPU)
        bst = xgbt.Booster(PARAMS, cache=[d], device="cpu")
        tkp.arm(0)
        bst.update_many(d, 0, 2)
        assert tkp.active(), "update_many must keep the armed profile"
        assert tkp.disarm() is None
        return
    # a row group of two ranks whose reductions are the identity: the
    # grow falls back to the unprofiled loop and records nothing
    import torch.distributed as dist

    from xgboost_tpu_torch.parallel import RowGroup
    from xgboost_tpu_torch.tree import grow_fused as tgf
    from xgboost_tpu_torch.tree.grow import GrowParams

    monkeypatch.setattr(dist, "all_reduce", lambda t, op=None, group=None:
                        None)
    group = RowGroup(group="device group", host_group="host group", rank=0,
                     world_size=2, device=torch.device("cpu"),
                     backend="gloo")
    rng = np.random.RandomState(1)
    bins = torch.as_tensor(rng.randint(0, 16, (300, 5)).astype(np.uint8))
    g = torch.as_tensor(rng.randn(300).astype(np.float32))
    h = torch.ones(300)
    cuts = torch.as_tensor(np.sort(rng.randn(5, 16).astype(np.float32), 1))
    cfg = GrowParams(max_depth=3)
    tkp.arm(0)
    tree = tkp.grow_tree_fused_profiled(bins, g, h, cuts, 0.3, 0.0, cfg,
                                        group=group)
    assert tkp.disarm() is None
    plain = tgf.grow_tree_fused(bins, g, h, cuts, 0.3, 0.0, cfg)
    for a, b in zip(tree, plain):
        assert torch.equal(a, b)


def test_disarm_without_buckets_returns_none():
    for pkg in (tkp, jkp):
        pkg.arm(7)
        assert pkg.active()
        assert pkg.disarm() is None
        assert not pkg.active()


# ------------------------------------------- host syncs + grow spans

def _sync_counts():
    fam = REGISTRY.get("host_syncs_total")
    if fam is None:
        return None
    return {labels["site"]: child.value for labels, child in fam.series()}


def test_host_sync_counter_and_grow_spans(jax_run, tmp_path, monkeypatch):
    """``host_syncs_total{site=}`` and the ``cat="grow"`` spans come only
    from profiled rounds: an unprofiled run leaves the series as it was
    (absent, in a process that never profiled), a run profiling round 2
    adds one sync per bracket, and its spans (the JAX package's names)
    nest inside round 2's span."""
    before = _sync_counts()
    _train()
    assert _sync_counts() == before
    out = tmp_path / "trace.json"
    monkeypatch.setenv("XGBTPU_TRACE", str(out))
    trace.reset()
    _train("rounds=2", rounds=3)
    after = _sync_counts()
    per_tree = {"prep": 1, "level_hist": 4, "level_update": 4,
                "level_partition": 1, "finalize": 1, "leaf_delta": 1}
    assert after == {s: (before or {}).get(s, 0) + per_tree[s]
                     for s in SITES}
    exp = REGISTRY.exposition()
    for site in SITES:
        assert f'host_syncs_total{{site="{site}"}}' in exp
    trace.flush()
    events = trace.load_trace(str(out))
    grow = [e for e in events
            if e.get("ph") == "X" and e.get("cat") == "grow"]
    jgrow = {e["name"] for e in jax_run["events"]
             if e.get("ph") == "X" and e.get("cat") == "grow"}
    assert {e["name"] for e in grow} == jgrow == {f"grow/{s}"
                                                  for s in SITES}
    assert len(grow) == 12
    assert all("depth" in e["args"] and e["args"]["impl"] == "plain"
               for e in grow)
    rnd = next(e for e in events if e.get("ph") == "X"
               and e.get("name") == "round"
               and e.get("args", {}).get("iteration") == 2)
    for e in grow:
        assert rnd["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= rnd["ts"] + rnd["dur"] + 1, (e, rnd)
    names = [e["name"] for e in events if e.get("ph") == "X"]
    assert names.count("grow_tree") == 3  # the profiled tree's included
    from xgboost_tpu_torch.observability.report import (format_report,
                                                        summarize)
    txt = format_report(summarize(events))
    assert "grow breakdown (kernel-profiled substages):" in txt
    assert "grow/level_hist" in txt


# ------------------------------------------------------------- perf pin

def test_unprofiled_overhead_at_most_2pct_of_round():
    """With XGBTPU_KERNEL_PROF unset the profiler costs one env probe per
    round (and an ``active()`` check per tree): per-cycle cost (best of 3
    batches) against the median round wall of a small run."""
    X, y = _data(n=600, F=6)
    xgbt.train({"max_depth": 3, "max_bin": 16, "verbosity": 0},
               xgbt.DMatrix(X, y, **CPU), 30, verbose_eval=False)
    walls = [r["wall_s"] for r in RECORDER.records()
             if r.get("t") == "round"][-30:]
    round_s = sorted(walls)[len(walls) // 2]
    per_cycle = float("inf")
    for _ in range(3):
        n = 1000
        t0 = time.perf_counter()
        for i in range(n):
            tkp.should_sample(i)
            tkp.active()
        per_cycle = min(per_cycle, (time.perf_counter() - t0) / n)
    assert per_cycle < 0.02 * round_s, (
        f"kernelprof per-round probe {per_cycle * 1e6:.1f}us exceeds 2% "
        f"of a {round_s * 1e3:.2f}ms round")


# ----------------------------------------------------------- grow-report

def _fake_record(round_idx=3, route="tree_grow", hist_wall=0.02,
                 impl="native"):
    return {
        "round": round_idx, "driver": jkp.DRIVER, "trees": 1,
        "route": route, "sibling_sub": route == "tree_grow",
        "host_syncs": 3, "sum_s": 0.01 + hist_wall, "gap_s": 0.001,
        "ops": [
            {"op": "prep", "depth": -1, "impl": "xla", "count": 1,
             "wall_s": 0.01, "host_s": 0.009, "inflight_s": 0.001,
             "gap_s": 0.0},
            {"op": "level_hist", "depth": 0, "impl": impl, "count": 1,
             "wall_s": hist_wall, "host_s": hist_wall - 0.001,
             "inflight_s": 0.001, "gap_s": 0.001},
        ],
    }


def _records():
    """Records to render: the port's own sampled rounds and the JAX
    package's shapes (one-dispatch route with and without the quant
    replay, a per-level one, and one older than the route field)."""
    _train("rounds=1,3")
    mine = [r["grow_detail"] for r in _rounds(RECORDER).values()
            if "grow_detail" in r]
    quant = dict(_fake_record(), hist_acc="quant",
                 quant_scales={"g_exp": 18, "h_exp": 19})
    legacy = _fake_record()
    del legacy["route"], legacy["sibling_sub"]
    no_sub = dict(_fake_record(), sibling_sub=False)
    return mine + [_fake_record(), _fake_record(route="level"), quant,
                   legacy, no_sub]


def test_format_grow_detail_matches_jax():
    recs = _records()
    assert len(recs) == 7
    for rec in recs:
        for grow_s in (None, 0.032, rec["sum_s"] * 1.05):
            assert tkp.format_grow_detail(rec, grow_s) == \
                jkp.format_grow_detail(rec, grow_s)
    txt = tkp.format_grow_detail(recs[0], 0.05)
    assert "route=level" in txt and "plain" in txt
    assert "host syncs 12" in txt


def test_format_grow_diff_matches_jax():
    recs = _records()
    pairs = [(recs[0], recs[1]), (_fake_record(), _fake_record(
        hist_wall=0.005, impl="cuda:D")), (recs[0], _fake_record()),
        (_fake_record(route="level"), _fake_record())]
    texts = []
    for ra, rb in pairs:
        sides = []
        for pkg in (tkp, jkp):
            agg_a, rounds_a = pkg._aggregate_ops([{"grow_detail": ra}])
            agg_b, rounds_b = pkg._aggregate_ops([{"grow_detail": rb}])
            sides.append(pkg.format_grow_diff(agg_a, rounds_a, "A", agg_b,
                                              rounds_b, "B"))
        assert sides[0] == sides[1]
        texts.append(sides[0])
    assert "*" not in texts[0]  # the port's two rounds: the same impls
    line = next(ln for ln in texts[1].splitlines() if "level_hist" in ln)
    assert "native->cuda:D" in line and line.endswith(" *")
    assert "(1 row(s))" in texts[1]


def _write_sink(root, recs):
    d = root / "obs" / "rank0"
    d.mkdir(parents=True)
    with open(d / "flight.jsonl", "w") as f:
        f.write(json.dumps({"t": "meta", "rank": 0}) + "\n")
        f.write(json.dumps({"t": "round", "round": 2, "stages": {}}) + "\n")
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
        f.write('{"t": "round", "round": 4, "stag')  # torn mid-write
    return str(root)


def _both_mains(argv, capsys):
    out = []
    for pkg in (tkp, jkp):
        rc = pkg.main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_grow_report_main_matches_jax(tmp_path, capsys):
    """A torn sink, ``--round``, ``--diff`` and sinks with no sampled
    records: the same exit codes and standard output as the JAX
    package's, and the same hint on standard error."""
    rec3 = {"t": "round", "round": 3, "wall_s": 0.04,
            "stages": {"grow": 0.032}, "grow_detail": _fake_record()}
    rec5 = {"t": "round", "round": 5, "wall_s": 0.04,
            "stages": {"grow": 0.03},
            "grow_detail": _fake_record(5, route="level", hist_wall=0.005,
                                        impl="cuda:D")}
    a = _write_sink(tmp_path / "a", [rec3, rec5])
    b = _write_sink(tmp_path / "b", [dict(rec3, grow_detail=_fake_record(
        hist_wall=0.004, impl="cuda:A"))])
    empty = _write_sink(tmp_path / "empty", [])
    flight_file = os.path.join(a, "obs", "rank0", "flight.jsonl")
    cases = [[a], [flight_file], [a, "--round", "3"], [a, "--round", "9"],
             ["--diff", a, b], ["--diff", a, b, "--round", "3"],
             ["--diff", a, b, "--round", "9"], ["--diff", a], [empty],
             [str(tmp_path / "nothing-here")]]
    for argv in cases:
        (trc, tout, terr), (jrc, jout, jerr) = _both_mains(argv, capsys)
        assert (trc, tout) == (jrc, jout), argv
        if "no sampled" in jerr:
            assert terr == jerr
    (trc, tout, _), _ = _both_mains([a], capsys)
    assert trc == 0 and "round 3: grow detail" in tout
    assert "round 5: grow detail" in tout
    for argv in ([], ["--help"]):
        (trc, _, terr), (jrc, _, jerr) = _both_mains(argv, capsys)
        assert trc == jrc
        assert terr.replace("xgboost_tpu_torch", "xgboost_tpu") == jerr


def test_grow_report_reads_either_packages_sink(jax_run, tmp_path, capsys):
    """The port's sink rendered by both packages' ``grow-report`` (and the
    command line), and a sink holding the JAX package's records rendered
    by the port's."""
    run = str(tmp_path / "port")
    flight.configure(run, rank=0)
    _train("rounds=1,3")
    RECORDER.reset()  # closes the sink
    (trc, tout, _), (jrc, jout, _) = _both_mains([run], capsys)
    assert trc == jrc == 0 and tout == jout
    assert tout.count("grow detail (instrumented-unrolled") == 2
    from xgboost_tpu_torch import cli as tcli
    assert tcli.cli_main(["grow-report", run, "--round", "3"]) == 0
    assert capsys.readouterr().out.startswith("round 3: grow detail")
    jrun = _write_sink(tmp_path / "jax", [jax_run["rounds"][i]
                                          for i in (1, 3)])
    (trc, tout, _), (jrc, jout, _) = _both_mains([jrun], capsys)
    assert trc == jrc == 0 and tout == jout
    assert "route=level" in tout
    (trc, tout, _), (jrc, jout, _) = _both_mains(["--diff", jrun, run],
                                                 capsys)
    assert trc == jrc == 0 and tout == jout
    assert "xla->plain" in tout
