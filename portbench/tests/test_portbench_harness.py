"""The harness's own arithmetic and discovery, on the CPU.

Run: ``python -m pytest portbench/tests -q``.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import devtrace, harness, judge, readers, traffic, work  # noqa: E402

SPEC = harness.benchmark()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_to_its_schema():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_is_found_by_its_name(name):
    c = harness.cell(name)
    assert c["traffic"]["name"] == name
    assert c["config"]["name"] == c["entry"]["config"] == c["traffic"]["config"]
    reported = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.reader(m["name"]))
    assert set(c["traffic"]["limits"]) == set(judge.CHECKS)


def test_every_metric_of_a_cell_is_reported_from_a_full_run():
    for name in CELLS:
        c = harness.cell(name)
        bucket = {"depth": 0, "host_s": 0.001, "wall_s": 0.002}
        run = harness.Run(
            shapes={"n": 1000, "F": 5, "B": 16, "depth": 6, "m_eval": 100,
                    "objective": c["config"]["params"]["objective"], "groups": 1},
            device_name="NVIDIA H100 80GB HBM3", setup_s=20.0, ingest_s=1.0, window_s=10.0, window_rounds=50,
            plain=(8.8, 44),
            profile={"busy_s": 0.1, "window_s": 0.4, "rounds": 3, "level_hist_s": 0.05,
                     "breakdown": {}},
            grow_details=[{"ops": [{"op": "level_update", "host_s": 0.002},
                                   {"op": "level_hist", "host_s": 0.001}]}],
            round_details=[{"round": 8, "trees": 1, "ops": [
                dict(bucket, op=op) for op in ("level_update/scan", "gradient",
                                               "eval_walk", "eval_metric")]}])
        for m in c["end_to_end"] + c["per_layer"]:
            v = harness.reader(m["name"])(run)
            assert v is not None and v > 0, m["name"]


def test_window_takes_all_rounds_over_all_its_time(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(harness.time, "perf_counter", lambda: clock[0])
    w = harness.make_window(object, warm=3, seconds=1.0, sync=lambda: None)
    for epoch in range(20):
        clock[0] += 0.3  # each round, its eval included, takes 0.3 s
        if w.after_iteration(None, epoch, {}):
            break
    assert w.t_open == pytest.approx(100.9)  # after the third round
    # the first boundary at or past 1 s: 4 rounds in 1.2 s
    assert w.rounds == 4 and w.t_close - w.t_open == pytest.approx(1.2)
    run = harness.Run(shapes={}, device_name="", setup_s=0, ingest_s=0,
                      window_s=w.t_close - w.t_open, window_rounds=w.rounds)
    assert readers.round_ms(run) == pytest.approx(300.0)


def test_idle_share_takes_the_union_of_device_activity():
    iv = [(0, 10), (5, 15), (20, 30), (30, 31), (40, 40), (50, 55)]
    assert devtrace.union(iv) == [(0, 15), (20, 31), (50, 55)]
    assert devtrace.busy_ns(iv) == 15 + 11 + 5
    assert devtrace.gaps(devtrace.union(iv)) == [(15, 20), (31, 50)]
    # busy 31 ns in each of 3 profiled rounds; the unwatched rounds take
    # 100 ns each at the program's own pace
    run = harness.Run(shapes={}, device_name="", setup_s=0, ingest_s=0, window_s=1,
                      window_rounds=1, plain=(1000e-9, 10),
                      profile={"busy_s": 93e-9, "window_s": 600e-9, "rounds": 3})
    assert readers.idle_share(run) == pytest.approx(69.0)
    run.plain = (0.0, 0)
    assert readers.idle_share(run) is None and readers.round_mfu(run) is None


def test_traced_window_keeps_the_watched_rounds_apart(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(harness.time, "perf_counter", lambda: clock[0])
    calls = []
    w = harness.make_window(object, warm=3, seconds=1.0, sync=lambda: None,
                            profile=(lambda: calls.append("on"), lambda: calls.append("off")),
                            min_rounds=13)
    for epoch in range(40):
        w.before_iteration(None, epoch, {})
        watched = epoch in harness.PROFILED_ROUNDS + harness.GROW_PROFILED_ROUNDS
        clock[0] += 0.2 if watched else 0.1
        if w.after_iteration(None, epoch, {}):
            break
    assert calls == ["on", "off"]
    # rounds 3-12 run 10 rounds (6 watched) before the 13-round minimum,
    # then rounds go on to the first boundary past 1 s
    assert w.watched_rounds == 6 and w.watched_s == pytest.approx(1.2)
    plain_s = w.t_close - w.t_open - w.watched_s
    assert plain_s / (w.rounds - w.watched_rounds) == pytest.approx(0.1)
    assert w.profile_s == pytest.approx(0.6)


def test_work_counts_by_hand_for_both_routes():
    assert [work.bin_bytes(b) for b in (63, 64, 255, 256, 65535)] == [1, 1, 1, 2, 2]
    # kernel D's shape (1M x 50, 256 bins, depth 3): 2-byte bins, 12 bytes
    # a row of gradients and positions, 50 * 8 * 256 float32 pairs out
    d = work.level(1_000_000, 50, 256, 3)
    assert d.bytes == 100_000_000 + 12_000_000 + 819_200 and d.ops == 100_000_000
    # kernel A's shape (10M x 50): the same function, ten times the rows
    a = work.level(10_000_000, 50, 256, 3)
    assert a.bytes == 1_000_000_000 + 120_000_000 + 819_200 and a.ops == 1_000_000_000
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    assert work.least_s(d, peak) == pytest.approx(d.bytes / 3.35e12)
    # the count does not depend on the route: one function for A and D
    assert work.level_hist_least_s(1_000_000, 50, 256, 6, peak) == pytest.approx(
        sum(work.level(1_000_000, 50, 256, k).bytes for k in range(6)) / 3.35e12)
    assert work.peaks("Tesla T4") is None


def test_work_counts_g_trees_a_round():
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    n, F, B, D, m = 435_759, 54, 256, 6, 145_253
    one = work.level_hist_least_s(n, F, B, D, peak)
    assert work.level_hist_least_s(n, F, B, D, peak, 7) == pytest.approx(7 * one)
    # one gradient of n rows and G outputs, then G trees: levels, split
    # searches, the partition, the margin update and the eval walk each
    grad = work.least_s(work.gradient("binary:logistic", n, 3), peak)
    tree = work.round_least_s("binary:logistic", n, F, B, D, m, peak) - work.least_s(
        work.gradient("binary:logistic", n), peak)
    assert work.round_least_s("binary:logistic", n, F, B, D, m, peak, 3) == pytest.approx(
        grad + 3 * tree)
    assert work.gradient("rank:ndcg", 10) == work.Work(10 * 32, 10 * 40)


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "xgboost_tpu",
             "xgboost_tpu.tree", "xgboost_tpu_torch", "xgboost_tpu_torch.tree",
             "jaxtyping", "flaxen", "torch"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "xgboost_tpu",
        "xgboost_tpu.tree"]


def test_a_run_loads_no_forbidden_module():
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "r = harness.run_cell('synth-binary.1m-bin256', 11, 0.5, False, 'cpu',"
        " overrides={'rows': 3000, 'eval_rows': 1000}, log=lambda m: None)\n"
        "print(json.dumps([r['correct'], harness.forbidden_modules()]))\n" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def test_traffic_is_the_seeds_and_the_same_work_for_every_seed():
    c = harness.cell("mslr-ndcg.web10k")
    t = dict(c["traffic"], rows=2400, queries=20, eval_rows=600, eval_queries=5)
    a = traffic.make(c["config"], t, 2**31 + 9, "cpu")
    b = traffic.make(c["config"], t, 2**31 + 9, "cpu")
    other = traffic.make(c["config"], t, 3, "cpu")
    assert (a.train.X.tobytes() == b.train.X.tobytes()
            and a.train.y.tobytes() == b.train.y.tobytes())
    assert a.train.X.tobytes() != other.train.X.tobytes()
    assert a.train.sizes.sum() == 2400 and a.valid.sizes.sum() == 600
    assert sorted(a.train.sizes) == sorted(other.train.sizes)
    assert a.train.sizes.min() >= 60 and a.train.sizes.max() <= 180
    assert set(a.train.y.tolist()) <= {0.0, 1.0, 2.0, 3.0, 4.0}
    miss = float(torch.isnan(torch.as_tensor(a.train.X)).float().mean())
    assert 0.03 < miss < 0.07
    s = traffic.query_sizes(10000, 1200192, 60, 180)
    assert s.sum() == 1200192 and s.min() >= 60 and s.max() <= 180


def test_binary_traffic_is_make_classification():
    c = harness.cell("synth-binary.1m-bin256")
    t = dict(c["traffic"], rows=40_000, eval_rows=4_001)
    a = traffic.make(c["config"], t, 2**31 + 5, "cpu")
    b = traffic.make(c["config"], t, 2**31 + 5, "cpu")
    assert a.train.X.tobytes() == b.train.X.tobytes() and a.valid.sizes is None
    assert a.train.X.shape == (40_000, 50) and a.valid.X.shape == (4_001, 50)
    assert set(a.train.y.tolist()) == {0.0, 1.0}
    # two clusters a class, equal in size; flip_y redraws 1% (half of them
    # to the other class)
    assert abs(float(a.train.y.mean()) - 0.5) < 0.01
    # each feature is a sum of 50 uniform-weighted normals: sd about
    # sqrt(50 / 3), plus the vertex's +-1
    sd = torch.as_tensor(a.train.X).std(dim=0)
    assert float(sd.min()) > 2.5 and float(sd.max()) < 6.0
    # the clusters are shared by both splits: a nearest-centroid rule
    # learned on the training rows labels the held-out rows
    X, y = torch.as_tensor(a.train.X), torch.as_tensor(a.train.y)
    mu = torch.stack([X[y == k].mean(0) for k in (0, 1)])
    Xv, yv = torch.as_tensor(a.valid.X), torch.as_tensor(a.valid.y)
    pred = torch.cdist(Xv, mu).argmin(1).float()
    assert float((pred == yv).float().mean()) > 0.6
