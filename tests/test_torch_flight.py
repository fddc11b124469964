"""The port's flight recorder (``xgboost_tpu_torch.observability.flight``)
against the JAX package's.

- a training run's round records carry the JAX package's keys less its
  ``retraces`` (JAX recompilations, which have no counterpart), one record
  a round with its ``grow`` and ``eval`` stages, the same on both sides;
- ``update_many`` keeps one record per chunk, as the JAX package does;
- ``FlightRecorderMonitor`` hands over each completed record; a nested
  ``begin_round`` does not own the record; the ring is bounded;
  ``XGBTPU_FLIGHT=0`` turns recording off, in training too;
- the sink (``configure``) writes ``flight.jsonl``, ``clock.json``,
  ``metrics.json`` and the span trace; an abort writes ``blackbox.json``
  with the JAX package's keys (less its ``dispatch`` table) and the
  ``train_abort`` event, and the exception still reaches the caller;
- the profiling window (``XGBTPU_PROFILE``) and ``profiler_context`` write
  a ``torch.profiler`` Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu.observability import RECORDER as JRECORDER
from xgboost_tpu.observability import flight as jflight
from xgboost_tpu.observability import trace as jtrace
from xgboost_tpu_torch.callback import FlightRecorderMonitor, TrainingCallback
from xgboost_tpu_torch.observability import RECORDER, flight, trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_flight(monkeypatch):
    for var in ("XGBTPU_TRACE", "XGBTPU_FLIGHT", "XGBTPU_PROFILE",
                "XGBTPU_PROFILE_ROUNDS"):
        monkeypatch.delenv(var, raising=False)
    for rec, tr in ((RECORDER, trace), (JRECORDER, jtrace)):
        rec.reset()
        tr.reset()
    yield
    RECORDER.reset()
    JRECORDER.reset()
    flight.profile_reset()
    trace.reset()
    jtrace.reset()


def _data(n=600, F=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = ((X @ rng.randn(F)) > 0).astype(np.float32)
    return X, y


_PARAMS = {"max_depth": 3, "max_bin": 16, "verbosity": 0}
CPU = {"device": "cpu"}


def _rounds(rec):
    return [r for r in rec.records() if r.get("t") == "round"]


def test_round_records_carry_the_jax_packages_keys():
    X, y = _data()
    p = dict(_PARAMS, eval_metric="logloss")
    for pkg, kw in ((xgbt, CPU), (xgb, {})):
        d = pkg.DMatrix(X, y, **kw)
        dv = pkg.DMatrix(X[:100], y[:100], **kw)
        pkg.train(p, d, 4, evals=[(dv, "val")], verbose_eval=False)
    mine, theirs = _rounds(RECORDER), _rounds(JRECORDER)
    assert len(mine) == len(theirs) == 4
    for a, b in zip(mine, theirs):
        assert set(a) == set(b) - {"retraces"}, (sorted(a), sorted(b))
        assert (a["round"], a["rounds"], a["gen"]) == \
            (b["round"], b["rounds"], b["gen"])
        assert {"grow", "eval"} <= set(a["stages"])
        assert set(a["stages"]) <= set(b["stages"])
        assert a["stages"]["grow"] > 0 and a["wall_s"] > 0
        assert a["rss_peak_mb"] > 0
        assert "dev_peak_mb" not in a  # no card initialised
    # one process: no collective inside the rounds (the first record's
    # delta also holds whatever earlier code of this process reduced)
    assert all(a["coll_ops"] == a["coll_bytes"] == 0.0 for a in mine[1:])
    assert RECORDER.last()["round"] == 3
    json.dumps(mine)
    # the stage totals count the sketch and the ingest outside any round
    assert {"sketch", "ingest", "grow", "eval"} <= set(
        flight.stage_totals())


def test_update_many_chunk_records():
    X, y = _data()
    recs = []
    for pkg, rec, kw in ((xgbt, RECORDER, CPU), (xgb, JRECORDER, {})):
        d = pkg.DMatrix(X, y, **kw)
        bst = pkg.Booster(_PARAMS, [d], **kw)
        rec.reset()
        bst.update_many(d, 0, 4, chunk=2)
        recs.append([(r["round"], r["rounds"]) for r in _rounds(rec)])
        assert all(r["stages"].get("grow", 0) > 0 for r in _rounds(rec))
    assert recs[0] == recs[1] == [(0, 2), (2, 2)]


def test_flight_callback_live_query():
    X, y = _data()
    d = xgbt.DMatrix(X, y, **CPU)
    seen = []
    mon = FlightRecorderMonitor(on_record=lambda r: seen.append(r["round"]))
    xgbt.train(_PARAMS, d, 3, verbose_eval=False, callbacks=[mon])
    assert seen == [0, 1, 2]
    assert mon.latest["round"] == 2
    assert any(r.get("t") == "round" for r in mon.records())


def test_nested_begin_is_not_owner():
    assert RECORDER.begin_round(7) is True
    assert RECORDER.begin_round(7, rounds=1) is False
    RECORDER.end_round()  # the nested end: the record stays open
    RECORDER.note("grow", 0.5)
    rec = RECORDER.end_round()
    assert rec is not None and rec["gen"] == 0
    assert rec["stages"]["grow"] == 0.5
    assert RECORDER.last()["round"] == 7


def test_ring_is_bounded_and_disable_switch(monkeypatch):
    cap = RECORDER._ring.maxlen
    for i in range(cap + 7):
        RECORDER.begin_round(i)
        RECORDER.end_round()
    assert len(RECORDER._ring) == cap
    monkeypatch.setenv("XGBTPU_FLIGHT", "0")
    RECORDER.reset()
    RECORDER.begin_round(0)
    assert RECORDER.end_round() is None
    assert RECORDER.records() == []


def test_flight_zero_disables_recording_in_training(monkeypatch, tmp_path):
    monkeypatch.setenv("XGBTPU_FLIGHT", "0")
    X, y = _data()
    d = xgbt.DMatrix(X, y, **CPU)
    bst = xgbt.train(_PARAMS, d, 3, verbose_eval=False)
    assert RECORDER.records() == [] and RECORDER.last() is None
    assert flight.stage_totals() == {}
    assert flight.configure(str(tmp_path / "run")) is not None
    RECORDER.dump("nothing")
    assert not os.path.exists(
        os.path.join(RECORDER.run_dir, "blackbox.json"))
    monkeypatch.delenv("XGBTPU_FLIGHT")
    # the same trees as a recorded run
    assert bst.save_raw() == xgbt.train(_PARAMS, d, 3,
                                        verbose_eval=False).save_raw()
    assert len(_rounds(RECORDER)) == 3


def test_sink_persists_jsonl_and_sidecars(tmp_path):
    run = str(tmp_path / "run")
    assert flight.configure(run, rank=0) == os.path.join(run, "obs",
                                                         "rank0")
    X, y = _data()
    d = xgbt.DMatrix(X, y, **CPU)
    xgbt.train(_PARAMS, d, 3, verbose_eval=False)
    rank_dir = os.path.join(run, "obs", "rank0")
    lines = [json.loads(ln) for ln in
             open(os.path.join(rank_dir, "flight.jsonl"))]
    assert lines[0]["t"] == "meta" and lines[0]["rank"] == 0
    assert lines[0]["format"] == jflight.FORMAT
    assert "unix_ns" in lines[0]["clock"]
    assert sum(1 for r in lines if r["t"] == "round") == 3
    clock = json.load(open(os.path.join(rank_dir, "clock.json")))
    assert clock["unix_ns"] > 0
    metrics = json.load(open(os.path.join(rank_dir, "metrics.json")))
    assert "rounds_total" in metrics and "round_seconds" in metrics
    events = trace.load_trace(os.path.join(rank_dir, "trace.jsonl"))
    assert {"round", "update", "build_tree"} <= {e.get("name")
                                                 for e in events}


class _Bomb(TrainingCallback):
    def after_iteration(self, model, epoch, evals_log):
        if epoch == 2:
            raise RuntimeError("synthetic crash")
        return False


def test_abort_dump_writes_blackbox(tmp_path):
    run = str(tmp_path / "run")
    flight.configure(run, rank=0)
    X, y = _data()
    d = xgbt.DMatrix(X, y, **CPU)
    with pytest.raises(RuntimeError, match="synthetic crash"):
        xgbt.train(_PARAMS, d, 6, verbose_eval=False, callbacks=[_Bomb()])
    bb = json.load(open(os.path.join(run, "obs", "rank0", "blackbox.json")))
    assert bb["reason"] == "abort:RuntimeError"
    assert bb["format"] == jflight.FORMAT and bb["rank"] == 0
    rounds = [r for r in bb["records"] if r.get("t") == "round"]
    assert [r["round"] for r in rounds] == [0, 1, 2]
    abort = [r for r in bb["records"] if r.get("t") == "event"]
    assert abort[-1]["name"] == "train_abort"
    assert abort[-1]["args"] == {"error": "RuntimeError",
                                 "detail": "synthetic crash"}
    assert "rounds_total" in bb["metrics"]

    # the JAX package's black box of the same abort: the same keys, less
    # its dispatch table
    jrun = str(tmp_path / "jrun")
    jflight.configure(jrun, rank=0)

    class JBomb(xgb.callback.TrainingCallback):
        after_iteration = _Bomb.after_iteration

    with pytest.raises(RuntimeError, match="synthetic crash"):
        xgb.train(_PARAMS, xgb.DMatrix(X, label=y), 6, verbose_eval=False,
                  callbacks=[JBomb()])
    jbb = json.load(open(os.path.join(jrun, "obs", "rank0",
                                      "blackbox.json")))
    assert set(bb) == set(jbb) - {"dispatch"}
    assert jbb["reason"] == bb["reason"]


def test_blackbox_dump_to_a_path_without_a_sink(tmp_path):
    RECORDER.begin_round(0)
    RECORDER.note("grow", 0.25)
    RECORDER.end_round()
    RECORDER.event("fault", site="grow")
    assert RECORDER.dump("manual") is None  # no sink, no path
    path = str(tmp_path / "box.json")
    assert RECORDER.dump("manual", path=path) == path
    bb = json.load(open(path))
    assert [r["t"] for r in bb["records"]] == ["round", "event"]
    assert bb["stage_totals_s"] == {"grow": 0.25}


def test_profile_env_captures_window(tmp_path, monkeypatch):
    flight.profile_reset()
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv("XGBTPU_PROFILE", str(prof_dir))
    monkeypatch.setenv("XGBTPU_PROFILE_ROUNDS", "2")
    flight.profile_tick(0)
    assert flight._prof_state["active"]
    torch.ones((64, 64)).sum()
    flight.profile_tick(1)
    assert flight._prof_state["active"]  # the window spans 2 rounds
    flight.profile_tick(2)
    assert not flight._prof_state["active"]
    with open(prof_dir / "profile.json") as f:
        assert json.load(f)["traceEvents"]
    flight.profile_tick(0)  # once per process
    assert not flight._prof_state["active"]


def test_profile_window_in_training(tmp_path, monkeypatch):
    flight.profile_reset()
    monkeypatch.setenv("XGBTPU_PROFILE", str(tmp_path / "prof"))
    monkeypatch.setenv("XGBTPU_PROFILE_ROUNDS", "5")
    X, y = _data()
    xgbt.train(_PARAMS, xgbt.DMatrix(X, y, **CPU), 2, verbose_eval=False)
    assert not flight._prof_state["active"]  # closed by train's finally
    assert os.path.getsize(tmp_path / "prof" / "profile.json") > 0


def test_profiler_context_writes_a_chrome_trace(tmp_path):
    from xgboost_tpu_torch.utils import profiler_context

    with profiler_context(str(tmp_path / "p")):
        torch.ones((32, 32)).mm(torch.ones((32, 32)))
    with open(tmp_path / "p" / "profile.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
