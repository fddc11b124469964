"""The pipelined round loop in the port (``xgboost_tpu_torch/pipeline.py``,
the async checkpoint writer of ``resilience/checkpoint.py`` and
``utils/observer.py``) on the CPU, against the JAX package where both
packages have the function; after the JAX package's
``tests/test_pipeline.py`` at its sizes (2048 x 6, depth 3, ``max_bin``
16):

- ``XGBTPU_PIPELINE_DEPTH`` 0, 1 and 2 give equal ``save_raw()`` bytes
  through ``train`` and through ``update_many``, and the JAX package's
  trees (splits exact, leaf values within 1e-6);
- ``RoundPipeline`` keeps at most ``depth`` rounds in flight and drains to
  none; a handle whose ``synchronize`` raises surfaces with
  ``.pipeline_round`` and a ``pipeline_fault`` flight event; a scripted
  ``pipeline_sync`` fault in ``train`` does the same, and resuming from
  its checkpoints ends with the straight run's bytes;
- async checkpoint files equal synchronous ones and the JAX package's,
  byte for byte; a parked write failure surfaces in its own directory's
  run only; an abort waits for the writer before its own write;
- a SIGKILL while rounds are in flight resumes to the straight bytes;
- the observer writes the JAX package's file names and arrays;
- ``Booster.copy()`` and pickling leave the pipeline out.

The JAX package's donation tests (``tests/test_pipeline.py:93-141``) have
no counterpart: the port donates no buffer, so its completion probe is an
event and no handle is ever skipped as donated. Workers run this file as a
script and import only the port.
"""

from __future__ import annotations

import json
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch.observability import flight
from xgboost_tpu_torch.params import NOT_PORTED
from xgboost_tpu_torch.pipeline import (RoundPipeline, completion_probe,
                                        pipeline_depth)
from xgboost_tpu_torch.resilience import chaos
from xgboost_tpu_torch.resilience import checkpoint as tck
from xgboost_tpu_torch.resilience.chaos import ChaosError

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N, F, ROUNDS = 2048, 6, 5
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16,
          "verbosity": 0, "seed": 3}
CPU = dict(device="cpu")


def _data(n=N, f=F):
    rng = np.random.RandomState(0)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    return X, y


def _trees(raw):
    return json.loads(raw)["learner"]["gradient_booster"]["model"]["trees"]


def _assert_jax_trees(jraw, traw):
    """Splits exact, leaf values within 1e-6 (the packages' float sums)."""
    jt, tt = _trees(jraw), _trees(traw)
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        internal = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[internal],
            np.asarray(b["split_conditions"], np.float32)[internal])
        np.testing.assert_allclose(b["base_weights"], a["base_weights"],
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_writer():
    yield
    tck.async_writer().reset()
    chaos.reset()


@pytest.fixture(scope="module")
def jax_raw():
    import xgboost_tpu as xgb

    X, y = _data()
    return xgb.train(dict(PARAMS), xgb.DMatrix(X, label=y), ROUNDS,
                     verbose_eval=False).save_raw()


def _port_raw(path, depth, monkeypatch):
    monkeypatch.setenv("XGBTPU_PIPELINE_DEPTH", depth)
    X, y = _data()
    d = xgbt.DMatrix(X, y, **CPU)
    if path == "train":
        return xgbt.train(dict(PARAMS), d, ROUNDS, verbose_eval=False
                          ).save_raw()
    b = xgbt.Booster(dict(PARAMS), [d], **CPU)
    b.update_many(d, 0, ROUNDS, chunk=2)
    assert b._pipeline.depth == int(depth)
    b._pipeline.drain()
    return b.save_raw()


# ---------------------------------------------------------------------------
# the in-flight window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["train", "update_many"])
def test_depths_give_equal_bytes_and_the_jax_trees(path, jax_raw,
                                                   monkeypatch):
    """The pipeline changes when the host waits, never what is computed."""
    raws = [_port_raw(path, depth, monkeypatch) for depth in "012"]
    assert raws[0] == raws[1] == raws[2]
    _assert_jax_trees(jax_raw, raws[0])


class _Handle:
    def __init__(self, log, i, fail=False):
        self.log, self.i, self.fail = log, i, fail

    def synchronize(self):
        if self.fail:
            raise RuntimeError("injected device fault")
        self.log.append(self.i)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_pipeline_bounds_inflight_and_drains(depth):
    pipe = RoundPipeline(depth=depth)
    log = []
    for i in range(6):
        pipe.admit(i, [_Handle(log, i), None])
        assert len(pipe) <= depth
        # the oldest rounds are waited for first, in order
        assert log == list(range(i + 1 - len(pipe)))
    pipe.drain()
    assert len(pipe) == 0 and log == list(range(6))
    pipe.admit(6, None)  # None handles are ignored, not waited for
    pipe.abandon()
    assert len(pipe) == 0


@pytest.mark.parametrize("value,want", [(None, 2), ("0", 0), ("1", 1),
                                        ("5", 5), ("-3", 0), ("two", 2)])
def test_pipeline_depth_reads_the_environment(value, want, monkeypatch):
    if value is None:
        monkeypatch.delenv("XGBTPU_PIPELINE_DEPTH", raising=False)
    else:
        monkeypatch.setenv("XGBTPU_PIPELINE_DEPTH", value)
    assert pipeline_depth() == want
    assert RoundPipeline().depth == want


def test_pipeline_attributes_a_failed_wait():
    """A handle that fails at its wait surfaces with the round it belongs
    to, on the exception and in the flight events; the wait is charged to
    the ``sync`` stage."""
    before = flight.stage_totals().get("sync", 0.0)
    pipe = RoundPipeline(depth=1)
    pipe.admit(7, _Handle([], 7, fail=True))
    with pytest.raises(RuntimeError) as ei:
        pipe.admit(8, _Handle([], 8))  # exceeds the depth: waits for 7
    assert ei.value.pipeline_round == 7
    ev = [r for r in flight.RECORDER.records()
          if r.get("t") == "event" and r.get("name") == "pipeline_fault"]
    assert ev and ev[-1]["args"]["round"] == 7
    assert ev[-1]["args"]["error"] == "RuntimeError"
    assert flight.stage_totals().get("sync", 0.0) > before


def test_completion_probe_is_an_event_on_the_card_and_none_on_the_cpu(
        monkeypatch):
    assert completion_probe(None) is None
    assert completion_probe(torch.zeros(3)) is None
    seen = []

    class _Event:
        def record(self, stream):
            seen.append(stream)

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: ("stream of", device))

    class _CardTensor:
        device = torch.device("cuda", 1)

    ev = completion_probe(_CardTensor())
    assert isinstance(ev, _Event)
    assert seen == [("stream of", torch.device("cuda", 1))]


def test_train_records_sync_and_drains_at_the_end(monkeypatch):
    """Each round's record holds a ``sync`` stage; the loop waits at the
    end of training for every round it admitted."""
    admitted, drained = [], []
    real_admit, real_drain = RoundPipeline.admit, RoundPipeline.drain

    def admit(self, i, h):
        admitted.append((i, self.depth))
        real_admit(self, i, h)

    def drain(self):
        drained.append(len(self))
        real_drain(self)

    monkeypatch.setattr(RoundPipeline, "admit", admit)
    monkeypatch.setattr(RoundPipeline, "drain", drain)
    monkeypatch.setenv("XGBTPU_PIPELINE_DEPTH", "3")
    X, y = _data(256)
    xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 4,
               verbose_eval=False)
    assert admitted == [(i, 3) for i in range(4)]
    assert drained == [3]  # no consumer: only the end of training drains
    recs = [r for r in flight.RECORDER.records() if r.get("t") == "round"]
    assert "sync" in recs[-1]["stages"]


def test_update_many_abandons_younger_chunks_on_a_fault(monkeypatch):
    X, y = _data(256)
    d = xgbt.DMatrix(X, y, **CPU)
    b = xgbt.Booster(dict(PARAMS), [d], **CPU)
    monkeypatch.setenv("XGBTPU_PIPELINE_DEPTH", "1")
    calls = []

    def probe(t):
        calls.append(t)
        return _Handle([], len(calls), fail=len(calls) == 2)

    monkeypatch.setattr("xgboost_tpu_torch.learner.completion_probe", probe)
    b.update_many(d, 0, 2, chunk=1)  # chunk 1 in flight, chunk 0 waited
    with pytest.raises(RuntimeError) as ei:
        b.update_many(d, 2, 2, chunk=1)  # waits for chunk 1: it fails
    assert ei.value.pipeline_round == 1
    assert len(b._pipeline) == 0


def test_pipeline_sync_fault_is_attributed_and_resumes(tmp_path, jax_raw,
                                                       monkeypatch):
    """A scripted fault at the wait of round 2 raises with that round,
    commits the finished rounds, and a rerun ends with the straight
    bytes."""
    monkeypatch.setenv("XGBTPU_PIPELINE_DEPTH", "2")
    X, y = _data()
    ck = str(tmp_path / "ck")
    with chaos.configure("pipeline_sync:transient:3"):
        with pytest.raises(ChaosError) as ei:
            xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), ROUNDS,
                       verbose_eval=False, resume_from=ck,
                       checkpoint_interval=1)
    assert ei.value.pipeline_round == 2
    ev = [r for r in flight.RECORDER.records()
          if r.get("t") == "event" and r.get("name") == "pipeline_fault"]
    assert ev and ev[-1]["args"]["round"] == 2
    assert tck.load_latest(ck)[1] == 3  # round 2's tree was grown
    bst = xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), ROUNDS,
                     verbose_eval=False, resume_from=ck,
                     checkpoint_interval=1)
    straight = xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), ROUNDS,
                          verbose_eval=False)
    assert bst.save_raw() == straight.save_raw()
    _assert_jax_trees(jax_raw, bst.save_raw())


# ---------------------------------------------------------------------------
# the async checkpoint writer
# ---------------------------------------------------------------------------

def test_async_files_equal_sync_and_the_jax_packages(tmp_path, jax_raw):
    """One model through both packages' writers, async and synchronous:
    four files, one set of bytes."""
    import xgboost_tpu as xgb
    from xgboost_tpu.resilience import checkpoint as jck

    tb = xgbt.Booster(model_file=jax_raw, **CPU)
    jb = xgb.Booster(model_file=bytearray(jax_raw))
    dirs = {k: str(tmp_path / k) for k in ("t_async", "t_sync", "j_async",
                                           "j_sync")}
    for d in dirs.values():
        os.makedirs(d)
    w = tck.async_writer()
    w.submit(dirs["t_async"], tb, ROUNDS)
    assert w.covered(dirs["t_async"], ROUNDS)
    w.wait(dirs["t_async"])
    tck.save_checkpoint(dirs["t_sync"], tb, ROUNDS)
    jw = jck.async_writer()
    jw.submit(dirs["j_async"], jb, ROUNDS)
    jw.wait(dirs["j_async"])
    jck.save_checkpoint(dirs["j_sync"], jb, ROUNDS)
    files = {k: Path(tck.checkpoint_path(d, ROUNDS)).read_bytes()
             for k, d in dirs.items()}
    assert len(set(files.values())) == 1
    assert tck.read_checkpoint(tck.checkpoint_path(dirs["t_async"], ROUNDS)
                               )[0] == tb.save_raw() == jax_raw


def test_train_async_and_sync_checkpoints_are_byte_equal(tmp_path,
                                                         monkeypatch):
    X, y = _data(512)
    out = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("XGBTPU_ASYNC_CKPT", mode)
        ck = str(tmp_path / f"ck{mode}")
        xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 4,
                   verbose_eval=False, resume_from=ck, checkpoint_interval=1)
        out[mode] = {os.path.basename(p): Path(p).read_bytes()
                     for p in tck.list_checkpoints(ck)}
    assert list(out["1"]) == ["ckpt_00000003.ckpt", "ckpt_00000004.ckpt"]
    assert out["1"] == out["0"]


def test_parked_failure_surfaces_in_its_own_directory_only(tmp_path):
    X, y = _data(256)
    bst = xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 2,
                     verbose_eval=False)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    os.makedirs(a), os.makedirs(b)
    w = tck.async_writer()
    with chaos.configure("checkpoint_write:permanent:1"):
        w.submit(a, bst, 2)
        w.wait(b)  # b has nothing in flight and nothing parked
        w.submit(b, bst, 2)  # a's failure does not surface in b's run
        w.wait(b)
        assert tck.load_latest(b)[1] == 2
        with pytest.raises(ChaosError) as ei:
            w.wait(a)
    assert ei.value.checkpoint_rounds == 2
    assert tck.load_latest(a) is None
    w.wait(a)  # raised once, then cleared
    ev = [r for r in flight.RECORDER.records()
          if r.get("t") == "event" and r.get("name") == "checkpoint_fault"]
    assert ev and ev[-1]["args"]["rounds"] == 2


def test_parked_failure_fails_its_own_train(tmp_path):
    X, y = _data(256)
    with chaos.configure("checkpoint_write:permanent:1"):
        with pytest.raises(ChaosError) as ei:
            xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 2,
                       verbose_eval=False, resume_from=str(tmp_path / "a"),
                       checkpoint_interval=2)
        # another directory's run in the same process trains undisturbed
        bst = xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 2,
                         verbose_eval=False, resume_from=str(tmp_path / "b"),
                         checkpoint_interval=2)
    assert ei.value.checkpoint_rounds == 2
    assert bst.num_boosted_rounds() == 2
    assert tck.load_latest(str(tmp_path / "b"))[1] == 2


def test_abort_waits_for_the_writer_before_its_write(tmp_path, monkeypatch):
    """The abort's synchronous write starts only after the writer's
    in-flight write to the directory has landed, and a failure parked
    there does not hide the abort."""
    from xgboost_tpu_torch.callback import TrainingCallback

    monkeypatch.setenv("XGBTPU_TEST_CKPT_WRITE_DELAY", "0.3")
    busy_at_abort = []
    real = tck.save_checkpoint

    def save(directory, booster, rounds, **kw):
        busy_at_abort.append(tck.async_writer()._busy)
        return real(directory, booster, rounds, **kw)

    monkeypatch.setattr(tck, "save_checkpoint", save)

    class Boom(TrainingCallback):
        def after_iteration(self, model, epoch, evals_log):
            if epoch == 2:
                raise RuntimeError("abort at round 2")
            return False

    X, y = _data(256)
    ck = str(tmp_path / "ck")
    with chaos.configure("checkpoint_write:permanent:2"):
        with pytest.raises(RuntimeError, match="abort at round 2"):
            xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 5,
                       verbose_eval=False, resume_from=ck,
                       checkpoint_interval=1, callbacks=[Boom()])
    assert busy_at_abort == [False]
    assert tck.load_latest(ck)[1] == 3
    assert not [n for n in os.listdir(ck) if ".tmp." in n]


def test_readers_settle_the_directory_first(tmp_path, monkeypatch):
    """``inspect_dir`` and a resuming ``train`` see a write still in
    flight in this process."""
    monkeypatch.setenv("XGBTPU_TEST_CKPT_WRITE_DELAY", "0.3")
    X, y = _data(256)
    bst = xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 2,
                     verbose_eval=False)
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    tck.async_writer().submit(ck, bst, 2)
    recs = tck.inspect_dir(ck)
    assert [(r["rounds"], r["verified"]) for r in recs] == [(2, True)]
    ck2 = str(tmp_path / "ck2")
    os.makedirs(ck2)
    tck.async_writer().submit(ck2, bst, 2)
    again = xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 2,
                       verbose_eval=False, resume_from=ck2)
    assert again.save_raw() == bst.save_raw()  # resumed: 0 rounds to train


# ---------------------------------------------------------------------------
# SIGKILL while rounds are in flight
# ---------------------------------------------------------------------------

def kill_worker(run_dir: str, ck: str) -> None:
    """6 rounds with checkpoints, SIGKILLed in round 3's callbacks."""
    from xgboost_tpu_torch.callback import TrainingCallback

    class KillAt(TrainingCallback):
        def after_iteration(self, model, epoch, evals_log):
            if epoch == 3:
                os.kill(os.getpid(), signal.SIGKILL)
            return False

    torch.set_num_threads(1)
    flight.configure(run_dir)
    X, y = _data()
    xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 6,
               verbose_eval=False, resume_from=ck, checkpoint_interval=1,
               callbacks=[KillAt()])
    print("COMPLETED")


def test_sigkill_mid_pipelined_round_recovers(tmp_path):
    run_dir, ck = str(tmp_path / "obs"), str(tmp_path / "ck")
    env = dict(os.environ, XGBTPU_PIPELINE_DEPTH="2",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, __file__, "kill", run_dir, ck],
                       capture_output=True, text=True, timeout=180, env=env,
                       cwd=ROOT)
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    rounds = []
    with open(os.path.join(run_dir, "obs", "rank0", "flight.jsonl")) as f:
        for line in f:
            rec = json.loads(line)  # every line parses
            if rec.get("t") == "round":
                rounds.append(rec["round"])
    assert rounds, "no round record survived the SIGKILL"
    X, y = _data()
    bst = xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 6,
                     verbose_eval=False, resume_from=ck,
                     checkpoint_interval=1)
    straight = xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 6,
                          verbose_eval=False)
    assert bst.num_boosted_rounds() == 6
    assert bst.save_raw() == straight.save_raw()


# ---------------------------------------------------------------------------
# the observer, copies and pickles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params", [
    {"objective": "binary:logistic", "max_depth": 2},
    {"objective": "multi:softprob", "num_class": 3, "max_depth": 2}],
    ids=["binary", "3-class"])
def test_observer_matches_the_jax_package(params, tmp_path, monkeypatch,
                                          capfd):
    import xgboost_tpu as xgb

    rng = np.random.RandomState(0)
    X = rng.randn(200, 4).astype(np.float32)
    y = (rng.randint(0, 3, 200) if "num_class" in params
         else X[:, 0] > 0).astype(np.float32)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setenv("XGBTPU_OBSERVER", str(jdir))
    xgb.train(params, xgb.DMatrix(X, label=y), 2, verbose_eval=False)
    jerr = capfd.readouterr().err
    monkeypatch.setenv("XGBTPU_OBSERVER", str(tdir))
    xgbt.train(params, xgbt.DMatrix(X, y, **CPU), 2, verbose_eval=False)
    terr = capfd.readouterr().err
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) == [
        f"0000{i}_{n}.npy" for i in (0, 1) for n in ("grad", "hess",
                                                      "margin")]
    for name in names:
        a, b = np.load(jdir / name), np.load(tdir / name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)

    def lines(err, d):
        return [ln.split(" sum=")[0] + " -> " + ln.rsplit(os.sep, 1)[1]
                for ln in err.splitlines() if ln.startswith("[observer]")
                and str(d) in ln]

    # the same lines, up to the values and the directory
    assert lines(terr, tdir) == lines(jerr, jdir) and len(lines(terr, tdir)) == 6


def test_observer_off_copies_nothing(monkeypatch):
    from xgboost_tpu_torch.utils import observer

    monkeypatch.delenv("XGBTPU_OBSERVER", raising=False)

    def boom(*a, **k):
        raise AssertionError("observed while off")

    monkeypatch.setattr(observer, "observe", boom)
    X, y = _data(256)
    xgbt.train(dict(PARAMS), xgbt.DMatrix(X, y, **CPU), 1,
               verbose_eval=False)
    assert not observer.enabled()


def test_copy_and_pickle_leave_the_pipeline_out():
    X, y = _data(256)
    d = xgbt.DMatrix(X, y, **CPU)
    b = xgbt.Booster(dict(PARAMS), [d], **CPU)
    b.update_many(d, 0, 2)
    assert isinstance(b._pipeline, RoundPipeline)
    assert "_pipeline" not in b.__getstate__()
    for other in (b.copy(), pickle.loads(pickle.dumps(b))):
        assert other._pipeline is None
        assert other.save_raw() == b.save_raw()


def test_multi_strategy_trains_the_jax_packages_trees():
    """``multi_strategy`` is read by nothing in either package: one output
    per tree, the JAX package's trees."""
    import xgboost_tpu as xgb

    rng = np.random.RandomState(0)
    X = rng.randn(200, 4).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    params = {"objective": "binary:logistic", "max_depth": 2,
              "multi_strategy": "multi_output_tree"}
    assert not NOT_PORTED
    jraw = xgb.train(params, xgb.DMatrix(X, label=y), 2,
                     verbose_eval=False).save_raw()
    traw = xgbt.train(params, xgbt.DMatrix(X, y, **CPU), 2,
                      verbose_eval=False).save_raw()
    assert len(_trees(traw)) == 2
    _assert_jax_trees(jraw, traw)


if __name__ == "__main__":
    if sys.argv[1] == "kill":
        kill_worker(sys.argv[2], sys.argv[3])
