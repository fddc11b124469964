"""Crash-safe resume in the port (``train(resume_from=...)`` on the CPU),
after the JAX package's ``tests/test_crash_resume.py`` at its sizes
(2000 x 5, depth 3, ``max_bin`` 16, 6 rounds):

- a worker SIGKILLed after round 3's ``after_iteration`` (before that
  round's checkpoint is written) and run again resumes to the
  uninterrupted run's ``save_raw()`` bytes, with and without row and
  column sampling, and with three parallel trees a round under
  ``reg:squarederror`` (the cache filled tree by tree from a base of 0.5);
- a SIGKILL while a checkpoint write is held in flight
  (``XGBTPU_TEST_CKPT_WRITE_DELAY``) keeps the previous checkpoint, a torn
  tmp file is ignored, and the rerun ends with the straight bytes;
- a resumed booster's caches hold the uninterrupted run's margins bit for
  bit;
- ``resume_mode="append"``: N rounds, then M more, equal N + M straight;
- a watchdog abort commits the finished rounds, and a rerun finishes the
  uninterrupted run's model;
- world 2 over gloo writes ``rank<r>`` directories, is killed on both
  ranks and resumes to the single process's bytes; ranks killed at
  different newest rounds (one rank's write held in flight), or holding
  different verified rounds, resume from the newest round every rank
  holds (or from the start when they share none) to the same bytes;
- the resumed model equals the JAX package's uninterrupted run on the same
  data (splits exact; leaf values within 1e-6, the packages' float sums).

Workers run this file as a script and import only the port.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
N, F, ROUNDS, KILL_AFTER = 2000, 5, 6, 3
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16,
          "eta": 0.3, "verbosity": 0}
CASES = {
    "plain": {},
    "sampled": {"subsample": 0.7, "colsample_bytree": 0.6},
    "parallel": {"objective": "reg:squarederror", "num_parallel_tree": 3,
                 "subsample": 0.8},
}
DIST_CUT = 1200  # rank 0's rows; rank 1 takes the rest
# the card's case (``tests/test_torch_cuda_kernels.py -k resume``): 64k rows
# at the main path's depth and bins (kernels C and D in each process, B in
# the eval walks and the resumed caches' fill)
CARD_SHAPE = (65_536, 20)
CARD_PARAMS = {"objective": "binary:logistic", "max_depth": 6,
               "max_bin": 256, "eta": 0.1, "verbosity": 0}


def data(n=N, f=F):
    rng = np.random.RandomState(0)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f)
    y = ((X @ w) + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# the workers (run as a script; import only the port)
# ---------------------------------------------------------------------------

def _killer(kill_after: int):
    from xgboost_tpu_torch.callback import TrainingCallback

    class Killer(TrainingCallback):
        """SIGKILLs this process after round ``kill_after``'s
        ``after_iteration``: user callbacks run before the checkpoint's, so
        that round is never committed."""

        def __init__(self):
            self.rounds = 0

        def after_iteration(self, model, epoch, evals_log):
            self.rounds += 1
            if kill_after and self.rounds == kill_after:
                os.kill(os.getpid(), signal.SIGKILL)
            return False

    return Killer()


def single_worker(case: str, ckdir: str, out: str, kill_after: int) -> None:
    """One process's run of ``case``: one of ``CASES`` on the CPU, or
    ``"card"``, ``CARD_PARAMS`` at ``CARD_SHAPE`` on the card."""
    import xgboost_tpu_torch as xgbt

    torch.set_num_threads(1)
    if case == "card":
        params, (X, y), dev = CARD_PARAMS, data(*CARD_SHAPE), "cuda"
    else:
        params, (X, y), dev = {**PARAMS, **CASES[case]}, data(), "cpu"
    d = xgbt.DMatrix(X, y, device=dev)
    dv = xgbt.DMatrix(X[:500], y[:500], device=dev)
    bst = xgbt.train(params, d, ROUNDS, evals=[(dv, "v")],
                     verbose_eval=False, resume_from=ckdir,
                     callbacks=[_killer(kill_after)])
    Path(out).write_bytes(bst.save_raw())


def rank_worker(rank: int, init_file: str, ckdir: str, out: str,
                kill_after: int) -> None:
    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch.parallel import init_distributed, mesh_context

    torch.set_num_threads(1)
    mesh = init_distributed(f"file://{init_file}", 2, rank, backend="gloo",
                            device="cpu")
    X, y = data()
    dall = xgbt.DMatrix(X, y, device="cpu")
    dall.get_binned(PARAMS["max_bin"])
    lo, hi = (0, DIST_CUT) if rank == 0 else (DIST_CUT, N)
    d = xgbt.QuantileDMatrix(X[lo:hi], y[lo:hi], max_bin=PARAMS["max_bin"],
                             ref=dall, device="cpu")
    with mesh_context(mesh):
        bst = xgbt.train(PARAMS, d, ROUNDS, verbose_eval=False,
                         resume_from=ckdir, callbacks=[_killer(kill_after)])
    Path(out).write_bytes(bst.save_raw())
    xgbt.collective.finalize()


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                + os.environ.get("PYTHONPATH", ""), **extra)


def _run(args, kill_after=0, **env):
    return subprocess.Popen(
        [sys.executable, __file__, *map(str, args), str(kill_after)],
        cwd=ROOT, env=_env(**env), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _wait(procs, timeout=120):
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:  # never leak a worker
            if p.poll() is None:
                p.kill()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def killed_and_resumed(tmp_path_factory):
    """{case: (resumed bytes, straight bytes, rounds in the newest
    checkpoint after the kill)}: every case's three runs, the cases run
    side by side."""
    from xgboost_tpu_torch.resilience import checkpoint

    tmp = tmp_path_factory.mktemp("single")
    ck = {c: tmp / f"ck_{c}" for c in CASES}
    kill = {c: _run(["single", c, ck[c], tmp / f"{c}.bin"], KILL_AFTER)
            for c in CASES}
    ref = {c: _run(["single", c, tmp / f"ref_{c}", tmp / f"ref_{c}.bin"])
           for c in CASES}
    got = {}
    for c in CASES:
        (rc, out), = _wait([kill[c]])
        assert rc == -signal.SIGKILL, (c, rc, out[-2000:])
        assert not (tmp / f"{c}.bin").exists()
        got[c] = checkpoint.load_latest(str(ck[c]))[1]
    again = {c: _run(["single", c, ck[c], tmp / f"{c}.bin"]) for c in CASES}
    for c in CASES:
        for rc, out in _wait([again[c], ref[c]]):
            assert rc == 0, (c, out[-3000:])
    return {c: ((tmp / f"{c}.bin").read_bytes(),
                (tmp / f"ref_{c}.bin").read_bytes(), got[c]) for c in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sigkill_resume_equals_the_straight_run(killed_and_resumed, case):
    resumed, straight, at_kill = killed_and_resumed[case]
    assert 1 <= at_kill <= KILL_AFTER - 1
    assert json.loads(resumed)["learner"]["gradient_booster"]["model"][
        "gbtree_model_param"]["num_trees"] == str(
            ROUNDS * CASES[case].get("num_parallel_tree", 1))
    assert resumed == straight


def test_sigkill_during_a_write_keeps_the_previous_checkpoint(
        killed_and_resumed, tmp_path):
    """``XGBTPU_TEST_CKPT_WRITE_DELAY`` holds each write for a second
    before its tmp file: a SIGKILL then lands while round 2's write is in
    flight. The newest verified checkpoint is round 1's, a torn tmp file
    beside it is ignored, and the rerun ends with the straight bytes."""
    from xgboost_tpu_torch.resilience import checkpoint

    ck = tmp_path / "ck"
    p = subprocess.Popen(
        [sys.executable, __file__, "single", "plain", str(ck),
         str(tmp_path / "m.bin"), "0"], cwd=ROOT,
        env=_env(XGBTPU_TEST_CKPT_WRITE_DELAY="1.0"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while not (ck / "ckpt_00000001.ckpt").exists():
            assert p.poll() is None and time.time() < deadline, \
                p.communicate()[0][-2000:]
            time.sleep(0.02)
        time.sleep(0.3)  # round 2's write is now held by the delay
        p.send_signal(signal.SIGKILL)
        assert p.wait(timeout=30) == -signal.SIGKILL
    finally:
        if p.poll() is None:
            p.kill()
        p.communicate()
    assert checkpoint.load_latest(str(ck))[1] == 1
    (ck / "ckpt_00000002.ckpt.tmp.1.2").write_bytes(b'{"format": "xgb')
    (rc, out), = _wait([_run(["single", "plain", ck, tmp_path / "m.bin"])])
    assert rc == 0, out[-3000:]
    assert (tmp_path / "m.bin").read_bytes() == killed_and_resumed["plain"][1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_resumed_caches_hold_the_straight_margins(case, tmp_path):
    import xgboost_tpu_torch as xgbt

    X, y = data()
    params = {**PARAMS, **CASES[case]}
    d = xgbt.DMatrix(X, y, device="cpu")
    dv = xgbt.DMatrix(X[:500], y[:500], device="cpu")
    bst = xgbt.train(params, d, KILL_AFTER, evals=[(dv, "v")],
                     verbose_eval=False)
    loaded = xgbt.Booster(params, model_file=bst.save_raw(), device="cpu")
    loaded._fill_caches_by_round(d, [dv])
    for m in (d, dv):
        want = bst._caches[id(m)]
        got = loaded._caches[id(m)]
        assert got.num_trees == want.num_trees
        assert torch.equal(got.margin, want.margin), case


def test_append_mode_equals_the_straight_run(tmp_path):
    import xgboost_tpu_torch as xgbt

    X, y = data()
    d = xgbt.DMatrix(X, y, device="cpu")
    ck = str(tmp_path / "ck")
    first = xgbt.train(PARAMS, d, 3, verbose_eval=False, resume_from=ck)
    assert first.num_boosted_rounds() == 3
    more = xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), 2,
                      verbose_eval=False, resume_from=ck,
                      resume_mode="append")
    straight = xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), 5,
                          verbose_eval=False)
    assert more.save_raw() == straight.save_raw()
    from xgboost_tpu_torch.resilience import checkpoint

    assert checkpoint.load_latest(ck)[1] == 5
    assert [os.path.basename(p) for p in checkpoint.list_checkpoints(ck)] \
        == ["ckpt_00000004.ckpt", "ckpt_00000005.ckpt"]
    # total mode on a complete checkpoint trains nothing more
    done = xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), 5,
                      verbose_eval=False, resume_from=ck)
    assert done.save_raw() == straight.save_raw()


def test_watchdog_abort_commits_its_rounds(tmp_path, monkeypatch):
    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch.learner import Booster
    from xgboost_tpu_torch.resilience import WatchdogTimeout, checkpoint

    X, y = data()
    straight = xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), ROUNDS,
                          verbose_eval=False)
    orig = Booster.update
    calls = [0]

    def wedge_third_round(self, dtrain, iteration, fobj=None):
        calls[0] += 1
        if calls[0] == 3:
            for _ in range(200):
                time.sleep(0.05)
        return orig(self, dtrain, iteration, fobj)

    monkeypatch.setattr(Booster, "update", wedge_third_round)
    monkeypatch.setenv("XGBTPU_WATCHDOG", "round_dispatch=0.5")
    ck = str(tmp_path / "ck")
    t0 = time.time()
    with pytest.raises(WatchdogTimeout) as ei:
        xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), ROUNDS,
                   verbose_eval=False, resume_from=ck)
    assert ei.value.site == "round_dispatch" and time.time() - t0 < 8
    assert checkpoint.load_latest(ck)[1] == 2
    monkeypatch.delenv("XGBTPU_WATCHDOG")
    monkeypatch.setattr(Booster, "update", orig)
    bst = xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), ROUNDS,
                     verbose_eval=False, resume_from=ck)
    assert bst.save_raw() == straight.save_raw()


def _pair(tmp_path, ck, tag, kill_after=0, env1=None):
    """World 2's two ranks run side by side (rank 1 with ``env1``): their
    exit codes and outputs, and their models in ``rank<r>.bin``."""
    return _wait([_run(["rank", r, tmp_path / f"pg_{tag}", ck,
                        tmp_path / f"rank{r}.bin"], kill_after,
                       **(env1 if r == 1 and env1 else {}))
                  for r in (0, 1)])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """World 2 killed on both ranks after round ``KILL_AFTER`` and rerun:
    (checkpoint root, each rank's newest round after the kill, each
    rank's final bytes, the single process's bytes)."""
    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch.resilience import checkpoint

    tmp = tmp_path_factory.mktemp("world2")
    ck = tmp / "ck"
    for rc, out in _pair(tmp, ck, "kill", KILL_AFTER):
        assert rc == -signal.SIGKILL, (rc, out[-2000:])
    at_kill = []
    for r in (0, 1):
        got = checkpoint.load_latest(str(ck / f"rank{r}"))
        at_kill.append(None if got is None else got[1])
    for rc, out in _pair(tmp, ck, "resume"):
        assert rc == 0, out[-3000:]
    raws = [(tmp / f"rank{r}.bin").read_bytes() for r in (0, 1)]
    X, y = data()
    one = xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), ROUNDS,
                     verbose_eval=False)
    return ck, at_kill, raws, one.save_raw()


def test_world2_resume_writes_rank_dirs_and_equals_one_process(world2):
    ck, at_kill, raws, one = world2
    assert sorted(os.listdir(ck)) == ["rank0", "rank1"]
    for got in at_kill:
        assert got is not None and 1 <= got <= KILL_AFTER - 1
    assert raws[0] == raws[1] == one


def test_world2_ranks_killed_at_different_rounds_resume_together(
        world2, tmp_path):
    """Rank 1's writes are held in flight (``XGBTPU_TEST_CKPT_WRITE_DELAY``)
    and both ranks are killed once rank 0 has committed round 3: rank 0's
    newest is 3, rank 1's is 2. The rerun resumes both from 2, the newest
    round both hold, and ends with the single process's bytes. The writes
    run on the training thread (``XGBTPU_ASYNC_CKPT=0``), so a held write
    holds its rank's round: the async writer's one slot would hold rank 1
    a round further back, with no round in common with rank 0's."""
    from xgboost_tpu_torch.resilience import checkpoint

    ck = tmp_path / "ck"
    procs = [_run(["rank", r, tmp_path / "pg_kill", ck,
                   tmp_path / f"rank{r}.bin"], XGBTPU_ASYNC_CKPT="0",
                  **({"XGBTPU_TEST_CKPT_WRITE_DELAY": "1.5"} if r else {}))
             for r in (0, 1)]
    try:
        deadline = time.time() + 90
        while not (ck / "rank0" / "ckpt_00000003.ckpt").exists():
            assert all(p.poll() is None for p in procs) \
                and time.time() < deadline, \
                [p.communicate()[0][-2000:] for p in procs]
            time.sleep(0.02)
        for p in procs:
            p.send_signal(signal.SIGKILL)
        assert [p.wait(timeout=30) for p in procs] == [-signal.SIGKILL] * 2
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    newest = [checkpoint.load_latest(str(ck / f"rank{r}"))[1]
              for r in (0, 1)]
    assert newest == [3, 2]
    for rc, out in _pair(tmp_path, ck, "resume"):
        assert rc == 0, out[-3000:]
    assert (tmp_path / "rank0.bin").read_bytes() \
        == (tmp_path / "rank1.bin").read_bytes() == world2[3]


@pytest.mark.parametrize("held", ["one_behind", "none_in_common"])
def test_world2_resume_agrees_on_a_round_every_rank_holds(
        world2, tmp_path, held):
    """From the finished world-2 run (each rank holds rounds 5 and 6):
    ``one_behind`` flips a bit in rank 1's round 6, so the ranks resume
    from 5; ``none_in_common`` leaves rank 1 only a checkpoint of round 4,
    so no round is held by both and both train from the start. Either
    way both ranks end with the single process's bytes."""
    import shutil

    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch.resilience import checkpoint

    ck = tmp_path / "ck"
    shutil.copytree(world2[0], ck)
    r1 = ck / "rank1"
    assert [checkpoint.path_rounds(p) for p in
            checkpoint.list_checkpoints(str(r1))] == [5, 6]
    if held == "one_behind":
        path = r1 / "ckpt_00000006.ckpt"
        raw = bytearray(path.read_bytes())
        raw[-10] ^= 1
        path.write_bytes(bytes(raw))
    else:
        for p in checkpoint.list_checkpoints(str(r1)):
            os.unlink(p)
        X, y = data()
        four = xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), 4,
                          verbose_eval=False)
        checkpoint.save_checkpoint(str(r1), four, 4)
    for rc, out in _pair(tmp_path, ck, "resume"):
        assert rc == 0, out[-3000:]
    assert (tmp_path / "rank0.bin").read_bytes() \
        == (tmp_path / "rank1.bin").read_bytes() == world2[3]
    assert checkpoint.load_latest(str(r1))[1] == ROUNDS


def test_resumed_model_equals_the_jax_straight_run(killed_and_resumed):
    import xgboost_tpu as xgb

    resumed = json.loads(killed_and_resumed["plain"][0])
    X, y = data()
    jb = xgb.train(PARAMS, xgb.DMatrix(X, label=y), ROUNDS,
                   verbose_eval=False)
    jtrees = json.loads(jb.save_raw())["learner"]["gradient_booster"][
        "model"]["trees"]
    ttrees = resumed["learner"]["gradient_booster"]["model"]["trees"]
    assert len(jtrees) == len(ttrees) == ROUNDS
    for a, b in zip(jtrees, ttrees):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        internal = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[internal],
            np.asarray(b["split_conditions"], np.float32)[internal])
        np.testing.assert_allclose(b["base_weights"], a["base_weights"],
                                   rtol=1e-6, atol=1e-6)


if __name__ == "__main__":
    if sys.argv[1] == "single":
        single_worker(sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]))
    else:
        rank_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
                    int(sys.argv[6]))
