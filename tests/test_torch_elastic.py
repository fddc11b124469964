"""Elastic training of the port (``elastic_train``, ``parallel/
membership.py``, ``form_world``) and its readers (``obs-report``,
``trace-report``), held against the JAX package and the port's own single
process.

Workers are this file run as a script: CPU matrices, gloo, the JAX test's
data and parameters (``tests/elastic_worker.py``: 2400 x 5, depth 3,
``max_bin`` 16, 6 rounds), ``XGBTPU_HEARTBEAT`` 0.25 s; they import only
the port. The JAX package runs here, in the test process.

- membership: a port ``Membership`` and a JAX one watch each other's
  heartbeat files in one directory: each sees the other alive, beats
  dropped below the deadline kill no one, each sees the other dead within
  ``hb_deadline() + 2`` s after its beats stop, and a tombstone written by
  either fences its owner in the other; the heartbeat agent's
  ``heartbeat_drop`` predicate fires on the same hits as the JAX agent's
  and as ``resilience.chaos`` for every form of the grammar;
- ``cuts.json``: the port's manifest equals the JAX package's as parsed
  JSON (dense and CSR, ``max_bin`` 16 and 256), and each package bins
  against the other's manifest to the same bins;
- 2 -> 1 by SIGKILL (rank 1 armed with ``worker_kill:permanent:3``): rank
  1 dies by SIGKILL, rank 0 exits 0, ``quiesce/`` holds a snapshot of k
  rounds (0 < k < 6), the survivor's ``save_raw()`` equals the port's
  uninterrupted single process on all rows and its continuation from the
  snapshot byte for byte, JAX ``train(xgb_model=snapshot)`` gives the same
  trees (structure and split conditions exact, leaf values within 1e-5,
  the margin tolerance of ``tests/test_torch_training.py``, loss changes
  within rtol 1e-5), and the exposition holds
  the JAX test's elastic lines; a kill before the first checkpoint gives
  the uninterrupted model's bytes; a transient collective fault on every
  rank with every heartbeat alive re-raises on both and shrinks nothing;
- 3 -> 2 by re-exec: both survivors restart for generation 1 and end with
  the single process's model; the death of the generation's rank 0 (the
  store's host) restarts the survivor's process too, with the same model;
- ``obs-report`` and ``trace-report`` print (and write) what the JAX
  package's do on the 2 -> 1 run's directory, the fleet table counting
  the replayed round; an empty directory exits 1.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
N, F, ROUNDS = 2400, 5, 6
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
          "max_bin": 16, "seed": 7, "verbosity": 0}
HEARTBEAT = "0.25"
#: the heartbeat_drop grammar's forms, each alone and combined
DROP_SCHEDULES = ("5", "2-4", "7+", "%3", "p0.3@42", "p0.5", "1,9-11,%13")


def make_data():
    rng = np.random.RandomState(0)
    X = rng.randn(N, F).astype(np.float32)
    w = rng.randn(F)
    y = ((X @ w) + 0.5 * rng.randn(N) > 0).astype(np.float32)
    return X, y


def data_fn(r, world):
    """Contiguous blocks of one global row order, on the CPU."""
    import xgboost_tpu_torch as xgbt

    X, y = make_data()
    lo, hi = r * N // world, (r + 1) * N // world
    return xgbt.DMatrix(X[lo:hi], y[lo:hi], device="cpu")


def run_worker(rank, port, outdir, rounds, world):
    """One elastic worker: trains, writes its model bytes, exposition and
    meta under ``outdir``, leaves through ``elastic_exit``."""
    torch.set_num_threads(1)
    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch.observability import REGISTRY

    bst = xgbt.elastic_train(PARAMS, data_fn, rounds, run_dir=outdir,
                             world=world, rank=rank,
                             coordinator=f"localhost:{port}",
                             backend="gloo")
    out = Path(outdir)
    (out / f"model_rank{rank}.json").write_bytes(bytes(bst.save_raw()))
    (out / f"metrics_rank{rank}.prom").write_text(REGISTRY.exposition())
    (out / f"meta_rank{rank}.json").write_text(json.dumps(
        {"rounds": bst.num_boosted_rounds(), "rank": rank}))
    print(f"rank {rank} done ({bst.num_boosted_rounds()} rounds)",
          flush=True)
    xgbt.elastic_exit(0)


def _free_port():
    """A base port whose next port is free too (generation 1 meets
    there)."""
    while True:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        try:
            with socket.socket() as s:
                s.bind(("localhost", port + 1))
            return port
        except OSError:
            continue


def _run_world(outdir, world, chaos, rounds=ROUNDS, timeout=240):
    """Start ``world`` workers (``chaos``: rank -> ``XGBTPU_CHAOS``) and
    wait for all: ``[(returncode, output)]`` by rank."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT), XGBTPU_HEARTBEAT=HEARTBEAT,
                   OMP_NUM_THREADS="1")
        env.pop("XGBTPU_CHAOS", None)
        if r in chaos:
            env["XGBTPU_CHAOS"] = chaos[r]
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(port),
             str(outdir), str(rounds), str(world)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _port_train(rounds, xgb_model=None):
    import xgboost_tpu_torch as xgbt

    X, y = make_data()
    return xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), rounds,
                      xgb_model=xgb_model, verbose_eval=False)


@pytest.fixture(scope="module")
def straight():
    """The port's uninterrupted single-process model bytes."""
    return bytes(_port_train(ROUNDS).save_raw())


@pytest.fixture(scope="module")
def killed_run(tmp_path_factory):
    """The 2 -> 1 run: rank 1 SIGKILLed at its third round boundary."""
    out = tmp_path_factory.mktemp("elastic_2to1")
    return out, _run_world(out, 2, {1: "worker_kill:permanent:3"})


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------


def test_membership_against_the_jax_package(tmp_path, monkeypatch):
    from xgboost_tpu.parallel import membership as jm

    from xgboost_tpu_torch.parallel import membership as tm

    monkeypatch.setenv("XGBTPU_HEARTBEAT", "0.2")
    # both agents drop beats 2-3 (a 0.4 s gap, under the 1 s deadline)
    monkeypatch.setenv("XGBTPU_CHAOS", "heartbeat_drop:transient:2-3")
    d = str(tmp_path / "members")
    port = tm.Membership(d, 0, [0, 1, 2]).start()
    jax = jm.Membership(d, 1, [0, 1, 2]).start()
    port2 = None
    try:
        time.sleep(0.8)  # spans the dropped beats
        assert 1 not in port.scan() and 0 not in jax.scan()

        def dead_within(watcher, rank):
            t0 = time.monotonic()
            while rank not in watcher.scan() and time.monotonic() - t0 < 8:
                time.sleep(0.05)
            return rank in watcher.dead_ranks(), time.monotonic() - t0

        # the JAX worker's beats stop: the port sees it dead in time
        jax.stop()
        ok, took = dead_within(port, 1)
        assert ok and took < tm.hb_deadline() + 2.0, took
        # and the other way round: a JAX monitor over a port worker
        watcher = jm.Membership(d, 2, [0, 1, 2]).start()
        try:
            time.sleep(0.5)
            assert 0 not in watcher.scan()
            port.stop()
            ok, took = dead_within(watcher, 0)
            assert ok and took < jm.hb_deadline() + 2.0, took
            # a tombstone by either package fences its owner in the other
            port2 = tm.Membership(d, 3, [0, 1, 2, 3]).start()
            watcher.declare_dead(3)
            port2.scan()
            assert port2.fenced
            port2.declare_dead(2)
            watcher.scan()
            assert watcher.fenced
        finally:
            watcher.stop()
    finally:
        for m in (port, jax, port2):
            if m is not None:
                m.stop()


def _agent_preds(src):
    """The ``_preds`` function of a heartbeat agent's source."""
    ns = {}
    exec("import os, zlib\n"
         + src[src.index("SITE = "):src.index("preds = _preds(")], ns)
    return ns["_preds"]


@pytest.mark.parametrize("sched", DROP_SCHEDULES)
def test_heartbeat_drop_fires_on_the_hits_of_chaos(sched):
    from xgboost_tpu.parallel import membership as jm

    from xgboost_tpu_torch.parallel import membership as tm
    from xgboost_tpu_torch.resilience import chaos

    cfg = f"heartbeat_drop:transient:{sched}"
    hits = range(1, 101)
    port = _agent_preds(tm._AGENT_SRC)(cfg)
    jax = _agent_preds(jm._AGENT_SRC)(cfg)
    got_port = [n for n in hits if any(p(n) for p in port)]
    got_jax = [n for n in hits if any(p(n) for p in jax)]
    with chaos.configure(cfg) as plan:
        for _ in hits:
            try:
                chaos.hit("heartbeat_drop")
            except chaos.ChaosError:
                pass
    assert got_port == got_jax == [n for _, n, _ in plan.fired]
    assert 0 < len(got_port) < len(hits)


# ---------------------------------------------------------------------------
# the cuts manifest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "csr"])
@pytest.mark.parametrize("max_bin", [16, 256])
def test_cuts_manifest_matches_the_jax_package(tmp_path, layout, max_bin):
    import scipy.sparse as sp
    import xgboost_tpu as xgb
    from xgboost_tpu import training as jtr

    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch import training as ttr

    rng = np.random.RandomState(3)
    X = rng.randn(3000, F).astype(np.float32)
    if layout == "csr":
        X[rng.rand(*X.shape) < 0.6] = 0.0
        X = sp.csr_matrix(X)
    y = (rng.rand(3000) > 0.5).astype(np.float32)

    def jfn(r, world):
        return xgb.DMatrix(X, label=y)

    def tfn(r, world):
        return xgbt.DMatrix(X, y, device="cpu")

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jcuts = jtr._canonical_cuts(str(jdir), jfn, max_bin, 0, [0])
    tcuts = ttr._canonical_cuts(str(tdir), tfn, max_bin, 0, [0])
    jm = json.loads((jdir / "cuts.json").read_text())
    tm = json.loads((tdir / "cuts.json").read_text())
    assert tm == jm
    np.testing.assert_array_equal(tcuts.values, jcuts.values)
    # each package bins against the other's manifest: the same bins
    (jdir / "x").mkdir()
    (tdir / "x").mkdir()
    shutil.copy(tdir / "cuts.json", jdir / "x" / "cuts.json")
    shutil.copy(jdir / "cuts.json", tdir / "x" / "cuts.json")
    jb = jtr._bin_with_cuts(jfn(0, 1), jtr._canonical_cuts(
        str(jdir / "x"), jfn, max_bin, 1, [0, 1]), max_bin)
    tb = ttr._bin_with_cuts(tfn(0, 1), ttr._canonical_cuts(
        str(tdir / "x"), tfn, max_bin, 1, [0, 1]), max_bin)
    jbins = np.asarray(jb.get_binned(max_bin).bins)[:3000]
    tbins = tb.get_binned(max_bin).bins.numpy()
    np.testing.assert_array_equal(tbins.astype(np.int64),
                                  jbins.astype(np.int64))


# ---------------------------------------------------------------------------
# elastic runs
# ---------------------------------------------------------------------------


def _trees(raw):
    return json.loads(raw)["learner"]["gradient_booster"]["model"]["trees"]


def test_sigkill_shrinks_to_one_and_replays_bit_for_bit(killed_run,
                                                        straight):
    import xgboost_tpu as xgb

    out, [(rc0, out0), (rc1, out1)] = killed_run
    assert rc1 == -signal.SIGKILL, f"rank 1 was not SIGKILLed:\n{out1}"
    assert rc0 == 0, f"survivor failed:\n{out0[-4000:]}"
    assert json.loads((out / "meta_rank0.json").read_text())["rounds"] == 6
    qfiles = sorted(os.listdir(out / "quiesce"))
    assert qfiles, "the resize keeps its quiesce snapshot"
    from xgboost_tpu_torch.resilience.checkpoint import read_checkpoint

    raw, done = read_checkpoint(str(out / "quiesce" / qfiles[0]))
    assert 0 < done < ROUNDS, done
    elastic = (out / "model_rank0.json").read_bytes()
    assert elastic == straight, "elastic model != uninterrupted run"
    assert elastic == bytes(_port_train(ROUNDS - done, bytes(raw)).save_raw())
    # the JAX package's continuation from the same snapshot
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        X, y = make_data()
        jb = xgb.train(PARAMS, xgb.DMatrix(X, label=y), ROUNDS - done,
                       xgb_model=bytes(raw), verbose_eval=False)
    jt, tt = _trees(bytes(jb.save_raw())), _trees(elastic)
    assert len(jt) == len(tt) == ROUNDS
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        internal = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[internal],
            np.asarray(b["split_conditions"], np.float32)[internal])
        # leaf values within the parity tests' margin tolerance, 1e-5: on
        # these rows the packages' straight 6-round runs already differ by
        # 1.6e-6 on a leaf of -0.058 (the port's gradients round once from
        # float64, the JAX package's are float32)
        np.testing.assert_allclose(b["base_weights"], a["base_weights"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(b["loss_changes"])[internal],
                                   np.asarray(a["loss_changes"])[internal],
                                   rtol=1e-5)
    prom = (out / "metrics_rank0.prom").read_text()
    assert "membership_changes_total 1" in prom
    assert "worker_restarts_total 1" in prom
    assert "elastic_resume_rounds_replayed" in prom
    assert 'worker_alive{rank="0"} 1' in prom
    assert 'worker_alive{rank="1"} 0' in prom
    assert "faults_total" in prom


def test_kill_before_the_first_checkpoint_gives_the_straight_model(
        tmp_path, straight):
    [(rc0, out0), (rc1, _)] = _run_world(tmp_path, 2,
                                         {1: "worker_kill:permanent:1"})
    assert rc1 == -signal.SIGKILL
    assert rc0 == 0, f"survivor failed:\n{out0[-4000:]}"
    assert (tmp_path / "model_rank0.json").read_bytes() == straight


def test_transient_collective_fault_re_raises_and_shrinks_nothing(tmp_path):
    """Every rank's 6th guarded collective fails (a scripted transient
    deadline): no heartbeat stops, so nothing shrinks and both re-raise."""
    chaos = "collective_timeout:transient:6"
    res = _run_world(tmp_path, 2, {0: chaos, 1: chaos})
    for rc, out in res:
        assert rc not in (0, -signal.SIGKILL), out[-4000:]
        assert "CollectiveError" in out and "chaos" in out, out[-4000:]
        assert "resizing world" not in out
    assert not (tmp_path / "generation.json").exists()
    assert not (tmp_path / "quiesce").exists()


def test_three_to_two_by_re_exec(tmp_path, straight):
    res = _run_world(tmp_path, 3, {2: "worker_kill:permanent:2"})
    assert res[2][0] == -signal.SIGKILL
    for rc, out in res[:2]:
        assert rc == 0, out[-4000:]
        assert "re-executing worker for generation 1" in out
    m0 = (tmp_path / "model_rank0.json").read_bytes()
    assert m0 == (tmp_path / "model_rank1.json").read_bytes() == straight


def test_coordinator_loss_restarts_the_survivor(tmp_path, straight):
    """The generation's rank 0 hosts the store: its death is recovered by a
    restart of the survivor's process, never by a resize in place."""
    res = _run_world(tmp_path, 2, {0: "worker_kill:permanent:3"})
    assert res[0][0] == -signal.SIGKILL
    rc, out = res[1]
    assert rc == 0, out[-4000:]
    assert "re-executing worker for generation 1 (world 1)" in out
    assert (tmp_path / "model_rank1.json").read_bytes() == straight


# ---------------------------------------------------------------------------
# obs-report and trace-report
# ---------------------------------------------------------------------------


def _report(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_obs_report_matches_the_jax_package(killed_run, capsys, tmp_path):
    from xgboost_tpu.observability import fleet as jfleet

    from xgboost_tpu_torch.observability import fleet as tfleet

    out, _ = killed_run
    obs = out / "obs"

    def outputs(main):
        rc, text = _report(main, [str(out)], capsys)
        rollup = json.loads((obs / "metrics_rollup.json").read_text())
        merged = [json.loads(ln.rstrip(",")) for ln in
                  (obs / "merged.trace.json").read_text().splitlines()[1:]
                  if ln.strip()]
        return rc, text, rollup, merged

    jax, port = outputs(jfleet.main), outputs(tfleet.main)
    assert port[0] == jax[0] == 0
    assert port[1] == jax[1]
    assert port[2] == jax[2] and port[3] == jax[3]
    table = port[2]["fleet_table"]
    assert table["replayed_rounds"] >= 1
    assert {r["gen"] for r in table["rounds"]} == {0, 1}
    for name in ("worker_lost", "elastic_quiesce", "elastic_resize",
                 "elastic_replay"):
        assert f"  {name}: " in port[1], name
    assert "obs-report: 2 rank(s)" in port[1]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tfleet.main([str(empty)]) == 1
    assert tfleet.main([]) == 1


def test_trace_report_matches_the_jax_package(killed_run, capsys):
    from xgboost_tpu.observability import report as jrep

    from xgboost_tpu_torch.observability import report as trep

    out, _ = killed_run
    files = sorted(str(p) for p in (out / "obs").glob("rank*/trace.jsonl"))
    assert len(files) == 2
    glob = str(out / "obs" / "rank*" / "trace.jsonl")
    for argv in (files[:1], [glob], [glob, "--top", "5"]):
        j = _report(jrep.main, argv, capsys)
        t = _report(trep.main, argv, capsys)
        assert t == j and t[0] == 0
        assert "elastic_" in t[1] or argv == files[1:]
    assert trep.main([str(out / "nothing.json")]) == 1


if __name__ == "__main__":
    run_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
               int(sys.argv[4]), int(sys.argv[5]))
