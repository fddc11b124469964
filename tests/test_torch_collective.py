"""The port's collective layer (``xgboost_tpu_torch/collective.py``) at
world 1 and world 2, held against numpy and the JAX package's
``collective``.

Worlds of one and of two ranks (gloo on the CPU, ``file://`` rendezvous)
are started once for the module; each rank runs the checks of the JAX
package's two-process test (``tests/test_multiprocess.py``: queries,
``allreduce`` SUM/MAX/MIN, ``broadcast`` of rank-dependent payloads from
root 0 and root 1) and ``reduce_histogram`` on int64 payloads, float32
payloads on a power-of-two grid and off it, and pre-quantised payloads
with ``scale=``, plus the device-tensor helpers, and writes what it got;
the tests here compare. The worker imports only the port (it runs this
file as a script). ``_grid_lsb_exp`` and the world-1 ``reduce_histogram``
equal the JAX package's on the same arrays, and a failing collective
raises the typed ``CollectiveError``.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PAYLOADS = ("int64", "grid", "off_grid", "scale")


def payload(kind: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s ``[4, 8]`` histogram of kind ``kind``."""
    rng = np.random.RandomState(10 * rank + PAYLOADS.index(kind))
    if kind in ("int64", "scale"):
        return rng.randint(-3000, 3000, (4, 8)).astype(np.int64)
    if kind == "grid":  # every value a multiple of 2^-6
        return (rng.randint(-500, 500, (4, 8)) / 64.0).astype(np.float32)
    return rng.randn(4, 8).astype(np.float32)


# ---------------------------------------------------------------------------
# the worker (run as a script; imports only the port)
# ---------------------------------------------------------------------------

def run_worker(rank: int, world: int, init_file: str, out: str) -> None:
    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch import collective as coll
    from xgboost_tpu_torch.observability import comms
    from xgboost_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    mesh = init_distributed(f"file://{init_file}", world, rank,
                            backend="gloo", device="cpu")
    res = {"queries": (coll.get_rank(), coll.get_world_size(),
                       coll.is_distributed(), mesh.rank, mesh.world_size),
           "rabit_is_collective": xgbt.rabit is coll}
    mine = np.array([float(rank + 1), -float(rank)])
    res["allreduce"] = {op.name: coll.allreduce(mine, op) for op in coll.Op}
    res["bcast0"] = coll.broadcast({"thresh": 0.25 + rank, "rank": rank},
                                   root=0)
    res["bcast1"] = coll.broadcast(np.arange(3) + rank, root=world - 1)
    res["hist"] = {k: coll.reduce_histogram(
        payload(k, rank), site="test",
        scale=2.0 ** -6 if k == "scale" else None) for k in PAYLOADS}
    res["big_sum"] = coll.allreduce(
        np.full(512, rank + 1, np.int64), coll.Op.SUM)
    res["gather"] = coll.process_allgather(
        np.array([rank, rank % 2 == 0]), site="test")
    t = torch.full((3,), float(rank + 1))
    res["dev_sum"] = coll.all_reduce(t.clone(), mesh).numpy()
    res["dev_max"] = coll.all_reduce(t.clone(), mesh, coll.Op.MAX).numpy()
    res["dev_min"] = coll.all_reduce(
        torch.arange(3, dtype=torch.int64) * (rank + 1), mesh,
        coll.Op.MIN).numpy()
    res["dev_gather"] = coll.all_gather(t, mesh).numpy()
    res["stats"] = comms.snapshot(by="site")
    coll.finalize()
    res["after_finalize"] = (coll.get_rank(), coll.get_world_size())
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spawn(out: Path, world: int, timeout: float = 120) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(out / "pg"),
         str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return procs


def _collect(out: Path, world: int, procs, timeout: float = 120) -> list:
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-4000:]}"
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: results in rank order}, both worlds run together."""
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in (1, 2)}
    procs = {w: spawn(dirs[w], w) for w in (1, 2)}
    return {w: _collect(dirs[w], w, procs[w]) for w in (1, 2)}


@pytest.mark.parametrize("world", [1, 2])
def test_queries(worlds, world):
    for r, res in enumerate(worlds[world]):
        assert res["queries"] == (r, world, world > 1, r, world)
        assert res["rabit_is_collective"]
        assert res["after_finalize"] == (0, 1)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN"])
def test_allreduce(worlds, world, op):
    mine = [np.array([float(r + 1), -float(r)]) for r in range(world)]
    want = {"SUM": np.sum, "MAX": np.max, "MIN": np.min}[op](
        np.stack(mine), axis=0)
    for res in worlds[world]:
        np.testing.assert_array_equal(res["allreduce"][op], want)


@pytest.mark.parametrize("world", [1, 2])
def test_broadcast_from_each_root(worlds, world):
    for res in worlds[world]:
        assert res["bcast0"] == {"thresh": 0.25, "rank": 0}
        np.testing.assert_array_equal(res["bcast1"], np.arange(3) + world - 1)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("kind", PAYLOADS)
def test_reduce_histogram_is_the_exact_sum(worlds, world, kind):
    parts = [payload(kind, r) for r in range(world)]
    if kind == "scale":
        want = (np.sum(parts, axis=0).astype(np.float64) * 2.0 ** -6
                ).astype(np.float32)
    elif kind == "off_grid":
        want = np.sum(np.stack(parts), axis=0)
    else:
        want = np.sum(np.stack(parts).astype(np.float64), axis=0).astype(
            parts[0].dtype if kind == "grid" else np.int64)
    for res in worlds[world]:
        got = res["hist"][kind]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_large_sum_and_gather(worlds):
    for res in worlds[2]:
        np.testing.assert_array_equal(res["big_sum"], np.full(512, 3))
        np.testing.assert_array_equal(res["gather"],
                                      np.array([[0, 1], [1, 0]]))


def test_device_helpers(worlds):
    for res in worlds[2]:
        np.testing.assert_array_equal(res["dev_sum"], [3.0] * 3)
        np.testing.assert_array_equal(res["dev_max"], [2.0] * 3)
        np.testing.assert_array_equal(res["dev_min"], [0, 1, 2])
        np.testing.assert_array_equal(res["dev_gather"],
                                      [[1.0] * 3, [2.0] * 3])
        assert res["stats"]["all_reduce"] == {"ops": 3, "bytes": 3 * 4 +
                                              3 * 4 + 3 * 8}


def test_device_helpers_are_the_identity_without_a_group():
    from xgboost_tpu_torch import collective as coll

    t = torch.arange(4.0)
    assert coll.all_reduce(t, None) is t
    np.testing.assert_array_equal(coll.all_gather(t, None).numpy(),
                                  t[None].numpy())


@pytest.mark.parametrize("kind", ["int", "grid", "off_grid", "zeros",
                                  "tiny"])
def test_grid_lsb_exp_matches_jax(kind):
    from xgboost_tpu import collective as jcoll

    from xgboost_tpu_torch import collective as coll

    rng = np.random.RandomState(7)
    arr = {"int": rng.randint(-90, 90, 64).astype(np.float32) * 4,
           "grid": (rng.randint(-500, 500, 64) / 256.0).astype(np.float32),
           "off_grid": rng.randn(64).astype(np.float32),
           "zeros": np.zeros(8, np.float32),
           "tiny": np.array([0.0, 2.0 ** -40, 3 * 2.0 ** -41], np.float32),
           }[kind]
    assert coll._grid_lsb_exp(arr) == jcoll._grid_lsb_exp(arr)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_world1_reduce_histogram_matches_jax(kind):
    from xgboost_tpu import collective as jcoll

    from xgboost_tpu_torch import collective as coll

    arr = payload(kind, 0)
    scale = 2.0 ** -6 if kind == "scale" else None
    got = coll.reduce_histogram(arr, site="test", scale=scale)
    want = jcoll.reduce_histogram(arr, site="test", scale=scale)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_failures_are_typed():
    """``guarded`` types a failure as the JAX package's ``guarded`` does:
    ``resilience.policy``'s kind and worker-loss verdict, the same on the
    same failures."""
    from xgboost_tpu import collective as jcoll

    from xgboost_tpu_torch import collective as coll

    failures = [RuntimeError("Connection reset by peer"),
                RuntimeError("operation timed out after 600 s"),
                RuntimeError("[gloo] Gloo all-reduce failed: socket closed"),
                RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"),
                NotImplementedError("no such collective"),
                ConnectionError("broken pipe")]
    kinds = []
    for exc in failures:
        def fail(exc=exc):
            raise exc

        got = []
        for mod in (coll, jcoll):
            with pytest.raises(mod.CollectiveError) as e:
                mod.guarded("level_hist", fail)
            got.append((e.value.site, e.value.kind, e.value.worker_lost,
                        e.value.cause is exc))
        assert got[0] == got[1], (exc, got)
        kinds.append(got[0][1:3])
    assert kinds == [("transient", True), ("transient", False),
                     ("transient", True), ("resource", False),
                     ("permanent", False), ("transient", True)]
    with pytest.raises(TypeError):
        coll.reduce_histogram(np.zeros(3, np.float32), site="t", scale=1.0)


if __name__ == "__main__":
    run_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
