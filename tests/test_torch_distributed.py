"""Distributed training of the port over ``torch.distributed``, held
against the JAX package and against the port's own single process.

Two ranks on the CPU (gloo, ``file://`` rendezvous) are started once for
the module; each runs every case on its own rows and writes its results,
and the tests here read them. The worker imports only the port (it runs
this file as a script); the JAX package runs here, in the test process, on
the conftest's 8 virtual CPU devices with ``make_mesh(2)``.

- the distributed sketch at world 2 equals JAX ``distributed_compute_cuts``
  on a 2-device mesh holding the same halves bitwise, at unit weights and
  with row weights, at max_bin 16, 100 and 128 (5% NaN), the prefix sums
  associated as XLA:CPU's ``jnp.cumsum``; both ranks hold the same cuts;
- ``distributed_grow_tree_fused`` at world 2 equals the port's
  ``grow_tree_fused`` on all rows bitwise in every field, the deltas in
  rank order (ragged shards, and shards whose largest gradient differs by
  2^10), and JAX ``distributed_grow_tree_fused`` within rtol/atol 1e-5;
- ``train`` at world 2 with ragged shards on shared cuts
  (``QuantileDMatrix(ref=)``) gives both ranks the single process's model
  bytes (``binary:logistic`` and 3-class ``multi:softprob``); eval logloss
  within 1e-6 of the single process's, AUC the weighted mean of the
  ranks' own; early stopping ends at the same round on both ranks; sampled
  models equal across ranks; ``distributed_boost_rounds`` grows the
  Booster's trees; training on the distributed sketch holds the merge of
  the two shards' summaries on both ranks; matrices binned on each rank's
  own rows outside ``mesh_context`` raise ValueError on both ranks;
- lossguide at world 2 (``max_leaves`` 31 and 255, ``max_depth`` 0 and 6,
  3 rounds on shared cuts) gives both ranks the single process's model
  bytes; one lossguide tree (1/64-grid gradients, 31 leaves) at world 2
  equals the port's single process bitwise, the positions in rank order,
  and JAX ``distributed_grow_tree_lossguide`` on a 2-device mesh (the
  allocation arrays and positions exactly, weights and loss changes
  within rtol 1e-6); a lossguide run on cuts of each rank's own rows
  raises ValueError on both ranks;
- every configuration outside the envelope raises NotImplementedError on
  both ranks, and a mesh-less two-process program trains DART and
  evaluates a different number of times per rank without hanging.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
F = 6
TREE_N, TREE_BIN, TREE_DEPTH = 1024, 32, 4
TRAIN_N, EVAL_N, TRAIN_CUT, EVAL_CUT = 3000, 1000, 1800, 600
PARAMS = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32,
          "eta": 0.3, "eval_metric": ["logloss", "auc"]}
PARAMS_MC = {"objective": "multi:softprob", "num_class": 3, "max_depth": 4,
             "max_bin": 32, "eta": 0.3, "eval_metric": ["mlogloss", "merror"]}
SAMPLED = {**PARAMS, "subsample": 0.8, "colsample_bytree": 0.5}
ROUNDS = 5
SKETCH_N = 2000
SKETCH_BINS = (16, 100, 128)
HEAP = ("keep", "feature", "split_bin", "split_cond", "default_left",
        "node_g", "node_h", "node_weight", "loss_chg", "leaf_value",
        "cat_set")
#: the fields a Booster keeps of a device-grown tree
PENDING = ("keep", "feature", "split_bin", "split_cond", "default_left",
           "node_weight", "loss_chg", "node_h", "leaf_value")
#: matrices binned on a rank's own rows before ``mesh_context``
CUT_MISMATCH = ("quantile", "dmatrix")
#: lossguide at world 2: (max_leaves, max_depth), rounds, the one tree's
#: leaf budget
LOSSGUIDE = [(31, 0), (31, 6), (255, 0), (255, 6)]
LG_ROUNDS, LG_TREE_LEAVES = 3, 31
#: the allocation arrays compared exactly with the JAX package's
LG_EXACT = ("left", "right", "feature", "split_bin", "split_cond", "depth",
            "node_g", "node_h", "n_nodes")
#: configurations outside the envelope: name -> (params, matrix kind)
ENVELOPE = {
    "ranking": ({"objective": "rank:ndcg"}, "grouped"),
    "survival": ({"objective": "survival:cox"}, "dense"),
    "dart": ({"booster": "dart"}, "dense"),
    "categorical": ({}, "categorical"),
    "external_memory": ({}, "paged"),
    "custom_objective": ({}, "fobj"),
    "approx": ({"tree_method": "approx"}, "dense"),
    "exact": ({"tree_method": "exact"}, "dense"),
    "local_histmaker": ({"updater": "grow_local_histmaker"}, "dense"),
    "gblinear": ({"booster": "gblinear"}, "dense"),
    "num_parallel_tree": ({"num_parallel_tree": 2}, "dense"),
    "refresh": ({"process_type": "update", "updater": "refresh"}, "dense"),
}


def _rows(n, seed, nan=0.05):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    if nan:
        X[rng.rand(n, F) < nan] = np.nan
    return X, rng


def train_data():
    X, rng = _rows(TRAIN_N + EVAL_N, 0)
    z = np.nan_to_num(X) @ rng.randn(F)
    y = ((z + 0.5 * rng.randn(len(z))) > 0).astype(np.float32)
    ymc = np.digitize(z + 0.3 * rng.randn(len(z)), [-0.5, 0.5]).astype(
        np.float32)
    return X, y, ymc


def tree_data(scale: bool):
    """Rows, continuous gradients and hessians of the one-tree cases; with
    ``scale`` the second half's gradients are 2^10 larger, so the halves'
    own quantiser scales would differ by 10 binades."""
    X, rng = _rows(TREE_N, 1)
    g = rng.randn(TREE_N).astype(np.float32)
    h = (rng.rand(TREE_N) + 0.1).astype(np.float32)
    if scale:
        g[TREE_N // 2:] *= np.float32(1024.0)
    return X, g, h


def lossguide_tree_data():
    """Rows and gradients of the one lossguide tree: g and h on a 1/64
    grid, so every float32 sum of them is exact and the JAX package's
    psum'd float histograms hold the port's values."""
    X, rng = _rows(TREE_N, 5)
    return (X, rng.randint(-128, 129, TREE_N).astype(np.float32) / 64,
            rng.randint(6, 65, TREE_N).astype(np.float32) / 64)


def sketch_data(max_bin):
    X, rng = _rows(SKETCH_N, 2 + max_bin)
    w = (rng.rand(SKETCH_N) + 0.5).astype(np.float32)
    return X, w


def shard(rank, n, cut):
    return (0, cut) if rank == 0 else (cut, n)


# ---------------------------------------------------------------------------
# the worker: one rank, every case (run as a script; imports only the port)
# ---------------------------------------------------------------------------

def _heap(t, fields=HEAP):
    return {f: getattr(t, f).cpu().numpy() for f in fields}


class _Batches:
    """A two-batch ``DataIter`` over ``X``, ``y`` (built lazily: the class
    needs the port's ``DataIter``)."""

    def __new__(cls, X, y):
        import xgboost_tpu_torch as xgbt

        class It(xgbt.DataIter):
            def __init__(self):
                super().__init__()
                self.k = 0

            def reset(self):
                self.k = 0

            def next(self, input_data):
                if self.k == 2:
                    return 0
                lo, hi = self.k * len(X) // 2, (self.k + 1) * len(X) // 2
                input_data(data=X[lo:hi], label=y[lo:hi])
                self.k += 1
                return 1

        return It()


def _envelope_case(xgbt, name, X, y, tmp):
    params, kind = ENVELOPE[name]
    params = {**PARAMS, **params}
    kw = {}
    if kind == "grouped":
        d = xgbt.DMatrix(X, y, device="cpu")
        d.set_group([len(y) // 2, len(y) - len(y) // 2])
    elif kind == "categorical":
        Xc = X.copy()
        Xc[:, 0] = np.nan_to_num(np.abs(Xc[:, 0]) * 3).astype(np.int32)
        d = xgbt.DMatrix(Xc, y, feature_types=["c"] + ["q"] * (F - 1),
                         device="cpu")
    elif kind == "paged":
        d = xgbt.ExternalMemoryQuantileDMatrix(
            _Batches(np.nan_to_num(X), y), cache_prefix=str(tmp / "c"),
            max_bin=32, page_rows=512, device="cpu")
    else:
        d = xgbt.DMatrix(X, y, device="cpu")
    if kind == "fobj":
        def fobj(m, dm):
            p = 1.0 / (1.0 + np.exp(-m))
            return p - dm.get_label(), p * (1.0 - p)
        kw["obj"] = fobj
    if name == "refresh":
        base = xgbt.train(PARAMS, d, 1, verbose_eval=False)
        kw["xgb_model"] = base
    try:
        xgbt.train(params, d, 1, verbose_eval=False, **kw)
    except NotImplementedError as e:
        return str(e)
    return None


def run_worker(rank: int, world: int, init_file: str, out: str,
               device: str = "cpu") -> None:
    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch.data.quantile import bin_matrix, compute_cuts
    from xgboost_tpu_torch.objective import create_objective
    from xgboost_tpu_torch.parallel import (distributed_boost_rounds,
                                            distributed_compute_cuts,
                                            distributed_grow_tree_fused,
                                            init_distributed, mesh_context)
    from xgboost_tpu_torch.tree.grow import GrowParams
    from xgboost_tpu_torch.tree.grow_lossguide import grow_tree_lossguide

    torch.set_num_threads(1)
    backend = "gloo"
    mesh = init_distributed(f"file://{init_file}", world, rank,
                            backend=backend, device=device)
    dev = mesh.device
    res = {"rank": rank, "world": mesh.world_size, "backend": mesh.backend}

    # -- the distributed sketch -------------------------------------------
    for max_bin in SKETCH_BINS:
        X, w = sketch_data(max_bin)
        lo, hi = shard(rank, SKETCH_N, SKETCH_N // 2)
        Xs = torch.as_tensor(X[lo:hi], device=dev)
        res[f"sketch_{max_bin}"] = distributed_compute_cuts(
            mesh, Xs, max_bin).values
        res[f"sketch_{max_bin}_w"] = distributed_compute_cuts(
            mesh, Xs, max_bin, torch.as_tensor(w[lo:hi], device=dev)).values

    # -- one tree ---------------------------------------------------------
    cfg = GrowParams(max_depth=TREE_DEPTH)
    for case, cut in (("ragged", 600), ("halves", TREE_N // 2),
                      ("scale", TREE_N // 2)):
        X, g, h = tree_data(case == "scale")
        Xt = torch.as_tensor(X, device=dev)
        cuts = compute_cuts(Xt, TREE_BIN)
        bins = bin_matrix(Xt, cuts)
        lo, hi = shard(rank, TREE_N, cut)
        t = distributed_grow_tree_fused(
            mesh, bins[lo:hi], torch.as_tensor(g[lo:hi], device=dev),
            torch.as_tensor(h[lo:hi], device=dev),
            torch.as_tensor(cuts.values, device=dev), 0.3, 0.0, cfg)
        res[f"tree_{case}"] = _heap(t)
        res[f"tree_{case}_delta"] = t.delta.cpu().numpy()

    # -- training on shared cuts -------------------------------------------
    X, y, ymc = train_data()
    Xtr, Xev = X[:TRAIN_N], X[TRAIN_N:]
    lo, hi = shard(rank, TRAIN_N, TRAIN_CUT)
    vlo, vhi = shard(rank, EVAL_N, EVAL_CUT)

    def shared(label):
        dall = xgbt.DMatrix(Xtr, label[:TRAIN_N], device=dev)
        dall.get_binned(32)
        return xgbt.QuantileDMatrix(Xtr[lo:hi], label[lo:hi], max_bin=32,
                                    ref=dall, device=dev)

    def ev(label):
        return xgbt.DMatrix(Xev[vlo:vhi], label[TRAIN_N:][vlo:vhi],
                            device=dev)

    for name, params, label in (("binary", PARAMS, y),
                                ("multiclass", PARAMS_MC, ymc),
                                ("sampled", SAMPLED, y)):
        d, dv = shared(label), ev(label)
        hist = {}
        with mesh_context(mesh):
            bst = xgbt.train(params, d, ROUNDS, evals=[(dv, "v")],
                             evals_result=hist, verbose_eval=False)
            dist_vals = bst.eval_values([(dv, "v")])["v"]
        res[name] = dict(raw=bst.save_raw(), hist=hist["v"], dist=dist_vals,
                         local=bst.eval_values([(dv, "v")])["v"],
                         eval_rows=vhi - vlo)

    # lossguide over the group, with the collective accounting of each run
    from xgboost_tpu_torch.observability import comms

    for leaves, depth in LOSSGUIDE:
        p = {**PARAMS, "grow_policy": "lossguide", "max_leaves": leaves,
             "max_depth": depth}
        d, dv = shared(y), ev(y)
        before = {by: comms.snapshot(by) for by in ("op", "site")}
        with mesh_context(mesh):
            bst = xgbt.train(p, d, LG_ROUNDS, evals=[(dv, "v")],
                             verbose_eval=False)
        res[f"lossguide_{leaves}_{depth}"] = bst.save_raw()
        for by, was in before.items():
            now = comms.snapshot(by)
            res[f"lossguide_{leaves}_{depth}_{by}"] = {
                k: {f: now[k][f] - was.get(k, {}).get(f, 0.0)
                    for f in ("ops", "bytes")} for k in now}
    Xl, g, h = lossguide_tree_data()
    Xt = torch.as_tensor(Xl, device=dev)
    cuts = compute_cuts(Xt, TREE_BIN)
    a, b = shard(rank, TREE_N, TREE_N // 2)
    t = grow_tree_lossguide(
        bin_matrix(Xt, cuts)[a:b], torch.as_tensor(g[a:b], device=dev),
        torch.as_tensor(h[a:b], device=dev),
        torch.as_tensor(cuts.values, device=dev), GrowParams(max_depth=0),
        LG_TREE_LEAVES, group=mesh)
    res["lg_tree"] = {f: getattr(t, f).cpu().numpy() for f in t._fields}

    # early stopping on held-out rows whose labels are permuted
    d, dv = shared(y), ev(y[np.random.RandomState(3).permutation(len(y))])
    with mesh_context(mesh):
        bst = xgbt.train(PARAMS, d, 30, evals=[(dv, "v")],
                         early_stopping_rounds=2, verbose_eval=False)
    res["early_stop"] = (bst.best_iteration, bst.num_boosted_rounds(),
                         bst.save_raw())

    # the per-round loop of the JAX package's scanned rounds
    d = shared(y)
    with mesh_context(mesh):
        bst = xgbt.train({k: v for k, v in PARAMS.items()
                          if k != "eval_metric"}, d, 3, verbose_eval=False)
        obj = create_objective("binary:logistic", None)
        binned = d.get_binned(32)
        _, trees = distributed_boost_rounds(
            mesh, obj, binned, d.label, None,
            torch.zeros((hi - lo, 1), device=dev), 0, 3, 0.3, 0.0,
            GrowParams(max_depth=4))
    res["boost_rounds"] = ([_heap(t, PENDING) for t in trees],
                           [_heap(e, PENDING) for e in bst._gbm.model._entries])

    # training on the distributed sketch (no shared cuts)
    d = xgbt.DMatrix(Xtr[lo:hi], y[lo:hi], device=dev)
    hist = {}
    with mesh_context(mesh):
        bst = xgbt.train(PARAMS, d, 3, evals=[(ev(y), "v")],
                         evals_result=hist, verbose_eval=False)
    res["dist_sketch"] = dict(cuts=d.get_binned(32).cuts.values,
                              raw=bst.save_raw(), auc=hist["v"]["auc"])

    # cuts from each rank's own rows, binned outside the context
    res["cut_mismatch"] = {}
    for kind in CUT_MISMATCH:
        if kind == "quantile":
            d = xgbt.QuantileDMatrix(Xtr[lo:hi], y[lo:hi], max_bin=32,
                                     device=dev)
        else:
            d = xgbt.DMatrix(Xtr[lo:hi], y[lo:hi], device=dev)
            d.get_binned(32)
        try:
            with mesh_context(mesh):
                xgbt.train({k: v for k, v in PARAMS.items()
                            if k != "eval_metric"}, d, 1, verbose_eval=False)
            res["cut_mismatch"][kind] = None
        except ValueError as e:
            res["cut_mismatch"][kind] = str(e)
    d = xgbt.DMatrix(Xtr[lo:hi], y[lo:hi], device=dev)
    d.get_binned(32)
    try:
        with mesh_context(mesh):
            xgbt.train({"grow_policy": "lossguide", "max_leaves": 8,
                        "max_bin": 32}, d, 1, verbose_eval=False)
        res["cut_mismatch_lossguide"] = None
    except ValueError as e:
        res["cut_mismatch_lossguide"] = str(e)

    # -- the envelope --------------------------------------------------------
    tmp = Path(out) / f"env{rank}"
    tmp.mkdir(exist_ok=True)
    with mesh_context(mesh):
        res["envelope"] = {name: _envelope_case(xgbt, name, Xtr[lo:hi],
                                                y[lo:hi], tmp)
                           for name in ENVELOPE}

    # -- a mesh-less program: local training, uneven evaluation ----------
    dl = xgbt.DMatrix(Xtr[lo:hi], y[lo:hi], device=dev)
    bl = xgbt.train({"objective": "binary:logistic", "booster": "dart",
                     "max_depth": 3, "eta": 0.3, "max_bin": 16,
                     "seed": rank}, dl, 3, verbose_eval=False)
    res["meshless"] = [bl.eval(dl) for _ in range(rank + 1)]
    xgbt.collective.finalize()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


#: the card test's configuration: 64k rows in ragged shards, 3 rounds at
#: the main path's parameters
CARD_ROWS, CARD_CUT, CARD_ROUNDS = 65_536, 40_000, 3
CARD_PARAMS = {"objective": "binary:logistic", "max_depth": 6,
               "max_bin": 256, "eta": 0.1, "eval_metric": ["logloss"]}


def run_card_worker(rank: int, world: int, init_file: str, out: str,
                    device: str = "cpu") -> None:
    """3 rounds over gloo at ``CARD_ROWS`` rows on ``device``: the model
    bytes and the trees' heap arrays, and a lossguide model's bytes (63
    leaves)."""
    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch.parallel import init_distributed, mesh_context

    mesh = init_distributed(f"file://{init_file}", world, rank,
                            backend="gloo", device=device)
    X, rng = _rows(CARD_ROWS, 4)
    y = ((np.nan_to_num(X) @ rng.randn(F)) > 0).astype(np.float32)
    dall = xgbt.DMatrix(X, y, device=mesh.device)
    dall.get_binned(256)
    lo, hi = shard(rank, CARD_ROWS, CARD_CUT)
    d = xgbt.QuantileDMatrix(X[lo:hi], y[lo:hi], max_bin=256, ref=dall,
                             device=mesh.device)
    with mesh_context(mesh):
        bst = xgbt.train(CARD_PARAMS, d, CARD_ROUNDS, evals=[(d, "t")],
                         verbose_eval=False)
    trees = [_heap(e, PENDING) for e in bst._gbm.model._entries]
    res = dict(trees=trees, raw=bst.save_raw())
    with mesh_context(mesh):
        bst = xgbt.train({**CARD_PARAMS, "grow_policy": "lossguide",
                          "max_leaves": 63, "max_depth": 0}, d,
                         CARD_ROUNDS, verbose_eval=False)
    res["lossguide_raw"] = bst.save_raw()
    xgbt.collective.finalize()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spawn(out: Path, world: int = 2, device: str = "cpu",
          timeout: float = 300, mode: str = "all") -> list:
    """Run ``world`` workers of ``mode`` (``"all"``: every case;
    ``"card"``: ``run_card_worker``) on this file; their results in rank
    order. A failing rank fails the caller with its output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    init = out / "pg"
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(world), str(init),
         str(out), device], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
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
def ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("dist"))


def _single(params, label, rounds=ROUNDS, **kw):
    import xgboost_tpu_torch as xgbt

    X = train_data()[0]
    d = xgbt.DMatrix(X[:TRAIN_N], label[:TRAIN_N], device="cpu")
    dv = xgbt.DMatrix(X[TRAIN_N:], label[TRAIN_N:], device="cpu")
    hist = {}
    bst = xgbt.train(params, d, rounds, evals=[(dv, "v")],
                     evals_result=hist, verbose_eval=False, **kw)
    return bst, hist["v"]


def test_world_and_backend(ranks):
    assert [(r["rank"], r["world"], r["backend"]) for r in ranks] == [
        (0, 2, "gloo"), (1, 2, "gloo")]


def _jax_cuts(X, max_bin, w=None):
    import jax.numpy as jnp
    from xgboost_tpu.parallel import (distributed_compute_cuts, make_mesh,
                                      shard_rows)

    mesh = make_mesh(2)
    ws = None if w is None else shard_rows(jnp.asarray(w), mesh)
    return distributed_compute_cuts(mesh, shard_rows(jnp.asarray(X), mesh),
                                    max_bin, ws).values


@pytest.mark.parametrize("max_bin", SKETCH_BINS)
def test_sketch_bitwise_jax_at_unit_weights(ranks, max_bin):
    X, _ = sketch_data(max_bin)
    want = _jax_cuts(X, max_bin)
    for r in ranks:
        np.testing.assert_array_equal(r[f"sketch_{max_bin}"], want)


@pytest.mark.parametrize("max_bin", SKETCH_BINS)
def test_sketch_bitwise_jax_with_weights(ranks, max_bin):
    """Row weights make the summaries' partial sums inexact in float32;
    the port's prefix sums take the association of XLA:CPU's
    ``jnp.cumsum``, so the cuts are still the JAX package's bits."""
    X, w = sketch_data(max_bin)
    want = _jax_cuts(X, max_bin, w)
    for r in ranks:
        np.testing.assert_array_equal(r[f"sketch_{max_bin}_w"], want)


def test_sketch_prefix_sum_is_xla_cpus_cumsum():
    """The witness: ``data/sketch.py:_cdf`` equals ``jnp.cumsum`` bit for
    bit on float32 rows whose partial sums are inexact, at lengths below,
    at and past one block of 16 and over several recursion levels."""
    import jax
    import jax.numpy as jnp
    from xgboost_tpu_torch.data.sketch import _cdf

    rng = np.random.RandomState(5)
    for n in (1, 15, 16, 17, 33, 1600, 4099):
        x = (rng.rand(3, n) + 0.5).astype(np.float32)
        want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
        np.testing.assert_array_equal(_cdf(torch.from_numpy(x)).numpy(),
                                      want)


def _single_tree(case):
    from xgboost_tpu_torch.data.quantile import bin_matrix, compute_cuts
    from xgboost_tpu_torch.tree.grow import GrowParams
    from xgboost_tpu_torch.tree.grow_fused import grow_tree_fused

    X, g, h = tree_data(case == "scale")
    Xt = torch.as_tensor(X)
    cuts = compute_cuts(Xt, TREE_BIN)
    return grow_tree_fused(bin_matrix(Xt, cuts), torch.as_tensor(g),
                           torch.as_tensor(h),
                           torch.as_tensor(cuts.values), 0.3, 0.0,
                           GrowParams(max_depth=TREE_DEPTH))


@pytest.mark.parametrize("case", ["ragged", "halves", "scale"])
def test_tree_bitwise_single_process(ranks, case):
    want = _single_tree(case)
    for r in ranks:
        for f, v in r[f"tree_{case}"].items():
            np.testing.assert_array_equal(v, getattr(want, f).numpy(), f)
    np.testing.assert_array_equal(
        np.concatenate([r[f"tree_{case}_delta"] for r in ranks]),
        want.delta.numpy())
    assert ranks[0][f"tree_{case}"]["keep"].sum() >= 7


@pytest.mark.parametrize("case", ["halves", "scale"])
def test_tree_matches_jax_distributed_grower(ranks, case):
    import jax
    import jax.numpy as jnp
    from xgboost_tpu.data.quantile import bin_matrix as jbin
    from xgboost_tpu.data.quantile import HistogramCuts as JCuts
    from xgboost_tpu.parallel import (distributed_grow_tree_fused,
                                      make_mesh, shard_rows)
    from xgboost_tpu.tree.grow import GrowParams

    from xgboost_tpu_torch.data.quantile import compute_cuts

    X, g, h = tree_data(case == "scale")
    cuts = compute_cuts(torch.as_tensor(X), TREE_BIN)
    bins = np.asarray(jbin(jnp.asarray(X), JCuts(cuts.values, cuts.min_vals)))
    mesh = make_mesh(2)
    jt = distributed_grow_tree_fused(
        mesh, shard_rows(jnp.asarray(bins, jnp.int32), mesh),
        shard_rows(jnp.asarray(g), mesh), shard_rows(jnp.asarray(h), mesh),
        jnp.asarray(cuts.values), jax.random.PRNGKey(0), jnp.float32(0.3),
        jnp.float32(0.0), GrowParams(max_depth=TREE_DEPTH))
    got = ranks[0][f"tree_{case}"]
    keep = got["keep"]
    np.testing.assert_array_equal(keep, np.asarray(jt.keep))
    for f in ("feature", "split_bin"):
        np.testing.assert_array_equal(got[f][keep], np.asarray(
            getattr(jt, f))[keep], f)
    for f in ("split_cond", "leaf_value", "node_g", "node_h", "loss_chg"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jt, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(
        np.concatenate([r[f"tree_{case}_delta"] for r in ranks]),
        np.asarray(jt.delta)[:TREE_N], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_train_bitwise_single_process(ranks, name):
    X, y, ymc = train_data()
    params, label = (PARAMS, y) if name == "binary" else (PARAMS_MC, ymc)
    bst, hist = _single(params, label)
    assert ranks[0][name]["raw"] == ranks[1][name]["raw"] == bst.save_raw()
    loss = "logloss" if name == "binary" else "mlogloss"
    np.testing.assert_allclose(ranks[0][name]["hist"][loss], hist[loss],
                               rtol=0, atol=1e-6 + 1e-12)


def test_eval_auc_is_the_weighted_mean_of_the_ranks(ranks):
    a = [r["binary"] for r in ranks]
    s, w = 0.0, 0.0
    for r in a:
        s += r["local"]["auc"] * r["eval_rows"]
        w += r["eval_rows"]
    assert a[0]["dist"]["auc"] == a[1]["dist"]["auc"] == s / w
    assert a[0]["local"]["auc"] != a[1]["local"]["auc"]
    _, hist = _single(PARAMS, train_data()[1])
    assert abs(a[0]["dist"]["logloss"] - hist["logloss"][-1]) <= 1e-6


def test_early_stopping_same_round_on_both_ranks(ranks):
    (b0, n0, raw0), (b1, n1, raw1) = (r["early_stop"] for r in ranks)
    assert (b0, n0) == (b1, n1) and raw0 == raw1
    assert n0 < 30


def test_sampled_models_equal_across_ranks(ranks):
    assert ranks[0]["sampled"]["raw"] == ranks[1]["sampled"]["raw"]
    bst, _ = _single(SAMPLED, train_data()[1])
    # each rank draws its row sample over its own rows (as the JAX
    # package's shards do): not the single process's sample
    assert ranks[0]["sampled"]["raw"] != bst.save_raw()


def test_boost_rounds_grow_the_boosters_trees(ranks):
    for r in ranks:
        trees, booster = r["boost_rounds"]
        assert len(trees) == len(booster) == 3
        for a, b in zip(trees, booster):
            for f in PENDING:
                np.testing.assert_array_equal(a[f], b[f], f)


def test_distributed_sketch_training(ranks):
    from xgboost_tpu_torch.data.sketch import local_summary, merge_summaries

    X = train_data()[0][:TRAIN_N]
    parts = [local_summary(torch.as_tensor(X[lo:hi]), None, 32)
             for lo, hi in ((0, TRAIN_CUT), (TRAIN_CUT, TRAIN_N))]
    cuts, _ = merge_summaries(*[torch.stack(p) for p in zip(*parts)], 32)
    for r in ranks:
        np.testing.assert_array_equal(r["dist_sketch"]["cuts"], cuts.numpy())
    assert ranks[0]["dist_sketch"]["raw"] == ranks[1]["dist_sketch"]["raw"]
    auc = ranks[0]["dist_sketch"]["auc"]
    assert auc[-1] > auc[0]


@pytest.mark.parametrize("kind", CUT_MISMATCH)
def test_ranks_binned_on_their_own_cuts_raise(ranks, kind):
    """A matrix sketched on its own rank's rows outside ``mesh_context``
    (a ``QuantileDMatrix`` without ``ref``, a ``DMatrix`` binned early)
    bins each rank against other cuts; the first round raises ValueError
    on both ranks, naming the fix, instead of summing histograms whose
    bins mean different values."""
    for r in ranks:
        msg = r["cut_mismatch"][kind]
        assert msg is not None and "different cuts" in msg
        assert "mesh_context" in msg and "ref=" in msg


@pytest.mark.parametrize("leaves,depth", LOSSGUIDE)
def test_lossguide_bitwise_single_process(ranks, leaves, depth):
    """Lossguide over the group: every step's int64 child histograms
    all-reduced, the same queue on both ranks, the single process's model
    bytes on both."""
    p = {**PARAMS, "grow_policy": "lossguide", "max_leaves": leaves,
         "max_depth": depth}
    bst, _ = _single(p, train_data()[1], rounds=LG_ROUNDS)
    raw = bst.save_raw()
    assert ranks[0][f"lossguide_{leaves}_{depth}"] == raw
    assert ranks[1][f"lossguide_{leaves}_{depth}"] == raw
    trees = json.loads(raw)["learner"]["gradient_booster"]["model"]["trees"]
    n_leaves = [(len(t["left_children"]) + 1) // 2 for t in trees]
    assert max(n_leaves) <= leaves and max(n_leaves) > min(leaves, 31) // 2
    if depth:
        assert all(max(_depths(t)) <= depth for t in trees)


@pytest.mark.parametrize("leaves", [31, 255])
def test_lossguide_collectives_are_accounted(ranks, leaves):
    """``observability.comms`` counts, per site, the scale, the root
    totals and every step's int64 child histograms of each tree: the
    root's ``[F, 2, B]`` and one ``[F, 4 K_EXP, B]`` a step, 8 bytes a
    cell; per kind, the same under ``pmax`` / ``psum_hist``, and the host
    gathers under ``process_allgather``."""
    from xgboost_tpu_torch.tree.grow_lossguide import (expansions_per_step,
                                                       lossguide_steps)

    steps, cell = lossguide_steps(leaves), F * 32 * 8
    hist = 2 * cell + steps * 4 * expansions_per_step(leaves) * cell
    for r in ranks:
        site = r[f"lossguide_{leaves}_0_site"]
        assert site["grad_scale"] == {"ops": LG_ROUNDS, "bytes": 8 * LG_ROUNDS}
        assert site["root_totals"] == {"ops": LG_ROUNDS,
                                       "bytes": 16 * LG_ROUNDS}
        assert site["lossguide_hist"] == {"ops": LG_ROUNDS * (1 + steps),
                                          "bytes": LG_ROUNDS * hist}
        kind = r[f"lossguide_{leaves}_0_op"]
        assert kind["pmax"] == site["grad_scale"]
        assert kind["psum_hist"] == {
            "ops": LG_ROUNDS * (2 + steps),
            "bytes": LG_ROUNDS * (16 + hist)}
        assert kind["process_allgather"]["ops"] > 0


def _depths(tree):
    depth = [0] * len(tree["left_children"])
    for i, (lc, rc) in enumerate(zip(tree["left_children"],
                                     tree["right_children"])):
        if lc >= 0:
            depth[lc] = depth[rc] = depth[i] + 1
    return depth


def test_lossguide_tree_bitwise_single_process(ranks):
    from xgboost_tpu_torch.data.quantile import bin_matrix, compute_cuts
    from xgboost_tpu_torch.tree.grow import GrowParams
    from xgboost_tpu_torch.tree.grow_lossguide import grow_tree_lossguide

    X, g, h = lossguide_tree_data()
    Xt = torch.as_tensor(X)
    cuts = compute_cuts(Xt, TREE_BIN)
    want = grow_tree_lossguide(bin_matrix(Xt, cuts), torch.as_tensor(g),
                               torch.as_tensor(h),
                               torch.as_tensor(cuts.values),
                               GrowParams(max_depth=0), LG_TREE_LEAVES)
    for r in ranks:
        for f, v in r["lg_tree"].items():
            if f != "positions":
                np.testing.assert_array_equal(v, getattr(want, f).numpy(), f)
    np.testing.assert_array_equal(
        np.concatenate([r["lg_tree"]["positions"] for r in ranks]),
        want.positions.numpy())
    assert int(want.n_nodes) == 2 * LG_TREE_LEAVES - 1


def test_lossguide_tree_matches_jax_distributed_grower(ranks):
    import jax
    import jax.numpy as jnp
    from xgboost_tpu.data.quantile import bin_matrix as jbin
    from xgboost_tpu.data.quantile import HistogramCuts as JCuts
    from xgboost_tpu.parallel import (distributed_grow_tree_lossguide,
                                      make_mesh, shard_rows)
    from xgboost_tpu.tree.grow import GrowParams

    from xgboost_tpu_torch.data.quantile import compute_cuts

    X, g, h = lossguide_tree_data()
    cuts = compute_cuts(torch.as_tensor(X), TREE_BIN)
    bins = np.asarray(jbin(jnp.asarray(X), JCuts(cuts.values, cuts.min_vals)))
    mesh = make_mesh(2)
    jt = distributed_grow_tree_lossguide(
        mesh, shard_rows(jnp.asarray(bins, jnp.int32), mesh),
        shard_rows(jnp.asarray(g), mesh), shard_rows(jnp.asarray(h), mesh),
        jnp.asarray(cuts.values), jax.random.PRNGKey(0),
        GrowParams(max_depth=0), LG_TREE_LEAVES)
    got = ranks[0]["lg_tree"]
    for f in LG_EXACT:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jt, f)), f)
    for f in ("node_weight", "loss_chg"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jt, f)),
                                   rtol=1e-6, err_msg=f)
    positions = np.asarray(jt.positions)[:TREE_N]
    np.testing.assert_array_equal(
        np.concatenate([r["lg_tree"]["positions"] for r in ranks]),
        positions)
    # default_left where a row with a missing split value reached the node
    # (elsewhere both directions score the same: a tie)
    left, right = got["left"], got["right"]
    parent = np.full(left.shape[0], -1)
    for i in np.flatnonzero(left >= 0):
        parent[left[i]] = parent[right[i]] = i
    seen = np.zeros(left.shape[0], bool)
    for r, leaf in enumerate(positions):
        i = parent[leaf]
        while i >= 0:
            seen[i] |= bins[r, got["feature"][i]] == TREE_BIN
            i = parent[i]
    assert seen.any()
    np.testing.assert_array_equal(got["default_left"][seen],
                                  np.asarray(jt.default_left)[seen])


def test_lossguide_on_each_ranks_own_cuts_raises(ranks):
    for r in ranks:
        msg = r["cut_mismatch_lossguide"]
        assert msg is not None and "different cuts" in msg


@pytest.mark.parametrize("name", sorted(ENVELOPE))
def test_outside_the_envelope_raises_on_every_rank(ranks, name):
    msgs = [r["envelope"][name] for r in ranks]
    assert msgs[0] is not None and msgs[0] == msgs[1], msgs


def test_meshless_program_trains_and_evaluates_locally(ranks):
    assert [len(r["meshless"]) for r in ranks] == [1, 2]
    for r in ranks:
        assert all("logloss" in e for e in r["meshless"])


if __name__ == "__main__":
    worker = run_card_worker if sys.argv[1] == "card" else run_worker
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
           *sys.argv[6:])
