"""On-card smoke test of the PyTorch/CUDA port (``xgboost_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build both hand-written kernels from ``xgboost_tpu_torch/csrc/`` with
   ``nvcc`` for ``sm_90a``;
2. kernel A (``fused_level``) against its plain PyTorch version at the main
   path's shape (1M x 50 dense rows, max_bin 64, real logistic gradients,
   the decision tables of a real grown tree) at every level d = 0..5:
   ``pos`` equal and ``hist`` bitwise equal, and two launches identical;
3. kernel B (``predict_margin``) against its plain version on a forest of
   10 depth-6 trees and 100k rows with 5% NaNs: allclose 1e-5;
4. the main path through the public entry points: ``train`` binary:logistic
   with the depthwise hist grower (max_depth 6, max_bin 64, eta 0.1) for 10
   rounds on 1M x 50 with AUC/logloss eval on 100k held-out rows, then
   ``predict``; kernel A must launch exactly 10 x 6 times, kernel B at least
   10 times, and the held-out AUC must reach 0.80 and rise over round 1;
5. the same model for 3 rounds on 64k rows on the card and on the CPU (the
   plain versions): identical trees, predictions within 1e-5;
6. each kernel timed with CUDA events (median of >= 20 launches after
   warm-up) beside its plain version, its bound and a PyTorch library call.

The data generator is ``bench.py:_make_data``, copied. The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit; before that, one JSON line lists the kernels.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch import _build
from xgboost_tpu_torch.objective import create_objective
from xgboost_tpu_torch.predictor import (_predict_margin_plain,
                                         forest_from_numpy, predict_margin)
from xgboost_tpu_torch.tree import hist_kernel as hk
from xgboost_tpu_torch.tree.grow import GrowParams
from xgboost_tpu_torch.tree.grow_fused import _init_state, _level_update
from xgboost_tpu_torch.tree.param import SplitParams

DEVICE = torch.device("cuda")
ROWS, COLS, EVAL_ROWS, MAX_BIN, DEPTH, ROUNDS = 1_000_000, 50, 100_000, 64, 6, 10
CPU_ROWS, CPU_ROUNDS = 65_536, 3
TIMING_REPS = 20
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor 32-bit op/s
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
PARAMS = {"objective": "binary:logistic", "tree_method": "tpu_hist",
          "max_depth": DEPTH, "max_bin": MAX_BIN, "eta": 0.1,
          "eval_metric": ["auc", "logloss"]}


def _make_data(rows: int, cols: int, sparsity: float, seed: int = 42):
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, cols).astype(np.float32)
    if sparsity > 0:
        X[rng.rand(rows, cols) < sparsity] = np.nan
    w = rng.randn(cols).astype(np.float32)
    logits = np.nan_to_num(X) @ w * 0.5
    y = (logits + rng.randn(rows).astype(np.float32) > 0).astype(np.float32)
    return X, y


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, nops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(_build.SOURCES)}")
    for name, rec in sorted(_build.build_log.items()):
        lines = [ln for ln in rec["log"].splitlines()
                 if "registers" in ln or "smem" in ln or "bytes stack" in ln]
        for ln in lines:
            print(f"  ptxas[{name}]: {ln.strip()}")


def phase_level_kernel(Xtr, ytr):
    """Kernel A against its plain version at every level of a real tree."""
    dev = DEVICE
    d = xgbt.DMatrix(Xtr, ytr)
    binned = d.get_binned(MAX_BIN)
    bins, cuts = binned.bins, binned.cut_values
    n, F = bins.shape
    B = MAX_BIN
    obj = create_objective("binary:logistic")
    grad, hess = obj.get_gradient(torch.zeros(n, device=dev), d.label, None)
    gq = hk.quantize_gradients(grad, hess)
    cfg = GrowParams(max_depth=DEPTH, split=SplitParams())
    st = _init_state(cfg, gq.totals())
    pos = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    levels, max_err = [], 0.0
    for lvl in range(DEPTH):
        K, Kp = 1 << lvl, (1 << lvl) >> 1
        kw = dict(K=K, Kp=Kp, B=B, d=lvl)
        pk, hq = hk._fused_level_cuda(bins, pos, gq, st.ptab, **kw)
        pk2, hq2 = hk._fused_level_cuda(bins, pos, gq, st.ptab, **kw)
        pp, hp = hk._fused_level_plain(bins, pos, gq, st.ptab, **kw)
        torch.cuda.synchronize()
        check(torch.equal(pk, pp), f"level {lvl}: pos kernel == plain")
        check(torch.equal(hq, hp), f"level {lvl}: hist kernel == plain (int64)")
        check(torch.equal(pk, pk2) and torch.equal(hq, hq2),
              f"level {lvl}: two launches give the same bits")
        lane = (torch.arange(2 * K, device=dev) >= K).long()[None, :, None]
        hist = gq.dequantize(hq, lane)
        err = float((hist - gq.dequantize(hp, lane)).abs().max())
        check(err == 0.0, f"level {lvl}: f32 hist bitwise equal")
        max_err = max(max_err, err)

        ms = time_ms(lambda: hk.fused_level(bins, pos, gq, st.ptab, **kw))
        plain_ms = time_ms(lambda: gq.dequantize(
            hk._fused_level_plain(bins, pos, gq, st.ptab, **kw)[1], lane))
        # library yardstick: one index_add_ of float g/h into the flat
        # [F*2K*B] histogram at this level's (row, feature) cells
        local = pk[:, 0].long() - ((1 << lvl) - 1)
        b = bins.long()
        keep = ((local >= 0) & (local < K))[:, None] & (b < B)
        cell = ((torch.arange(F, device=dev)[None, :] * 2 * K
                 + local[:, None]) * B + b)[keep]
        rows = torch.nonzero(keep)[:, 0]
        idx = torch.cat([cell, cell + K * B])
        vals = torch.cat([grad[rows], hess[rows]])
        flat = torch.zeros(F * 2 * K * B, dtype=torch.float32, device=dev)
        lib_ms = time_ms(lambda: flat.index_add_(0, idx, vals))
        del local, b, keep, cell, rows, idx, vals
        nbytes = n * F + n * 4 + n * 8 + Kp * 16 + n * 4 + F * 2 * K * B * 4
        bnd, by = bound_ms(nbytes, 2 * n * F)
        levels.append(dict(level=lvl, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bnd, bound_by=by))
        print(f"kernel A level {lvl} (K={K}): {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  index_add_ {lib_ms:.4f} ms  bound "
              f"{bnd:.4f} ms ({by})  bitwise equal")
        st = _level_update(st, hist, cuts, cfg, lvl)
        pos = pk
    mean = lambda k: sum(x[k] for x in levels) / len(levels)  # noqa: E731
    return dict(ms=mean("ms"), plain_ms=mean("plain_ms"),
                library_ms=mean("library_ms"), bound_ms=mean("bound_ms"),
                bound_by=levels[0]["bound_by"], max_abs_err=max_err,
                levels=levels)


def _random_forest(rng, T, depth, F):
    N = (1 << (depth + 1)) - 1
    internal = (1 << depth) - 1
    idx = np.arange(N)
    left = np.where(idx < internal, 2 * idx + 1, -1)
    right = np.where(idx < internal, 2 * idx + 2, -1)
    left, right = np.tile(left, (T, 1)), np.tile(right, (T, 1))
    feature = rng.randint(0, F, size=(T, N))
    cond = np.where(left >= 0, rng.randn(T, N) * 0.7,
                    rng.randn(T, N) * 0.1).astype(np.float32)
    default_left = rng.rand(T, N) < 0.5
    return forest_from_numpy(left, right, feature, cond, default_left,
                             np.zeros(T), depth, 1, device=DEVICE,
                             heap_layout=True)


def phase_walk_kernel():
    """Kernel B against its plain version: 10 depth-6 trees, 100k rows."""
    rng = np.random.RandomState(3)
    forest = _random_forest(rng, 10, DEPTH, COLS)
    Xe, _ = _make_data(EVAL_ROWS, COLS, 0.05, seed=7)
    X = torch.as_tensor(Xe, device=DEVICE)
    base = torch.zeros((EVAL_ROWS, 1), device=DEVICE)
    tw = torch.ones(10, device=DEVICE)
    got = predict_margin(forest, X, base)
    want = _predict_margin_plain(forest, X, base, tw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"walk kernel == plain (max abs err {err})")
    ms = time_ms(lambda: predict_margin(forest, X, base))
    plain_ms = time_ms(lambda: _predict_margin_plain(forest, X, base, tw))
    T, N = forest.left.shape
    nbytes = X.numel() * 4 + 2 * EVAL_ROWS * 4 + T * N * 17 + T * 8
    bnd, by = bound_ms(nbytes, EVAL_ROWS * T * DEPTH * 2)
    print(f"kernel B (T={T}, depth {DEPTH}, {EVAL_ROWS} rows): {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  bound {bnd:.4f} ms ({by})  "
          f"max abs err {err}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bnd,
                bound_by=by, max_abs_err=err)


def phase_main_path(Xtr, ytr, Xte, yte):
    """train() + predict() through the public entry points."""
    hk.fused_level.launches = 0
    predict_margin.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dtrain = xgbt.DMatrix(Xtr, ytr)
    dtest = xgbt.DMatrix(Xte, yte)
    dtrain.get_binned(MAX_BIN)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    res = {}
    t0 = time.perf_counter()
    bst = xgbt.train(PARAMS, dtrain, ROUNDS, evals=[(dtest, "test")],
                     evals_result=res, verbose_eval=True)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    preds = bst.predict(xgbt.DMatrix(Xte))
    t_pred = time.perf_counter() - t0
    launches = (hk.fused_level.launches, predict_margin.launches)
    auc = res["test"]["auc"]
    print(f"main path: ingest {t_ingest:.3f} s, train {ROUNDS} rounds "
          f"{t_train:.3f} s ({t_train / ROUNDS * 1e3:.1f} ms/round incl. "
          f"eval), predict {t_pred:.3f} s; launches A={launches[0]} "
          f"B={launches[1]}; auc {auc[0]:.6f} -> {auc[-1]:.6f}")
    check(launches[0] == ROUNDS * DEPTH,
          f"kernel A launched {launches[0]} times, want {ROUNDS * DEPTH}")
    check(launches[1] >= ROUNDS, f"kernel B launched {launches[1]} times")
    check(auc[-1] >= 0.80 and auc[-1] > auc[0], f"held-out AUC {auc}")
    check(preds.shape == (EVAL_ROWS,) and np.isfinite(preds).all(),
          "predictions finite, one per row")
    cached = bst.predict(dtest)  # the eval set's incrementally cached margin
    check(np.allclose(preds, cached, rtol=1e-5, atol=1e-6),
          "fresh predict == cached eval margins")
    return launches, dict(auc=auc, logloss=res["test"]["logloss"],
                          train_s=t_train, ingest_s=t_ingest, predict_s=t_pred)


def phase_card_vs_cpu(Xtr, ytr, Xte):
    """3 rounds on the card and on the CPU: same trees, same predictions."""
    X, y = Xtr[:CPU_ROWS], ytr[:CPU_ROWS]
    out = []
    for dev in (DEVICE, torch.device("cpu")):
        bst = xgbt.train(PARAMS, xgbt.DMatrix(X, y, device=dev), CPU_ROUNDS,
                         verbose_eval=False)
        heap = [{f: getattr(e, f).cpu().numpy() for f in
                 ("keep", "feature", "split_bin", "default_left")}
                for e in bst._gbm.model._entries]
        out.append((heap, bst.predict(xgbt.DMatrix(Xte[:10000], device=dev))))
    (card_trees, card_pred), (cpu_trees, cpu_pred) = out
    check(len(card_trees) == len(cpu_trees) == CPU_ROUNDS, "tree counts")
    for t, (a, b) in enumerate(zip(card_trees, cpu_trees)):
        for f in a:
            check(np.array_equal(a[f], b[f]), f"tree {t} {f}: card == CPU")
    err = float(np.abs(card_pred - cpu_pred).max())
    check(err <= 1e-5, f"card vs CPU predictions max abs err {err}")
    print(f"card vs CPU: {CPU_ROUNDS} trees identical, predictions max abs "
          f"err {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    phase_build()
    X, y = _make_data(ROWS + EVAL_ROWS, COLS, 0.0, seed=42)
    Xtr, ytr, Xte, yte = X[:ROWS], y[:ROWS], X[ROWS:], y[ROWS:]
    a = phase_level_kernel(Xtr, ytr)
    b = phase_walk_kernel()
    launches, metrics = phase_main_path(Xtr, ytr, Xte, yte)
    phase_card_vs_cpu(Xtr, ytr, Xte)
    print(json.dumps({"kernel_A_levels": a.pop("levels"), "main_path": metrics}))
    kernels = [
        dict(name="fused_level", route="cuda",
             source="xgboost_tpu_torch/csrc/hist_level.cu",
             # the construct kernel and the hoisted pair it stands in for
             replaces="xgboost_tpu/tree/hist_kernel.py:560, "
                      "xgboost_tpu/tree/hist_kernel.py:645, "
                      "xgboost_tpu/tree/hist_kernel.py:378",
             launches=launches[0], **a),
        dict(name="predict_margin", route="cuda",
             source="xgboost_tpu_torch/csrc/predict_walk.cu",
             replaces="xgboost_tpu/predictor/__init__.py:299",
             launches=launches[1], **b),
    ]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
