"""Where one boosting round of the PyTorch/CUDA port spends its time.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_round_profile.py [NAME ...]

(with names, only the configurations whose name holds one of them, e.g.
``lossguide dart``). For each of ``chip_smoke.py``'s training
configurations (``PARAMS``, max_bin 64, and ``PARAMS_DEFAULT``, max_bin
left at 256, on ``bench.py``'s generator; ``BREADTH_A``, the same with uniform row and column sampling
per tree, level and node; ``PARAMS_DEFAULT`` on the categorical data of
``_make_cat_data`` with its ``feature_types``; ``PARAMS_MC``, 7-class
``multi:softprob`` on the generator's rows with ``_multiclass_labels``,
7 trees per round; ``RANK_PARAMS``, ``rank:ndcg`` on the MSLR-WEB10K-shaped
rows of ``_make_rank_data``, 1M x 136 in queries of 60-180 documents, the
sampled-pair gradient; ``DART_PARAMS``, DART at its tutorial's
parameters, whose round walks the whole forest for its training margin;
``APPROX_PARAMS``, ``tree_method="approx"``, which sketches a matrix
and builds its one-hot every round),
each by the hoisted route (the default plan) and by the construct route
(``XGBTPU_HOIST_BUDGET_MB=0``), and once each: ``LG_PARAMS`` (lossguide
to 255 leaves, every step's child histograms through kernel A whatever
the plan); ``EXACT_PARAMS``, ``tree_method="exact"`` on the
Covertype-shaped rows of ``_make_covtype`` (581,012 training rows, B =
7,175, hoist plan 0) with 58,101 held out; ``LOCAL_PARAMS``, the local
histmaker (kernel A at ``d = 0`` every level); and a refresh
(``process_type="update"``) of a 10-round ``PARAMS_DEFAULT`` model, at its shape
(``ROWS`` x ``COLS`` training rows and ``EVAL_ROWS`` held-out rows): trains ``WARMUP`` rounds, times the next
``TIMED_ROUNDS`` rounds (``Booster.update`` + ``eval_values``) on the host
clock without the profiler, then profiles one more round with
``torch.profiler`` (CPU and CUDA activities). Prints the unprofiled and
profiled round times, the device's busy time in the profiled round (sum of
kernel and memcpy/memset self time; one stream, so they do not overlap),
the idle share against the median unprofiled round (the profiler inflates
the host's time, not the device's), the number of device operations, and
the top device operations by time, the top host events (torch operators
and CUDA runtime calls) by self time, and the host time of each level-kernel
wrapper call (``_fused_level_cuda`` for kernel A, ``_hoisted_level_cuda``
for kernel D, no synchronisation inside) over the unprofiled rounds, one
JSON report per configuration.
Fails if the profiler saw no device time.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import xgboost_tpu_torch as xgbt  # noqa: E402
from xgboost_tpu_torch.tree import hist_kernel as hk  # noqa: E402
from chip_smoke import (APPROX_PARAMS, BREADTH_A, COLS,  # noqa: E402
                        COVTYPE_ROWS, DART_PARAMS, EVAL_ROWS, EXACT_PARAMS,
                        LG_PARAMS, LOCAL_PARAMS, PARAMS, PARAMS_DEFAULT,
                        PARAMS_MC, RANK_EVAL_ROWS, RANK_PARAMS, RANK_ROWS,
                        ROUNDS, ROWS, _make_cat_data, _make_covtype,
                        _make_data, _make_rank_data, _multiclass_labels,
                        _split_queries)

WARMUP = 3
TIMED_ROUNDS = 5
TOP = 12


def _round(bst, dtrain, evals, it):
    bst.update(dtrain, it)
    vals = bst.eval_values(evals, it)
    torch.cuda.synchronize()
    return vals


def _host_timed(fn, record):
    """``fn`` with the host time of each call appended to ``record``."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        record.append((time.perf_counter() - t0) * 1e3)
        return out
    return timed


def profile(name, params, X, y, types=None, groups=None, split=ROWS,
            base=None) -> int:
    """``groups``: the query sizes of the training and the held-out rows
    (which then split at the training queries' row count), else the rows
    split at ``split``. ``base``: the parameters of a ``ROUNDS``-round
    model that ``params`` continue (a refresh's model)."""
    split = split if groups is None else int(groups[0].sum())
    gtr, gte = (None, None) if groups is None else groups
    dtrain = xgbt.DMatrix(X[:split], y[:split], feature_types=types,
                          group=gtr)
    dtest = xgbt.DMatrix(X[split:], y[split:], feature_types=types,
                         group=gte)
    evals = [(dtest, "test")]
    model = (None if base is None else
             xgbt.train(base, dtrain, ROUNDS, verbose_eval=False))
    bst = xgbt.train(params, dtrain, WARMUP, evals=evals, verbose_eval=False,
                     xgb_model=model)
    torch.cuda.synchronize()
    it = WARMUP
    plain_ms = []
    wrapper_ms = {"_fused_level_cuda": [], "_hoisted_level_cuda": []}
    originals = {k: getattr(hk, k) for k in wrapper_ms}
    try:
        for k, rec in wrapper_ms.items():
            setattr(hk, k, _host_timed(originals[k], rec))
        for _ in range(TIMED_ROUNDS):
            t0 = time.perf_counter()
            _round(bst, dtrain, evals, it)
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            it += 1
    finally:
        for k, fn in originals.items():
            setattr(hk, k, fn)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        vals = _round(bst, dtrain, evals, it)
        profiled_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        print("profiler recorded no device time", file=sys.stderr)
        return 1
    ops = sum(e.count for e in dev)
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    round_ms = statistics.median(plain_ms)
    report = {
        "config": name, "card": smi, "rows": split, "profiled_round": it,
        "unprofiled_round_ms": plain_ms, "median_round_ms": round_ms,
        "profiled_round_ms": profiled_ms, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / round_ms,
        "device_ops": ops, "eval": vals,
        "wrapper_host_ms": {k: {"calls": len(v),
                                "median": statistics.median(v) if v else None,
                                "max": max(v) if v else None}
                            for k, v in wrapper_ms.items()},
        "top": [{"name": e.key[:90], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in top[:TOP]],
        "top_host": [{"name": e.key[:90], "count": e.count,
                      "host_ms": e.self_cpu_time_total / 1e3}
                     for e in host[:TOP]],
    }
    print(json.dumps(report, indent=1))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    X, y, _ = _make_data(ROWS + EVAL_ROWS, COLS, 0.0, seed=42)

    def rank():
        Xr, yr, sizes = _make_rank_data(RANK_ROWS + RANK_EVAL_ROWS, 60, 180)
        (_, _, gtr), (_, _, gte) = _split_queries(Xr, yr, sizes, RANK_ROWS)
        return Xr, yr, None, (gtr, gte)

    both = (("hoisted", None), ("construct", "0"))
    configs = [(name, params, data, both) for name, params, data in (
            ("max_bin 64", PARAMS, lambda: (X, y)),
            ("max_bin 256 (default)", PARAMS_DEFAULT, lambda: (X, y)),
            ("max_bin 256, sampled (a)", BREADTH_A, lambda: (X, y)),
            ("categorical, max_bin 256", PARAMS_DEFAULT,
             lambda: _make_cat_data(ROWS + EVAL_ROWS, COLS, seed=42)),
            ("7 classes, max_bin 256", PARAMS_MC,
             lambda: (X, _multiclass_labels(X))),
            ("rank:ndcg 1M x 136, max_bin 256", RANK_PARAMS, rank),
            ("dart, max_bin 256", DART_PARAMS, lambda: (X, y)),
            ("approx, max_bin 256", APPROX_PARAMS, lambda: (X, y)))]
    once = (("kernel A", None),)
    covtype = COVTYPE_ROWS + COVTYPE_ROWS // 10
    refresh = {**PARAMS_DEFAULT, "process_type": "update"}
    configs += [
        ("lossguide 255 leaves, max_bin 256", LG_PARAMS, lambda: (X, y),
         once),
        ("exact, Covertype-shaped 581,012 x 54", EXACT_PARAMS,
         lambda: (*_make_covtype(covtype), None, None, COVTYPE_ROWS), once),
        ("local histmaker, max_bin 256", LOCAL_PARAMS, lambda: (X, y), once),
        ("refresh (process_type update), max_bin 256", refresh,
         lambda: (X, y, None, None, ROWS, PARAMS_DEFAULT),
         (("walks only", None),))]
    wanted = sys.argv[1:]
    for name, params, make_data, routes in configs:
        if wanted and not any(w in name for w in wanted):
            continue
        data = make_data()
        for route, budget in routes:
            if budget is not None:
                os.environ["XGBTPU_HOIST_BUDGET_MB"] = budget
            try:
                rc = profile(f"{name}, {route} route", params, *data)
            finally:
                os.environ.pop("XGBTPU_HOIST_BUDGET_MB", None)
            torch.cuda.empty_cache()  # the configuration's one-hot goes first
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
