"""Where one boosting round of the PyTorch/CUDA port spends its time.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_round_profile.py

Trains the main path of ``chip_smoke.py`` at its shape (the same ``PARAMS``,
``ROWS`` x ``COLS`` training rows and ``EVAL_ROWS`` held-out rows from
``bench.py``'s generator) for ``WARMUP`` rounds, times the next
``TIMED_ROUNDS`` rounds (``Booster.update`` + ``eval_values``) on the host
clock without the profiler, then profiles one more round with
``torch.profiler`` (CPU and CUDA activities). Prints the unprofiled and
profiled round times, the device's busy time in the profiled round (sum of
kernel and memcpy/memset self time; one stream, so they do not overlap),
the idle share against the median unprofiled round (the profiler inflates
the host's time, not the device's), the number of device operations, and
the top device operations by time. Fails if the profiler saw no device
time.
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
from chip_smoke import COLS, EVAL_ROWS, PARAMS, ROWS, _make_data  # noqa: E402

WARMUP = 3
TIMED_ROUNDS = 5
TOP = 12


def _round(bst, dtrain, evals, it):
    bst.update(dtrain, it)
    vals = bst.eval_values(evals, it)
    torch.cuda.synchronize()
    return vals


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    X, y = _make_data(ROWS + EVAL_ROWS, COLS, 0.0, seed=42)
    dtrain = xgbt.DMatrix(X[:ROWS], y[:ROWS])
    dtest = xgbt.DMatrix(X[ROWS:], y[ROWS:])
    evals = [(dtest, "test")]
    bst = xgbt.train(PARAMS, dtrain, WARMUP, evals=evals, verbose_eval=False)
    torch.cuda.synchronize()
    it = WARMUP
    plain_ms = []
    for _ in range(TIMED_ROUNDS):
        t0 = time.perf_counter()
        _round(bst, dtrain, evals, it)
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        it += 1
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    round_ms = statistics.median(plain_ms)
    report = {
        "card": smi, "rows": ROWS, "profiled_round": it,
        "unprofiled_round_ms": plain_ms, "median_round_ms": round_ms,
        "profiled_round_ms": profiled_ms, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / round_ms,
        "device_ops": ops, "eval": vals,
        "top": [{"name": e.key[:90], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in top[:TOP]],
    }
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
