"""The median round of ``train()`` on the main path, for a checkout of the
PyTorch/CUDA port: ``chip_smoke.py``'s reference-default run (1M x 50 from
``_make_data``, max_bin 256, depth 6, eta 0.1, AUC and logloss on 100k
held-out rows), 12 rounds, no checkpoints. It is the number the
resilience layer must leave where it was (on this path it adds a chaos
site with no plan and a watchdog with no deadline), so run it for two
checkouts in turns in one call:

    python3 scripts/torch_train_rounds.py [--root PATH] [--runs N]

``--root`` is the checkout whose ``xgboost_tpu_torch`` and
``chip_smoke.py`` are imported (default: this one). Each of ``--runs``
(3) fresh trainings times every round from one ``before_iteration`` to the
next (the last round to ``train``'s return), each boundary after a device
synchronize, and reports the median of rounds 1-11 (round 0 builds the
one-hot). Prints one JSON line with the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import xgboost_tpu_torch as xgbt
    from chip_smoke import (COLS, DEPTH, EVAL_ROWS, PARAMS_DEFAULT, ROWS,
                            _make_data)

    class Clock(xgbt.callback.TrainingCallback):
        def __init__(self):
            self.marks = []

        def before_iteration(self, model, epoch, evals_log):
            torch.cuda.synchronize()
            self.marks.append(time.perf_counter())
            return False

    X, y, _ = _make_data(ROWS + EVAL_ROWS, COLS, 0.0, seed=42)
    params = {**PARAMS_DEFAULT, "max_depth": DEPTH}
    medians = []
    for _ in range(args.runs):
        d = xgbt.DMatrix(X[:ROWS], y[:ROWS])
        dv = xgbt.DMatrix(X[ROWS:], y[ROWS:])
        clock = Clock()
        xgbt.train(params, d, 12, evals=[(dv, "eval")], verbose_eval=False,
                   callbacks=[clock])
        torch.cuda.synchronize()
        marks = clock.marks + [time.perf_counter()]
        rounds = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        medians.append(statistics.median(rounds[1:]))
        del d, dv
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": args.root, "card": smi,
                      "median_round_ms": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
