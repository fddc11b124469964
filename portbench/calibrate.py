"""Readings from which a cell's limits are set, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 2
        [--fault <name>] [--control-seeds 4,5,6 --control-rounds 6]
        [--out <file.jsonl>] [--overrides '<json>'] [--device cuda|cpu]

For each of ``--seeds`` it makes one run of the cell as ``run.py`` does
(a ``--seconds`` window; with ``--fault``, one of ``faults.FAULTS``
planted in the program) and prints its checks; for each of
``--control-seeds`` it runs the control (``control.py``) for
``--control-rounds`` rounds at the cell's sizes and prints the judge's
numbers of it. The last lines give, for each number, the largest reading
of the runs and the smallest of the control. Each reading is also
appended to ``--out`` as a JSON line.
"""

import argparse
import gc
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-rounds", type=int, default=6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import contextlib

    import torch

    from portbench import control, faults, harness, judge, traffic

    overrides = json.loads(args.overrides)
    rows = {"run": [], "control": []}

    def emit(kind, seed, checks, extra=None):
        rec = {"kind": kind, "workload": args.workload, "seed": seed,
               "fault": args.fault, "checks": checks, **(extra or {})}
        if args.device == "cuda":
            rec["card"] = torch.cuda.get_device_name(0)
        rows[kind].append(checks)
        print(json.dumps(rec), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    for s in filter(None, args.seeds.split(",")):
        seed = int(s)
        plant = (faults.FAULTS[args.fault]() if args.fault
                 else contextlib.nullcontext())
        try:
            with plant:
                r = harness.run_cell(args.workload, seed, args.seconds, False,
                                     args.device, overrides)
            emit("run", seed, {k: v["value"] for k, v in r["checks"].items()},
                 {"correct": r["correct"], "rounds": r["attempted"]})
        except Exception:
            traceback.print_exc()
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()

    c = harness.cell(args.workload)
    c["traffic"].update(overrides)
    params = harness.params_of(c)
    limits = c["traffic"]["limits"]
    for s in filter(None, args.control_seeds.split(",")):
        seed = int(s)
        t0 = time.perf_counter()
        data = traffic.make(c["config"], c["traffic"], seed, args.device)
        out = control.outputs(data, params, args.control_rounds, args.device)
        checks = judge.compare(out, data, params, args.control_rounds, seed,
                               args.device)
        ok, failed = judge.verdict(checks, limits)
        emit("control", seed, checks, {"correct": ok, "failed": failed,
                                       "seconds": time.perf_counter() - t0})
        del data, out
        gc.collect()

    for k in judge.CHECKS:
        lo = max((r[k] for r in rows["run"]), default=None)
        up = min((r[k] for r in rows["control"]), default=None)
        print(f"reading {k}: runs max {lo!r}, control min {up!r}, limit {limits[k]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
