"""Run one cell of the benchmark of ``xgboost_tpu_torch`` on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's checks on standard error (last lines) and one JSON object
as the last line of standard output. Exits non-zero, printing no result,
without a CUDA card, without the program beside this folder, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch
    t_torch = time.perf_counter()

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    try:
        import xgboost_tpu_torch
    except ImportError as e:
        print(f"portbench: the program is not here: {e}", file=sys.stderr)
        return 2
    if os.path.dirname(os.path.dirname(os.path.abspath(
            xgboost_tpu_torch.__file__))) != ROOT:
        print(f"portbench: xgboost_tpu_torch was loaded from "
              f"{xgboost_tpu_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2
    from portbench import harness
    t_program = time.perf_counter()

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start=T_START,
                              marks={"torch": t_torch, "program": t_program})
    bad = harness.forbidden_modules()
    if bad:
        print("portbench: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
