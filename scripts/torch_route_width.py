"""Kernel A's and kernel D's routing launches by decision-table width.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_route_width.py [--root PATH] [--label NAME]

``--root`` imports the port from another checkout (for example a parent
commit unpacked with ``git archive``), so two commits can be compared on one
card: run the script once per tree, in turns. At 1M x 50 int16 bins
(max_bin 256, bins uniform over ``0..B``, ``B`` being the missing bin), for
levels d = 1..5 with every row at a random node of level d-1 and a random
numerical decision table ``[Kp, 4]`` (80% of the nodes split, random
feature, bin and default direction), it times each routing launch alone:
kernel A's (``_level_records_cuda``) and kernel D's (``_channel_records_cuda``,
the partial hoist of 33 features), each by ``torch.profiler``'s device time
of the routing kernel over ``REPS`` launches. Where the tree's wrappers take
it, the same table widened to ``[Kp, 5+B]`` (half the nodes categorical,
each set 40% of the bins) is timed too, after a check that both launches
route as the plain ``partition_apply`` does. Prints one line per level and
one JSON line, with the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROWS, COLS, B, FH, REPS = 1_000_000, 50, 256, 33, 50
#: routing kernels by launch, as ``torch.profiler`` names them
KERNELS = {"A": "level_route_kernel", "D": "route_kernel"}


def device_ms(fn, kernel: str) -> float:
    """Mean device time per call of ``fn`` spent in ``kernel`` (D's routing
    kernel is told from A's by the latter's longer name)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and KERNELS[kernel] in e.key
             and (kernel == "A" or KERNELS["A"] not in e.key))
    if us <= 0:
        raise RuntimeError(f"the profiler saw no {KERNELS[kernel]}")
    return us / REPS / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from xgboost_tpu_torch.tree import hist_kernel as hk

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    bins = torch.as_tensor(rng.randint(0, B + 1, size=(ROWS, COLS)),
                           device=dev).to(torch.int16)
    gq = hk.quantize_gradients(
        torch.as_tensor(rng.randn(ROWS), device=dev).float(),
        torch.as_tensor(rng.rand(ROWS), device=dev).float())
    levels = []
    for d in range(1, 6):
        K, Kp = 1 << d, 1 << (d - 1)
        pos = torch.as_tensor(rng.randint(Kp - 1, 2 * Kp - 1, (ROWS, 1)),
                              device=dev).to(torch.int32)
        narrow = np.stack([rng.rand(Kp) < 0.8, rng.randint(0, COLS, Kp),
                           rng.randint(0, B, Kp), rng.rand(Kp) < 0.5],
                          axis=1).astype(np.float32)
        wide = np.concatenate([narrow, rng.rand(Kp, 1) < 0.5,
                               rng.rand(Kp, B) < 0.4], axis=1)
        kw = dict(K=K, Kp=Kp, B=B, d=d)
        row = dict(level=d)
        for width, table in (("4", narrow), ("5+B", wide.astype(np.float32))):
            ptab = torch.as_tensor(table, device=dev)
            run_a = lambda: hk._level_records_cuda(  # noqa: E731
                bins, pos, gq, ptab, **kw)
            run_d = lambda: hk._channel_records_cuda(  # noqa: E731
                bins, pos, gq, ptab, Fh=FH, **kw)
            try:
                got_a, got_d = run_a()[0], run_d()[0]
            except ValueError as e:  # a tree whose wrappers take width 4
                row[width] = None
                print(f"level {d}: width {width} refused: {e}")
                continue
            want = hk.partition_apply(bins, pos, ptab, Kp=Kp, B=B, d=d)
            if not (torch.equal(got_a, want) and torch.equal(got_d, want)):
                raise RuntimeError(f"level {d} width {width}: routing differs")
            row[width] = dict(A_ms=device_ms(run_a, "A"),
                              D_ms=device_ms(run_d, "D"))
        levels.append(row)
        print(f"level {d} (Kp={Kp}): " + "; ".join(
            f"width {w}: A {row[w]['A_ms']:.5f} ms, D {row[w]['D_ms']:.5f} ms"
            for w in ("4", "5+B") if row[w] is not None))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "root": args.root, "card": smi,
                      "levels": levels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
