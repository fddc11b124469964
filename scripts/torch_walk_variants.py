"""Where kernel B (``csrc/predict_walk.cu``) spends its time, by variants.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_walk_variants.py

Builds copies of the kernel's source with edits (``VARIANTS``: the tree
count from which X is staged in shared memory, the number of walks in
flight per thread, rows per block, the forest-chunk buffer's size) with
``nvcc`` for ``sm_90a`` into ``build/walk_variants/``, all in parallel.
Then on 100k x 50 rows with 5% NaNs and forests of T random depth-6 heap
trees, T = 1, 10 and 500, times each variant's ``xgbt_predict_margin`` with
CUDA events (median of ``REPS`` launches after warm-up), with the median
SM clock and power draw that ``nvidia-smi`` samples while the variant runs
back to back for 1.5 s, and checks each variant bitwise against the
shipped kernel (every variant adds in the same order). Prints one line per
(variant, T) and one JSON line at the end.
"""

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from xgboost_tpu_torch import _build  # noqa: E402
from xgboost_tpu_torch.predictor import forest_from_numpy  # noqa: E402

ROWS, COLS, DEPTH, REPS = 100_000, 50, 6, 20
OUT = ROOT / "build" / "walk_variants"
SRC = ROOT / "xgboost_tpu_torch" / "csrc" / "predict_walk.cu"

#: name -> [(text of the shipped source, its replacement)]
VARIANTS = {
    "shipped": [],
    "stage_from_16": [("kStageTrees = 2;", "kStageTrees = 16;")],
    "stage_from_8": [("kStageTrees = 2;", "kStageTrees = 8;")],
    "walks2": [("kWalks = 4;", "kWalks = 2;")],
    "walks8": [("kWalks = 4;", "kWalks = 8;")],
    "rows128": [("kRows = 256;", "kRows = 128;")],
    "chunk48k": [("kChunkBytes = 24 * 1024;", "kChunkBytes = 48 * 1024;")],
}


def build(name, edits):
    text = SRC.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    src = OUT / f"{name}.cu"
    src.write_text(text)
    so = OUT / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SRC.parent), "-o",
           str(so), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), so


def load(so):
    f = ctypes.CDLL(str(so)).xgbt_predict_margin
    f.argtypes = _build._SIGNATURES["predict_walk"]["xgbt_predict_margin"]
    f.restype = ctypes.c_int
    return f


def time_ms(fn):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def under_load(fn, seconds=1.5):
    """Median SM clock (MHz) and power draw (W) that nvidia-smi samples
    every 100 ms while ``fn`` runs back to back for ``seconds``."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate(timeout=30)
    rows = [ln.split(",") for ln in out.splitlines() if "," in ln]
    if not rows:
        return None, None
    return (statistics.median(float(r[0]) for r in rows),
            statistics.median(float(r[1]) for r in rows))


def _forest(rng, T, dev):
    N = (1 << (DEPTH + 1)) - 1
    idx = np.arange(N)
    internal = idx < (1 << DEPTH) - 1
    left = np.tile(np.where(internal, 2 * idx + 1, -1), (T, 1))
    right = np.tile(np.where(internal, 2 * idx + 2, -1), (T, 1))
    cond = np.where(left >= 0, rng.randn(T, N) * 0.7, rng.randn(T, N) * 0.1)
    return forest_from_numpy(left, right, rng.randint(0, COLS, size=(T, N)),
                             cond.astype(np.float32), rng.rand(T, N) < 0.5,
                             np.zeros(T), DEPTH, 1, device=dev,
                             heap_layout=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {n: build(n, e) for n, e in VARIANTS.items()}
    fns = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{err}")
        regs = [ln.strip() for ln in err.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: {regs}")
        fns[name] = load(so)
    dev = torch.device("cuda")
    stream = _build.stream_of(dev)
    rng = np.random.RandomState(3)
    X = rng.randn(ROWS, COLS).astype(np.float32)
    X[rng.rand(ROWS, COLS) < 0.05] = np.nan
    X = torch.as_tensor(X, device=dev)
    base = torch.zeros((ROWS, 1), device=dev)
    results = []
    for T in (1, 10, 500):
        forest = _forest(rng, T, dev)
        N = forest.left.shape[1]
        want = None
        for name, fn in fns.items():
            out = torch.empty((ROWS, 1), device=dev)

            def run():
                _build.check_status(fn(
                    X.data_ptr(), ROWS, COLS, forest.nodes.data_ptr(),
                    forest.tree_group.data_ptr(),
                    forest.unit_weights.data_ptr(), T, N, DEPTH, 1,
                    base.data_ptr(), out.data_ptr(), stream), name)
            run()
            torch.cuda.synchronize()
            if want is None:
                want = out.clone()
            if not torch.equal(out, want):
                raise RuntimeError(f"{name} T={T}: differs")
            ms = time_ms(run)
            mhz, watts = under_load(run)
            print(f"T={T}: {name:14s} {ms:.4f} ms  {mhz} MHz {watts} W under "
                  "load  bitwise equal")
            results.append(dict(T=T, variant=name, ms=ms, sm_mhz=mhz,
                                watts=watts))
    for query in ("name,power.limit",
                  "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"):
        smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip())
    print(json.dumps({"variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
