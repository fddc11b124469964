"""Where kernel A (``csrc/hist_level.cu``) spends its time, by variants.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_level_variants.py

Builds copies of the kernel's source with edits (``VARIANTS``: 64-bit
shared-memory adds instead of 32-bit halves, the shared tile's cap and so
its node slices and feature groups, the grid's size in waves, and
diagnostic cuts: plain stores instead of shared-memory atomics, no flush of
the tiles) with ``nvcc`` for ``sm_90a`` into ``build/level_variants/``, all
in parallel. Then at 1M x 50, for max_bin 64 (uint8 bins) and 256 (int16),
at levels 0 and 5 (K = 1 and K = 32), times each variant's
``xgbt_fused_level`` with CUDA events (median of ``REPS`` launches after
warm-up) with rows at random nodes of the level and routing off (``Kp =
0``), beside the routing launch alone (``xgbt_level_route``), one read of
the feature-major bins (``amax``), and the median SM clock and power draw
that ``nvidia-smi`` samples while the variant runs back to back for 1.5 s.
Each variant that keeps the arithmetic is checked bitwise against the
shipped kernel. Prints one line per (variant, level) and one JSON line at
the end.
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
from xgboost_tpu_torch.tree import hist_kernel as hk  # noqa: E402

ROWS, COLS, REPS = 1_000_000, 50, 10
OUT = ROOT / "build" / "level_variants"
SRC = ROOT / "xgboost_tpu_torch" / "csrc" / "hist_level.cu"

CAP = "kHalvesMaxRows = 1LL << 16;"
FLUSH_SUM = "(static_cast<long long>(hi[c]) << 16) + (long long)lo[c]"
BUDGET = "constexpr int kTileBudget = 96 * 1024;"
WAVES = "constexpr int kWaves = 2;"
ADD_LO = "atomicAdd(lo + c, (unsigned)q[j].x & 0xffffu);"
ADD_HI = "atomicAdd(hi + c, q[j].x >> 16);"
ADD_LO_H = "atomicAdd(lo + c + slab, (unsigned)q[j].y & 0xffffu);"
ADD_HI_H = "atomicAdd(hi + c + slab, q[j].y >> 16);"
FLUSH = "    if (v == 0) continue;"
#: name -> [(text of the shipped source, its replacement)]; "diag" variants
#: change the arithmetic and are timed only
VARIANTS = {
    "shipped": [],
    # one 64-bit add per value (a compare-and-swap loop in the SASS) into
    # the same bytes, no cap on a block's rows
    "tile64": [(CAP, "kHalvesMaxRows = 1LL << 40;"),
               (ADD_LO, "atomicAdd(tile + c, (unsigned long long)(long long)"
                        "q[j].x);"),
               (ADD_HI, ""),
               (ADD_LO_H, "atomicAdd(tile + c + slab, (unsigned long long)"
                          "(long long)q[j].y);"),
               (ADD_HI_H, ""),
               (FLUSH_SUM, "static_cast<long long>(tile[c])")],
    "budget48": [(BUDGET, "constexpr int kTileBudget = 48 * 1024;")],
    "budget160": [(BUDGET, "constexpr int kTileBudget = 160 * 1024;"),
                  ("kBlocksPerSm = 2;", "kBlocksPerSm = 1;")],
    "waves1": [(WAVES, "constexpr int kWaves = 1;")],
    "waves4": [(WAVES, "constexpr int kWaves = 4;")],
    "diag_stores": [(ADD_LO, "lo[c] = (unsigned)q[j].x & 0xffffu;"),
                    (ADD_HI, "hi[c] = q[j].x >> 16;"),
                    (ADD_LO_H, "lo[c + slab] = (unsigned)q[j].y & 0xffffu;"),
                    (ADD_HI_H, "hi[c + slab] = q[j].y >> 16;")],
    "diag_no_flush": [(FLUSH, "    continue;")],
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
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build._SIGNATURES["hist_level"].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {n: build(n, e) for n, e in VARIANTS.items()}
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{err}")
        regs = [ln.strip() for ln in err.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: {regs}")
        libs[name] = load(so)
    dev = torch.device("cuda")
    stream = _build.stream_of(dev)
    rng = np.random.RandomState(0)
    results = []
    for B, dt in ((64, torch.uint8), (256, torch.int16)):
        bins = torch.as_tensor(rng.randint(0, B + 1, size=(ROWS, COLS)),
                               device=dev).to(dt)
        bins_t = hk.feature_major(bins)
        seq_ms = time_ms(lambda: bins_t.view(torch.int16).amax())
        print(f"B={B}: amax over the feature-major bins "
              f"({bins_t.numel() * bins_t.element_size() / 1e6:.0f} MB) "
              f"{seq_ms:.4f} ms")
        results.append(dict(B=B, what="amax", ms=seq_ms))
        q = torch.as_tensor(rng.randint(-2**30, 2**30, size=(ROWS, 2)),
                            device=dev).to(torch.int32)
        ptab = torch.zeros((1, 4), dtype=torch.float32, device=dev)
        for d in (0, 5):
            K = 1 << d
            pos = torch.as_tensor(rng.randint(K - 1, 2 * K - 1, (ROWS, 1)),
                                  device=dev).to(torch.int32)
            pos_out = torch.empty_like(pos)
            loc = torch.empty(ROWS, dtype=torch.int32, device=dev)
            head = (bins.data_ptr(), bins.element_size(), ROWS, COLS, B,
                    pos.data_ptr(), pos_out.data_ptr())

            def route():
                _build.check_status(libs["shipped"].xgbt_level_route(
                    *head, ptab.data_ptr(), ptab.shape[1], 0, 0, K, K - 1,
                    loc.data_ptr(), stream), "route")
            r_ms = time_ms(route)
            print(f"B={B} level {d}: routing launch alone {r_ms:.4f} ms")
            results.append(dict(B=B, level=d, what="route", ms=r_ms))
            want = None
            for name, lib in libs.items():
                hist = torch.zeros((COLS, 2 * K, B), dtype=torch.int64,
                                   device=dev)

                def run():
                    hist.zero_()
                    _build.check_status(lib.xgbt_fused_level(
                        *head, q.data_ptr(), ptab.data_ptr(), ptab.shape[1],
                        0, 0, K, K - 1, hist.data_ptr(), bins_t.data_ptr(),
                        bins_t.stride(0), loc.data_ptr(), stream), name)
                run()
                torch.cuda.synchronize()
                same = None
                if not name.startswith("diag"):
                    if want is None:
                        want = hist.clone()
                    same = bool(torch.equal(hist, want))
                    if not same:
                        raise RuntimeError(f"{name} B={B} d={d}: differs")
                ms = time_ms(run)
                mhz, watts = under_load(run)
                print(f"B={B} level {d}: {name:16s} {ms:.4f} ms  "
                      f"{mhz} MHz {watts} W under load"
                      + ("" if same is None else "  bitwise equal"))
                results.append(dict(B=B, level=d, variant=name, ms=ms,
                                    sm_mhz=mhz, watts=watts))
        del bins, bins_t
        torch.cuda.empty_cache()
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
