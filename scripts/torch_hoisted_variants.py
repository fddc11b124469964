"""Where kernel D (``csrc/hoisted_level.cu``) spends its time, by variants.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_hoisted_variants.py

Builds copies of the kernel's source with edits (``VARIANTS``: the ring's
depth, the grid's target of blocks per SM, an L2 prefetch size on every
``cp.async``, and diagnostic cuts: no MMAs; MMAs alone, with no one-hot
stream and no channel-tile build; MMAs alone on register operands, with no
shared-memory fragment loads; the one-hot stage read as one contiguous 8 KB
instead of 64 strided 128-byte runs), each with ``nvcc`` for ``sm_90a``
into ``build/variants/``, all in parallel. Then at 1M x 50, for max_bin 64
(uint8 bins, full hoist) and 256 (int16 bins, the partial hoist of 33
features), at levels 0 and 5 (one slot group of MMAs against all eight),
times each variant's ``xgbt_hoisted_level`` with CUDA events (median of
``REPS`` launches after warm-up), with the median SM clock and power draw
that ``nvidia-smi`` samples while the variant runs back to back for 1.5 s,
beside one sequential read of the one-hot (``amax`` over it), and checks
each variant that keeps the arithmetic bitwise against the shipped kernel.
Rows sit at random nodes of
the level; routing is off (``Kp = 0``). Prints one line per (variant,
level) and one JSON line at the end.
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
OUT = ROOT / "build" / "variants"
SRC = ROOT / "xgboost_tpu_torch" / "csrc" / "hoisted_level.cu"

MMA = "mma_s8(acc[pi][ni][h], af, bf[ni][0], bf[ni][1]);"
BUILD = "if (r < a.n) {\n      const int4 rc"
STREAM = "cp_async16(Bring + slot * kTileBytes"
# each block's one-hot stage read as one contiguous 8 KB (the same bytes
# per stage, other data)
STRIDED = "ok ? a.onehot + (long long)(c0 + col) * a.n_pad + r"
SEQ = "ok ? a.onehot + (long long)c0 * a.n_pad + rs * kCols + 16 * cid"
CP = "cp.async.cg.shared.global.L2::256B [%0]"
FAKE = """__device__ __forceinline__ void fake_x4(unsigned* r, const unsigned char*) {
  r[0] = r[1] = r[2] = r[3] = 0x01010101u;
}

// 16 bytes global -> shared"""
#: name -> [(text of the shipped source, its replacement)]; "diag" variants
#: change the arithmetic and are timed only
VARIANTS = {
    "shipped": [],
    "bps16": [("kBlocksPerSm = 32;", "kBlocksPerSm = 16;")],
    "stages5": [("kStages = 4;", "kStages = 5;")],
    "bps64": [("kBlocksPerSm = 32;", "kBlocksPerSm = 64;")],
    # L2's prefetch size on every cp.async: none, or 128 bytes (256 shipped)
    "l2_none": [(CP, "cp.async.cg.shared.global [%0]")],
    "l2_128": [(CP, "cp.async.cg.shared.global.L2::128B [%0]")],
    "diag_no_build": [(BUILD, "if (false) {\n      const int4 rc")],
    "diag_no_mma": [(MMA, "{}")],
    "diag_mma_only": [(STREAM, "if (0) " + STREAM),
                      (BUILD, "if (false) {\n      const int4 rc")],
    "diag_seq_stream": [(STRIDED, SEQ)],
    "diag_seq_stream_no_mma": [(STRIDED, SEQ), (MMA, "{}")],
    "diag_mma_regs": [(STREAM, "if (0) " + STREAM),
                      (BUILD, "if (false) {\n      const int4 rc"),
                      ("// 16 bytes global -> shared", FAKE),
                      ("ldmatrix_x4(b4, ", "fake_x4(b4, "),
                      ("ldmatrix_x4(af, ", "fake_x4(af, ")],
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
    f = lib.xgbt_hoisted_level
    f.argtypes = _build._SIGNATURES["hoisted_level"]["xgbt_hoisted_level"]
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
    clocks = [float(r[0]) for r in rows]
    watts = [float(r[1]) for r in rows]
    if not rows:
        return None, None
    return statistics.median(clocks), statistics.median(watts)


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
    rng = np.random.RandomState(0)
    results = []
    for B, Fh, dt in ((64, 50, torch.uint8), (256, 33, torch.int16)):
        bins = torch.as_tensor(rng.randint(0, B + 1, size=(ROWS, COLS)),
                               device=dev).to(dt)
        onehot = hk._build_onehot_cuda(bins, B=B, Fh=Fh)
        n_pad = onehot.shape[1]
        seq_ms = time_ms(lambda: onehot.view(torch.int32).amax())
        print(f"B={B}: amax over the one-hot ({onehot.numel() / 1e9:.2f} GB)"
              f" {seq_ms:.4f} ms")
        results.append(dict(B=B, what="amax", ms=seq_ms))
        q = torch.as_tensor(rng.randint(-2**30, 2**30, size=(ROWS, 2)),
                            device=dev).to(torch.int32)
        ptab = torch.zeros((1, 4), dtype=torch.float32, device=dev)
        for d in (0, 5):
            K = 1 << d
            pos = torch.as_tensor(rng.randint(K - 1, 2 * K - 1, (ROWS, 1)),
                                  device=dev).to(torch.int32)
            want = None
            for name, fn in fns.items():
                pos_out = torch.empty_like(pos)
                hist = torch.zeros((COLS, 2 * K, B), dtype=torch.int64,
                                   device=dev)
                rec, bins_t = hk._route_scratch(bins, Fh, n_pad)

                def run():
                    hist.zero_()
                    st = fn(bins.data_ptr(), bins.element_size(), ROWS, COLS,
                            B, onehot.data_ptr(), Fh, n_pad, pos.data_ptr(),
                            pos_out.data_ptr(), q.data_ptr(), ptab.data_ptr(),
                            ptab.shape[1], 0, 0, K, K - 1, hist.data_ptr(),
                            rec.data_ptr(),
                            None if bins_t is None else bins_t.data_ptr(),
                            stream)
                    _build.check_status(st, name)
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
                print(f"B={B} level {d}: {name:24s} {ms:.4f} ms  "
                      f"{mhz} MHz {watts} W under load"
                      + ("" if same is None else "  bitwise equal"))
                results.append(dict(B=B, level=d, variant=name, ms=ms,
                                    sm_mhz=mhz, watts=watts))
        del onehot, bins
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
