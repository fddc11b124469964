"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface and
loaded with ``ctypes``. The libraries go to ``build/kernels/`` beside the
package, named by a hash of the source and the flags, so a changed source
rebuilds and an unchanged one is reused. All sources compile in parallel,
one ``nvcc`` each. Nothing here runs at import time: the first kernel
launch builds.

A failed build raises; there is no other route for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["build_all", "library", "stream_of", "check_status",
           "require_kernel_device", "BUILD_DIR", "SOURCES", "build_log",
           "KERNEL_DEVICES"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

#: library name -> source file under csrc/
SOURCES = {"hist_level": "hist_level.cu", "predict_walk": "predict_walk.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: tensor device types that go to the kernels (every other non-CPU device
#: raises in the wrappers)
KERNEL_DEVICES = ("cuda",)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures of the entry points (every pointer, the stream included,
#: is a c_void_p so 64-bit addresses are never cut)
_SIGNATURES = {
    "hist_level": {
        "xgbt_fused_level": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                             _P, _P],
    },
    "predict_walk": {
        "xgbt_predict_margin": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _P, _P, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall time (0.0 when reused), "log": nvcc stderr}
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, all ``nvcc``
    processes started together. Returns name -> library path."""
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    for n in targets:
        if n not in todo:
            build_log.setdefault(n, {"seconds": 0.0, "log": "(cached)"})
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, tgt in todo.items():
        tmp = tgt.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, tgt)
    failures = []
    for name, (proc, tmp, tgt) in procs.items():
        out, err = proc.communicate()
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "log": (out or "") + (err or "")}
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{err}")
            continue
        os.replace(tmp, tgt)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def stream_of(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch

    return int(torch.cuda.current_stream(device).cuda_stream)


def check_status(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def require_kernel_device(t, what: str) -> None:
    if t.device.type not in KERNEL_DEVICES:
        raise RuntimeError(
            f"{what}: no kernel for device {t.device}; tensors must be on "
            "the CPU (plain version) or on a CUDA device (kernel)")

