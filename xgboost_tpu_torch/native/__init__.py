"""The native host runtime: C++ built with ``g++`` at first use, loaded
with ``ctypes`` (plain C interfaces, no pybind11).

- ``fastparse.cpp``: the libsvm and csv parser (the reference's dmlc-core
  text parsers) behind ``load_svmlight_native`` / ``load_csv_native``,
  which ``data/adapters.py`` calls for every file it reads;
- ``pagecache.cpp``: the page file writer and the ring of prefetched pages
  (``pagecache()``) under ``data/external.py`` ``PagedBins``;
- ``c_api.cpp``: the reference's C ABI (``include/xgboost/c_api.h``) over
  this package, by an embedded CPython (``build_capi()`` returns the
  library's path; C hosts ``dlopen`` or link it themselves).

Each library goes to ``build/native/`` beside the package, named by a hash
of its source and its full command line (the compiler, the flags and the
paths baked into the C API), so a changed source, compiler or tree
rebuilds and an unchanged one is reused. A build writes a ``.{pid}.tmp``
file and renames it into place, so processes building the same library at
once do not see each other's half-written files. ``CXX`` names the
compiler (default ``g++``). A failed build or load raises: no caller falls
back to a Python parser or to numpy file IO.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["BUILD_DIR", "build", "build_capi", "build_log", "fastparse",
           "pagecache", "load_svmlight_native", "load_csv_native"]

HERE = Path(__file__).resolve().parent
REPO_ROOT = HERE.parent.parent
BUILD_DIR = REPO_ROOT / "build" / "native"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: library name -> {"seconds": build wall time (0.0 when reused), "path"}
build_log: Dict[str, dict] = {}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_I64P = ctypes.POINTER(ctypes.c_int64)
#: C signatures (argtypes, restype) of the ctypes-loaded libraries
_SIGNATURES = {
    "fastparse": {
        "fp_libsvm_dims": ([ctypes.c_char_p, _I64P, _I64P, _I64P,
                            ctypes.POINTER(ctypes.c_int32)], _I),
        "fp_libsvm_parse": ([ctypes.c_char_p] + [_P] * 5
                            + [ctypes.c_int64] * 2, _I),
        "fp_csv_dims": ([ctypes.c_char_p, _I64P, _I64P], _I),
        "fp_csv_parse": ([ctypes.c_char_p, _P, ctypes.c_int64,
                          ctypes.c_int64], _I),
    },
    "pagecache": {
        "pc_write": ([ctypes.c_char_p, _P, _LL], _I),
        "pc_open": ([ctypes.c_char_p, _LL, ctypes.POINTER(_LL), _I], _P),
        "pc_read": ([_P, _LL, _P], _I),
        "pc_close": ([_P], None),
    },
}


def _capi_flags() -> List[str]:
    """The embedded interpreter's build flags: this Python's headers and
    shared library, the repository root and the site-packages baked in
    (``XGBTPU_ROOT`` / ``XGBTPU_SITE``, overridable from the environment
    of the host process)."""
    paths = sysconfig.get_paths()
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    pyver = (sysconfig.get_config_var("LDVERSION")
             or sysconfig.get_config_var("VERSION") or "")
    return ["-O2", "-std=c++17", "-ffp-contract=off",
            f"-I{paths['include']}",
            f'-DXGBTPU_ROOT="{REPO_ROOT}"',
            f'-DXGBTPU_SITE="{paths.get("purelib", "")}"',
            f"-L{libdir}", f"-lpython{pyver}", f"-Wl,-rpath,{libdir}",
            "-ldl", "-lm"]


def _spec(name: str) -> Tuple[str, Path, List[str]]:
    """``(library stem, source, flags)`` of library ``name``."""
    if name == "fastparse":
        return ("libfastparse_torch", HERE / "fastparse.cpp",
                ["-O3", "-ffp-contract=off"])
    if name == "pagecache":
        return ("libpagecache_torch", HERE / "pagecache.cpp",
                ["-O3", "-std=c++17", "-pthread", "-ffp-contract=off"])
    if name == "capi":
        return "libxgbtpu_torch", HERE / "c_api.cpp", _capi_flags()
    raise KeyError(name)


def _command(name: str) -> Tuple[List[str], Path]:
    """The compiler command (output path left as ``{out}``) and the
    target library of ``name``."""
    stem, src, flags = _spec(name)
    cmd = [os.environ.get("CXX") or "g++", "-shared", "-fPIC", "-o", "{out}",
           str(src), *flags]
    digest = hashlib.sha256(src.read_bytes() + "\0".join(cmd).encode())
    return cmd, BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name`` unless an up-to-date one exists; its path.
    Raises RuntimeError when the compiler fails."""
    cmd, target = _command(name)
    if target.exists():
        build_log.setdefault(name, {"seconds": 0.0, "path": str(target)})
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp")
    cmd = [str(tmp) if a == "{out}" else a for a in cmd]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"native build of {name} failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native build of {name} failed: {cmd[0]} exited "
            f"{proc.returncode}\n{(proc.stdout + proc.stderr)[-3000:]}")
    os.replace(tmp, target)
    build_log[name] = {"seconds": time.perf_counter() - t0,
                       "path": str(target)}
    return target


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)  # a dict read: no lock once loaded
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, restype
        _libs[name] = lib
        return lib


def fastparse() -> ctypes.CDLL:
    """The loaded parser library, built on first use."""
    return _load("fastparse")


def pagecache() -> ctypes.CDLL:
    """The loaded page-cache library, built on first use."""
    return _load("pagecache")


def build_capi() -> str:
    """The path of the C API library ``libxgbtpu_torch-<hash>.so``, built
    if needed. A path, not a loaded library: C hosts ``dlopen`` or link it
    themselves. Its symbols are the JAX package's ``libxgbtpu.so``'s under
    another file name, so a process can ``ctypes.CDLL`` both (each
    ``RTLD_LOCAL``), but never link both into one C host."""
    with _lock:
        return str(build("capi"))


def _path_bytes(path) -> bytes:
    """``path`` as the C parsers take it; FileNotFoundError where there is
    no such file (the parsers' -1 does not say why)."""
    p = os.fspath(path)
    os.stat(p)
    return os.fsencode(p)


def load_svmlight_native(path) -> Tuple[np.ndarray, np.ndarray,
                                        Optional[np.ndarray]]:
    """A libsvm file -> ``(X dense float32 with NaN missing, y, qid)``,
    ``qid`` where any row has one (else None). Malformed tokens are
    skipped, and a line whose label does not parse is dropped."""
    lib, p = fastparse(), _path_bytes(path)
    n_rows, n_entries = ctypes.c_int64(), ctypes.c_int64()
    max_col, has_qid = ctypes.c_int64(), ctypes.c_int32()
    if lib.fp_libsvm_dims(p, ctypes.byref(n_rows), ctypes.byref(n_entries),
                          ctypes.byref(max_col), ctypes.byref(has_qid)):
        raise OSError(f"{os.fspath(path)}: the libsvm parser cannot read it")
    n, e, mc = n_rows.value, n_entries.value, max_col.value
    rows = np.empty(e, np.int64)
    cols = np.empty(e, np.int32)
    vals = np.empty(e, np.float32)
    labels = np.empty(n, np.float32)
    qids = np.empty(n, np.int64) if has_qid.value else None
    if lib.fp_libsvm_parse(
            p, rows.ctypes.data, cols.ctypes.data, vals.ctypes.data,
            labels.ctypes.data, None if qids is None else qids.ctypes.data,
            n, e):
        raise OSError(f"{os.fspath(path)}: the libsvm parser cannot read it")
    X = np.full((n, mc + 1), np.nan, np.float32)
    if e:
        X[rows, cols] = vals
    return X, labels, qids


def load_csv_native(path) -> Tuple[np.ndarray, np.ndarray]:
    """A csv file, label in the first column -> ``(X, y)``: empty and
    unparsable fields NaN; lines that do not start like a number (a
    header, ``#`` comments) skipped; the first data line fixes the column
    count."""
    lib, p = fastparse(), _path_bytes(path)
    n_rows, n_cols = ctypes.c_int64(), ctypes.c_int64()
    if lib.fp_csv_dims(p, ctypes.byref(n_rows), ctypes.byref(n_cols)):
        raise OSError(f"{os.fspath(path)}: the csv parser cannot read it")
    n, c = n_rows.value, n_cols.value
    if c == 0:
        raise ValueError(f"{os.fspath(path)}: no data line")
    out = np.empty((n, c), np.float32)
    if lib.fp_csv_parse(p, out.ctypes.data, n, c):
        raise OSError(f"{os.fspath(path)}: the csv parser cannot read it")
    return np.ascontiguousarray(out[:, 1:]), out[:, 0].copy()
