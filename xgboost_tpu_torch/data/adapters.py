"""Input adapters: external formats -> dense float32 with NaN missing.

The port of the JAX package's ``data/adapters.py`` (reference
``src/data/adapter.h``, ``src/data/array_interface.h``,
``python-package/xgboost/data.py``): numpy, scipy.sparse, pandas (and
arrow, through pandas), lists and libsvm / csv / binary files all become
one host array ``[n_rows, n_features] float32`` with NaN for missing,
which ``DMatrix`` sends to its device. scipy input reaching ``DMatrix``
stays sparse (``data/sparse.py``); ``dispatch_data`` densifies it only for
its own callers. ``pandas`` and ``pyarrow`` are imported where a frame or a
table arrives, never at import time. libsvm and csv files are parsed by
the native parser (``native/fastparse.cpp``, built with ``g++`` at first
use; a failed build raises), as in the JAX package; a csv whose label is
not in column 0 goes through ``np.loadtxt``, as there. The Python parsers
``_load_svmlight_py`` / ``_load_csv_py`` are the plain versions the tests
hold the native one against.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Tuple

import numpy as np

__all__ = ["dispatch_data", "load_svmlight", "load_csv",
           "from_array_interface", "csr_from_array_interface"]


def from_array_interface(spec: Any) -> np.ndarray:
    """Zero-copy numpy view over caller-owned memory described by an
    ``__array_interface__`` JSON document (the payload of the reference's
    ``XGBoosterPredictFromDense``, c_api.cc:833). The caller keeps the
    memory alive as long as the view."""
    if isinstance(spec, (bytes, bytearray)):
        spec = spec.decode()
    if isinstance(spec, str):
        spec = json.loads(spec)
    data = spec["data"]
    iface = {
        "data": (int(data[0]), bool(data[1])),
        "shape": tuple(int(s) for s in spec["shape"]),
        "typestr": str(spec["typestr"]),
        "version": 3,
    }
    if spec.get("strides"):
        iface["strides"] = tuple(int(s) for s in spec["strides"])
    holder = type("_ArrayInterfaceView", (), {"__array_interface__": iface})()
    return np.asarray(holder)  # numpy keeps the holder as .base


def csr_from_array_interface(indptr: Any, indices: Any, values: Any,
                             ncol: int):
    """scipy CSR over caller-owned buffers, each described by an
    ``__array_interface__`` JSON document (the reference's
    ``XGBoosterPredictFromCSR`` payload, c_api.cc:878)."""
    import scipy.sparse as sp

    pi = from_array_interface(indptr)
    px = from_array_interface(indices)
    pv = from_array_interface(values)
    return sp.csr_matrix((pv, px, pi), shape=(int(pi.shape[0]) - 1, int(ncol)))


def _from_scipy(data: Any) -> np.ndarray:
    csr = data.tocsr()
    n, m = csr.shape
    out = np.full((n, m), np.nan, dtype=np.float32)
    row_ids = np.repeat(np.arange(n), np.diff(csr.indptr))
    out[row_ids, csr.indices] = csr.data.astype(np.float32)
    return out


def _from_pandas(data: Any, enable_categorical: bool):
    """A data frame's columns as float32, categorical ones as their codes
    (missing: NaN) when ``enable_categorical``; with the column names and
    the types ``"c"`` / ``"q"``."""
    import pandas as pd

    names = [str(c) for c in data.columns]
    types: List[str] = []
    cols = []
    for c in data.columns:
        ser = data[c]
        if isinstance(ser.dtype, pd.CategoricalDtype):
            if not enable_categorical:
                raise ValueError(
                    f"Column '{c}' is categorical; pass enable_categorical=True")
            codes = ser.cat.codes.to_numpy(dtype=np.float32)
            cols.append(np.where(codes < 0, np.nan, codes))
            types.append("c")
        else:
            cols.append(ser.to_numpy(dtype=np.float32, na_value=np.nan))
            types.append("q")
    out = (np.stack(cols, axis=1) if cols
           else np.empty((len(data), 0), np.float32))
    return out, names, types


def load_svmlight(path) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """A libsvm file -> ``(X, y, qid)``: absent entries NaN, ``qid`` where
    any row has one (else None); malformed tokens skipped and lines whose
    label does not parse dropped (``native/fastparse.cpp``)."""
    from ..native import load_svmlight_native

    return load_svmlight_native(path)


def _load_svmlight_py(path) -> Tuple[np.ndarray, np.ndarray,
                                     Optional[np.ndarray]]:
    """The plain Python libsvm parser: ``qid`` when every row has one;
    raises on a malformed token."""
    labels: List[float] = []
    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    qids: List[int] = []
    max_col = -1
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                if tok.startswith("qid:"):
                    qids.append(int(tok[4:]))
                    continue
                k, _, v = tok.partition(":")
                j = int(k)
                rows.append(len(labels) - 1)
                cols.append(j)
                vals.append(float(v))
                max_col = max(max_col, j)
    n = len(labels)
    X = np.full((n, max_col + 1), np.nan, dtype=np.float32)
    if rows:
        X[np.asarray(rows), np.asarray(cols)] = np.asarray(vals, np.float32)
    y = np.asarray(labels, dtype=np.float32)
    qid = np.asarray(qids, dtype=np.int64) if len(qids) == n else None
    return X, y, qid


def load_csv(path, label_column: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A csv file -> ``(X, y)``, the label in ``label_column``. With the
    label in column 0 (the default) the native parser reads it: header and
    ``#`` lines skipped, empty fields NaN; otherwise ``np.loadtxt`` (a
    headerless file), as in the JAX package."""
    if label_column == 0:
        from ..native import load_csv_native

        return load_csv_native(path)
    return _load_csv_py(path, label_column)


def _load_csv_py(path, label_column: int = 0) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """The plain csv parser (``np.loadtxt``): a headerless file of numbers
    only."""
    raw = np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)
    y = raw[:, label_column].copy()
    return np.delete(raw, label_column, axis=1), y


def _load_binary_fields(path: str):
    """``(X, label, feature_names)`` of a ``save_binary`` container; every
    key beyond ``data`` is optional and an empty array means unset."""
    with np.load(path, allow_pickle=False) as z:
        X = z["data"].astype(np.float32)
        label = z["label"] if "label" in z.files and z["label"].size else None
        names = ([str(x) for x in z["feature_names"]]
                 if "feature_names" in z.files else [])
    return X, label, names or None


def dispatch_data(data: Any, missing: float = np.nan,
                  enable_categorical: bool = False):
    """Any supported input -> ``(X float32 [n, F] with NaN missing,
    feature_names, feature_types, label, qid)``; the label and the query
    ids come only from files. ``str`` / ``PathLike`` URIs name libsvm
    (optionally with ``qid:``), csv (``.csv`` or ``?format=csv``) or binary
    (``.buffer``, ``.npz`` or ``?format=binary``) files."""
    names = types = label = qid = None
    if isinstance(data, (str, os.PathLike)):
        path, _, fmt = str(data).partition("?format=")
        if not fmt:
            if path.endswith(".csv"):
                fmt = "csv"
            elif path.endswith((".buffer", ".npz")):
                fmt = "binary"
            else:
                fmt = "libsvm"
        if fmt == "binary":
            X, label, names = _load_binary_fields(path)
        elif fmt == "csv":
            X, label = load_csv(path)
        else:
            X, label, qid = load_svmlight(path)
    elif hasattr(data, "tocsr"):  # scipy sparse
        X = _from_scipy(data)
    elif type(data).__module__.startswith("pyarrow"):  # a Table or batch
        X, names, types = _from_pandas(data.to_pandas(), enable_categorical)
    elif hasattr(data, "columns") and hasattr(data, "dtypes"):  # pandas
        X, names, types = _from_pandas(data, enable_categorical)
    else:
        X = np.asarray(data, dtype=np.float32)
        if X.ndim == 1:
            X = X.reshape(-1, 1)
        X = X.copy()  # the caller's array is not masked in place
    if X.dtype != np.float32:
        X = X.astype(np.float32)
    if missing is not None and not (
            isinstance(missing, float) and np.isnan(missing)):
        X[X == missing] = np.nan
    return X, names, types, label, qid
