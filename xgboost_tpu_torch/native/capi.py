"""The Python side of the C API (``c_api.cpp``).

Each exported C function takes the interpreter lock and calls one function
here (or one method of the handle's object), passing caller memory as
read-only ``memoryview``s; arrays come back as ``(float32 bytes, shape)``
and strings as ``str``, which the C++ copies into the handle's buffers.
No device pointer crosses the ABI: predictions are host floats.

**The device.** The C ABI has no device argument. ``XGBTPU_DEVICE`` is
read each time a DMatrix or Booster handle is created: unset or ``cuda``
is the card, ``cpu`` the CPU, any other value fails the call. Where there
is no card and the key does not say ``cpu``, the creating call fails with
``resolve_device``'s message; nothing runs on the CPU instead. A handle
keeps its device: ``XGBoosterSetParam(h, "device", v)`` naming another
device fails (the Python API's ``set_param`` ignores the key).
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..data import adapters
from ..data.dmatrix import DMatrix
from ..learner import Booster

__all__ = ["device"]


def device() -> torch.device:
    """The device of a handle created now, from ``XGBTPU_DEVICE``."""
    v = os.environ.get("XGBTPU_DEVICE", "")
    if v in ("", "cuda"):
        return resolve_device(None)
    if v == "cpu":
        return resolve_device("cpu")
    raise ValueError(f"XGBTPU_DEVICE={v!r}: use 'cuda' (the card, the "
                     "default) or 'cpu'")


def _floats(a: Any) -> Tuple[bytes, Tuple[int, ...]]:
    a = np.ascontiguousarray(a, np.float32)
    return a.tobytes(), a.shape


def _int(cfg: dict, key: str) -> int:
    """An integer field of a predict config, 0 when absent; any other
    type raises (a malformed field must not drop the option)."""
    v = cfg.get(key, 0)
    if not isinstance(v, int):
        raise TypeError(f"predict config: {key!r} must be an integer, got "
                        f"{v!r}")
    return v


# ------------------------------------------------------------------ DMatrix

def from_mat(mv: memoryview, nrow: int, ncol: int,
             missing: float) -> DMatrix:
    """``XGDMatrixCreateFromMat``: a copy of the caller's row-major
    float32 rows, entries equal to ``missing`` missing."""
    X = np.frombuffer(mv, np.float32).reshape(nrow, ncol).copy()
    return DMatrix(X, missing=missing, device=device())


def from_file(fname: str) -> DMatrix:
    """``XGDMatrixCreateFromFile``: a libsvm / csv / binary URI, parsed by
    ``fastparse.cpp`` where it is text."""
    return DMatrix(fname, device=device())


def from_csr(indptr: memoryview, indices: memoryview, data: memoryview,
             ncol: int) -> DMatrix:
    """``XGDMatrixCreateFromCSREx``: copies of the caller's CSR arrays,
    kept sparse on the host."""
    import scipy.sparse as sp

    pi = np.frombuffer(indptr, np.uint64).astype(np.int64)
    px = np.frombuffer(indices, np.uint32).astype(np.int64)
    pv = np.frombuffer(data, np.float32).copy()
    csr = sp.csr_matrix((pv, px, pi), shape=(len(pi) - 1, int(ncol)))
    return DMatrix(csr, device=device())


def set_info(d: DMatrix, field: str, mv: memoryview, dtype: str) -> None:
    """``XGDMatrixSetFloatInfo`` / ``SetUIntInfo`` (``dtype`` float32 /
    uint32; the unsigned values widened to int64 exactly)."""
    arr = np.frombuffer(mv, dtype)
    arr = arr.astype(np.int64) if dtype == "uint32" else arr.copy()
    d.set_info(**{field: arr})


def get_info(d: DMatrix, field: str, dtype: str) -> bytes:
    info = (d.get_uint_info(field) if dtype == "uint32"
            else d.get_float_info(field))
    return np.ascontiguousarray(info, dtype).tobytes()


def slice_rows(d: DMatrix, idx: memoryview) -> DMatrix:
    return d.slice(np.frombuffer(idx, np.int32).astype(np.int64))


# ------------------------------------------------------------------ Booster

def booster(mats: List[DMatrix]) -> Booster:
    return Booster({}, mats, device=device())


def _same_device(value: str, dev: torch.device) -> bool:
    try:
        want = torch.device(value)
    except (RuntimeError, TypeError):
        return False
    index = 0 if dev.index is None else dev.index
    return want.type == dev.type and want.index in (None, index)


def set_param(b: Booster, name: str, value: str) -> None:
    """``XGBoosterSetParam``. ``device`` may only name the handle's own
    device; ``eval_metric`` adds a metric on each call, as the
    reference's learner does (the Python API's replaces the list)."""
    if name == "device":
        if not _same_device(value, b.device):
            raise ValueError(
                f"device={value!r}: this handle is on {b.device}; the "
                "device is fixed at creation by XGBTPU_DEVICE")
        return
    if name == "eval_metric":
        names = list(b.lparam.eval_metric)
        if value not in names:
            b.set_param(name, names + [value])
        return
    b.set_param(name, value)


def boost(b: Booster, d: DMatrix, grad: memoryview, hess: memoryview) -> None:
    b.boost(d, np.frombuffer(grad, np.float32).copy(),
            np.frombuffer(hess, np.float32).copy())


def eval_sets(b: Booster, mats: List[DMatrix], names: List[str],
              iteration: int) -> str:
    return b.eval_set(list(zip(mats, names)), iteration)


def predict(b: Booster, d: DMatrix, option_mask: int, ntree_limit: int):
    """``XGBoosterPredict``: values (mask 0) or margins (mask 1);
    ``ntree_limit`` counts trees, as in the reference."""
    if option_mask & ~1:
        raise ValueError(
            "XGBoosterPredict: only option_mask 0 (value) and 1 "
            "(output_margin) are supported; use XGBoosterPredictFromDMatrix "
            "for leaf/contribution predictions")
    return _floats(b.predict(d, output_margin=bool(option_mask & 1),
                             ntree_limit=int(ntree_limit)))


def predict_dmatrix(b: Booster, d: DMatrix, config: Optional[str]):
    """``XGBoosterPredictFromDMatrix``: ``type`` 0 value, 1 margin, 2 (3)
    contributions, 4 (5) interactions, 6 leaf; ``iteration_begin`` /
    ``iteration_end``; ``strict_shape``."""
    cfg = json.loads(config or "{}")
    kind = {3: 2, 5: 4}.get(_int(cfg, "type"), _int(cfg, "type"))
    flag = {1: "output_margin", 2: "pred_contribs", 4: "pred_interactions",
            6: "pred_leaf"}
    if kind not in (0, *flag):
        raise ValueError("XGBoosterPredictFromDMatrix: unsupported type")
    kw = {flag[kind]: True} if kind else {}
    if cfg.get("strict_shape"):
        kw["strict_shape"] = True
    begin, end = _int(cfg, "iteration_begin"), _int(cfg, "iteration_end")
    if end > 0:
        kw["iteration_range"] = (begin, end)
    return _floats(b.predict(d, **kw))


def _inplace(b: Booster, data: Any, config: Optional[str],
             m: Optional[DMatrix]):
    """The shared body of ``XGBoosterPredictFromDense`` / ``FromCSR``:
    ``type`` 0 value or 1 margin, ``missing`` (a number or null),
    ``iteration_begin`` / ``iteration_end`` (either set: the range, end 0
    meaning the last round), ``strict_shape``; ``m``'s base margin where
    it has one."""
    cfg = json.loads(config or "{}")
    kind = _int(cfg, "type")
    missing = cfg.get("missing")
    if missing is not None and not isinstance(missing, (int, float)):
        raise TypeError(
            "inplace predict: 'missing' must be a number (or null)")
    begin, end = _int(cfg, "iteration_begin"), _int(cfg, "iteration_end")
    if kind not in (0, 1):
        raise ValueError(
            "inplace predict supports type 0 (value) and 1 (margin); use "
            "XGBoosterPredictFromDMatrix for leaf/contribution predictions")
    kw = dict(predict_type="margin" if kind == 1 else "value",
              missing=np.nan if missing is None else float(missing))
    if cfg.get("strict_shape"):
        kw["strict_shape"] = True
    if begin > 0 or end > 0:
        kw["iteration_range"] = (begin, end)
    if m is not None and m.base_margin is not None and m.base_margin.numel():
        kw["base_margin"] = m.base_margin.cpu().numpy()
    return _floats(b.inplace_predict(data, **kw))


def predict_dense(b: Booster, values: str, config: Optional[str],
                  m: Optional[DMatrix]):
    """``values``: an ``__array_interface__`` document over caller
    memory, read where it lies."""
    return _inplace(b, adapters.from_array_interface(values), config, m)


def predict_csr(b: Booster, indptr: str, indices: str, values: str,
                ncol: int, config: Optional[str], m: Optional[DMatrix]):
    return _inplace(b, adapters.csr_from_array_interface(
        indptr, indices, values, ncol), config, m)


def serialize(b: Booster) -> str:
    """Model and configuration (``XGBoosterSerializeToBuffer``): the
    pickle state as JSON."""
    return json.dumps(b.__getstate__(), default=float)


def unserialize(b: Booster, buf: bytes) -> None:
    """``XGBoosterUnserializeFromBuffer``, on the handle's own device."""
    state = json.loads(buf.decode("utf-8"))
    state["device"] = str(b.device)
    b.__setstate__(state)


def set_attr(b: Booster, key: str, value: Optional[str]) -> None:
    b.set_attr(**{key: value})


_FEATURE_INFO = {"feature_name": "feature_names",
                 "feature_type": "feature_types"}


def _feature_attr(field: str) -> str:
    if field not in _FEATURE_INFO:
        raise ValueError("field must be 'feature_name' or 'feature_type'")
    return _FEATURE_INFO[field]


def get_feature_info(b: Booster, field: str) -> List[str]:
    return [str(v) for v in getattr(b, _feature_attr(field)) or []]


def set_feature_info(b: Booster, field: str, values: List[str]) -> None:
    """The model's feature names or types; an empty list clears them."""
    setattr(b, _feature_attr(field), values or None)


def dump(b: Booster, fmap: str, with_stats: int) -> List[str]:
    return list(b.get_dump(fmap, bool(with_stats)))
