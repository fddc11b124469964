"""DMatrix: dense data + labels, weights and base margins on one device.

The port of the dense part of the JAX package's ``data/dmatrix.py``
(reference ``include/xgboost/data.h:47-185`` MetaInfo,
``python-package/xgboost/core.py:501`` DMatrix). The data lives on the
DMatrix's device as [n, F] float32 with NaN for missing; the quantized view
(``BinnedMatrix``, the ELLPACK analog) is built on first use and cached per
``max_bin``. Features whose ``feature_types`` entry is ``"c"`` (or
``"categorical"``) hold integer category codes and are binned one bin per
category.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from .quantile import BinnedMatrix

__all__ = ["DMatrix"]


def _vector(v: Any, device: torch.device) -> Optional[torch.Tensor]:
    if v is None:
        return None
    return torch.as_tensor(np.asarray(v, np.float32).reshape(-1),
                           device=device)


class DMatrix:
    """In-memory dense matrix + metadata, the training/predict input.
    ``device`` defaults to the CUDA card; pass ``device="cpu"`` for the
    plain PyTorch versions. ``feature_types`` marks categorical columns
    with ``"c"``; ``enable_categorical`` concerns only data frames, whose
    adapters are not ported, as in the JAX package. ``feature_weights``
    ([F]) weight the per-tree column sample (``colsample_bytree``).
    ``label_lower_bound`` and ``label_upper_bound`` ([n]) are the censoring
    intervals of ``survival:aft``; like the label they live on the
    matrix's device."""

    #: the fields of ``set_float_info`` / ``get_float_info``
    _FLOAT_INFO = ("label", "weight", "base_margin", "label_lower_bound",
                   "label_upper_bound", "feature_weights")

    def __init__(self, data: Any, label: Any = None, *, weight: Any = None,
                 base_margin: Any = None, missing: float = np.nan,
                 feature_names: Any = None, feature_types: Any = None,
                 enable_categorical: bool = False,
                 feature_weights: Any = None,
                 label_lower_bound: Any = None, label_upper_bound: Any = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.device = resolve_device(device)
        self.feature_names: Optional[List[str]] = (
            list(feature_names) if feature_names else None)
        self.feature_types: Optional[List[str]] = (
            list(feature_types) if feature_types else None)
        if hasattr(data, "tocsr") or not isinstance(
                data, (np.ndarray, list, tuple, torch.Tensor)):
            raise NotImplementedError(
                "only dense numpy/torch input is ported yet")
        X = np.asarray(data.cpu() if isinstance(data, torch.Tensor) else data,
                       np.float32)
        if X.ndim != 2:
            raise ValueError(f"data must be 2-D, got shape {X.shape}")
        if not (isinstance(missing, float) and np.isnan(missing)):
            X = np.where(X == missing, np.nan, X).astype(np.float32)
        self.data = torch.as_tensor(np.ascontiguousarray(X), device=self.device)
        self.label = _vector(label, self.device)
        self.weight = _vector(weight, self.device)
        self.base_margin = (None if base_margin is None else torch.as_tensor(
            np.asarray(base_margin, np.float32), device=self.device))
        self.feature_weights = _vector(feature_weights, self.device)
        self.label_lower_bound = _vector(label_lower_bound, self.device)
        self.label_upper_bound = _vector(label_upper_bound, self.device)
        self._binned: Dict[int, BinnedMatrix] = {}

    # ---- metadata (the JAX package's ``DMatrix.set_*`` / ``get_*``) ----
    def set_label(self, label: Any) -> None:
        self.label = _vector(label, self.device)

    def set_weight(self, weight: Any) -> None:
        self.weight = _vector(weight, self.device)

    def set_base_margin(self, margin: Any) -> None:
        self.base_margin = torch.as_tensor(np.asarray(margin, np.float32),
                                           device=self.device)

    def set_feature_weights(self, weights: Any) -> None:
        """[F] float32 weights of the per-tree column sample (the JAX
        package's ``set_float_info("feature_weights", ...)``)."""
        self.feature_weights = _vector(weights, self.device)

    def set_float_info(self, field: str, data: Any) -> None:
        """Set one of ``_FLOAT_INFO`` (the JAX package's
        ``set_float_info``), on the matrix's device."""
        if field not in self._FLOAT_INFO:
            raise ValueError(f"unknown float field: {field!r}")
        if field == "base_margin":
            self.set_base_margin(data)
        else:
            setattr(self, field, _vector(data, self.device))

    def get_float_info(self, field: str) -> np.ndarray:
        """One of ``_FLOAT_INFO`` on the host, empty when unset."""
        if field not in self._FLOAT_INFO:
            raise ValueError(f"unknown float field: {field!r}")
        return self._host(getattr(self, field))

    @staticmethod
    def _host(v: Optional[torch.Tensor]) -> np.ndarray:
        return (np.empty(0, np.float32) if v is None
                else v.cpu().numpy())

    def get_label(self) -> np.ndarray:
        return self._host(self.label)

    def get_weight(self) -> np.ndarray:
        return self._host(self.weight)

    def get_base_margin(self) -> np.ndarray:
        return self._host(self.base_margin)

    def get_feature_weights(self) -> np.ndarray:
        return self._host(self.feature_weights)

    def slice(self, rindex: Any) -> "DMatrix":
        """A new DMatrix of the selected rows on the same device, with
        label, weight, base margin, label bounds and feature metadata
        sliced along; its bins are built anew on first use (the JAX
        package's ``DMatrix.slice``); the feature weights are kept.
        ``rindex`` is an integer index array or a boolean row mask;
        out-of-range indices raise IndexError."""
        rindex = np.asarray(rindex)
        if rindex.dtype == np.bool_:
            rindex = np.nonzero(rindex)[0]
        rindex = rindex.astype(np.int64).ravel()
        n = self.num_row()
        if rindex.size and (rindex.min() < -n or rindex.max() >= n):
            raise IndexError(
                f"slice index out of range for {n} rows: "
                f"[{rindex.min()}, {rindex.max()}]")
        idx = torch.as_tensor(rindex, device=self.device)
        out = DMatrix.__new__(DMatrix)
        out.device = self.device
        out.feature_names = self.feature_names
        out.feature_types = self.feature_types
        out.feature_weights = self.feature_weights
        out.data = self.data[idx]
        for name in ("label", "weight", "base_margin", "label_lower_bound",
                     "label_upper_bound"):
            v = getattr(self, name)
            setattr(out, name, None if v is None else v[idx])
        out._binned = {}
        return out

    def num_row(self) -> int:
        return int(self.data.shape[0])

    def num_col(self) -> int:
        return int(self.data.shape[1])

    def categorical_features(self) -> List[int]:
        ft = self.feature_types
        if not ft:
            return []
        return [i for i, t in enumerate(ft) if t in ("c", "categorical")]

    def get_binned(self, max_bin: int = 256) -> BinnedMatrix:
        """Build-or-fetch the quantized matrix for this ``max_bin``; the
        sketch is weighted by the row weights, as in the JAX package.
        With row weights (or more than 2^24 rows) the sketch's prefix sum
        runs on the host even for a CUDA matrix (see ``compute_cuts``).
        Categorical features are checked (``_validate_categorical``) and
        get identity cuts."""
        bm = self._binned.get(max_bin)
        if bm is None:
            cat = self.categorical_features()
            if cat:
                self._validate_categorical(cat, max_bin)
            bm = BinnedMatrix.from_dense(self.data, max_bin=max_bin,
                                         weights=self.weight, categorical=cat)
            self._binned[max_bin] = bm
        return bm

    def _validate_categorical(self, cat: List[int], max_bin: int) -> None:
        """Categorical codes must be non-negative integers below
        ``max_bin``: one bin per category, and the predictor's set lookup
        must agree with the binning (reference ``common/categorical.h``
        InvalidCat). The messages are the JAX package's."""
        col = self.data[:, cat]
        present = ~torch.isnan(col)
        neg_or_frac = present & ((col < 0) | (col != torch.floor(col)))
        top = torch.where(present, col,
                          torch.full_like(col, -1.0)).amax(dim=0)
        for f, bad, mx, has in zip(cat, neg_or_frac.any(dim=0).tolist(),
                                   top.tolist(), present.any(dim=0).tolist()):
            if not has:
                continue
            if bad:
                raise ValueError(f"categorical feature {f} has negative or "
                                 "non-integer codes")
            if mx >= max_bin:
                raise ValueError(
                    f"categorical feature {f} has {int(mx) + 1} categories, "
                    f"exceeding max_bin={max_bin}; raise max_bin")
