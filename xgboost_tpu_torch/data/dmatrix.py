"""DMatrix: dense data + labels, weights and base margins on one device.

The port of the dense part of the JAX package's ``data/dmatrix.py``
(reference ``include/xgboost/data.h:47-185`` MetaInfo,
``python-package/xgboost/core.py:501`` DMatrix). The data lives on the
DMatrix's device as [n, F] float32 with NaN for missing; the quantized view
(``BinnedMatrix``, the ELLPACK analog) is built on first use and cached per
``max_bin``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

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
    plain PyTorch versions."""

    def __init__(self, data: Any, label: Any = None, *, weight: Any = None,
                 base_margin: Any = None, missing: float = np.nan,
                 feature_types: Any = None, enable_categorical: bool = False,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.device = resolve_device(device)
        if enable_categorical or (feature_types is not None and any(
                t in ("c", "categorical") for t in feature_types)):
            raise NotImplementedError(
                "categorical features are not ported yet")
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
        self._binned: Dict[int, BinnedMatrix] = {}

    def num_row(self) -> int:
        return int(self.data.shape[0])

    def num_col(self) -> int:
        return int(self.data.shape[1])

    def get_binned(self, max_bin: int = 256) -> BinnedMatrix:
        """Build-or-fetch the quantized matrix for this ``max_bin``; the
        sketch is weighted by the row weights, as in the JAX package.
        With row weights (or more than 2^24 rows) the sketch's prefix sum
        runs on the host even for a CUDA matrix (see ``compute_cuts``)."""
        bm = self._binned.get(max_bin)
        if bm is None:
            bm = BinnedMatrix.from_dense(self.data, max_bin=max_bin,
                                         weights=self.weight)
            self._binned[max_bin] = bm
        return bm
