"""DMatrix: dense data + labels, weights and base margins on one device.

The port of the dense part of the JAX package's ``data/dmatrix.py``
(reference ``include/xgboost/data.h:47-185`` MetaInfo,
``python-package/xgboost/core.py:501`` DMatrix). The data lives on the
DMatrix's device as [n, F] float32 with NaN for missing; the quantized view
(``BinnedMatrix``, the ELLPACK analog) is built on first use and cached per
``max_bin`` (and once for the exact candidate set); ``build_binned`` makes
an uncached one, as ``tree_method="approx"`` does every round. Features whose ``feature_types`` entry is ``"c"`` (or
``"categorical"``) hold integer category codes and are binned one bin per
category. Ranking matrices carry query groups (``group`` sizes or ``qid``
per row): the CSR pointer stays on the host as in the JAX package, and
the per-row tensors the ranking objective and metrics read are built from
it once, on the matrix's device (``QueryGroups``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from .quantile import BinnedMatrix, compute_exact_cuts

__all__ = ["DMatrix", "QueryGroups"]


def _vector(v: Any, device: torch.device) -> Optional[torch.Tensor]:
    if v is None:
        return None
    return torch.as_tensor(np.asarray(v, np.float32).reshape(-1),
                           device=device)


def _group_ptr_from_sizes(sizes: np.ndarray) -> np.ndarray:
    ptr = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=ptr[1:])
    return ptr


def _group_ptr_from_qid(qid: np.ndarray) -> np.ndarray:
    """A new group wherever ``qid`` changes from one row to the next (rows
    of a query are contiguous; the ids need not be sorted)."""
    if len(qid) == 0:
        return np.zeros(1, dtype=np.int64)
    change = np.nonzero(np.diff(qid))[0] + 1
    return np.concatenate([[0], change, [len(qid)]]).astype(np.int64)


class QueryGroups:
    """The query groups of a ranking matrix: ``ptr`` ([G+1] int64, on the
    host; group ``g`` holds rows ``ptr[g]:ptr[g+1]``) and, built once on
    ``device`` at first use, each row's group id, its group's first row
    and its group's size (``rows``)."""

    def __init__(self, ptr: Any, device: Union[str, torch.device]) -> None:
        self.ptr = np.asarray(ptr, np.int64).reshape(-1)
        self.sizes = np.diff(self.ptr)
        self.device = torch.device(device)
        self._rows: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def n_groups(self) -> int:
        return len(self.sizes)

    @property
    def max_size(self) -> int:
        return int(self.sizes.max(initial=1))

    def check_rows(self, n: int) -> None:
        """Raise ValueError unless the groups cover exactly ``n`` rows."""
        if int(self.ptr[-1]) != n or int(self.ptr[0]) != 0:
            raise ValueError(f"the query groups cover rows {int(self.ptr[0])}"
                             f"..{int(self.ptr[-1])}, the data has {n} rows")

    def rows(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(group_of, start, size)``: [n] int64 tensors on the device."""
        if self._rows is None:
            sizes = torch.as_tensor(self.sizes, device=self.device)
            group_of = torch.repeat_interleave(
                torch.arange(self.n_groups, device=self.device), sizes)
            starts = torch.as_tensor(self.ptr[:-1], device=self.device)
            self._rows = (group_of, starts[group_of], sizes[group_of])
        return self._rows

    def argsort(self, key: torch.Tensor) -> torch.Tensor:
        """The permutation sorting the rows by group, then by ``key``
        ascending, ties in row order (``jnp.lexsort((key, group_of))``):
        two stable sorts, so tied keys (every margin in round 0) keep row
        order on every device."""
        group_of = self.rows()[0]
        o = torch.argsort(key, stable=True)
        return o[torch.argsort(group_of[o], stable=True)]


class DMatrix:
    """In-memory dense matrix + metadata, the training/predict input.
    ``device`` defaults to the CUDA card; pass ``device="cpu"`` for the
    plain PyTorch versions. ``feature_types`` marks categorical columns
    with ``"c"``; ``enable_categorical`` concerns only data frames, whose
    adapters are not ported, as in the JAX package. ``feature_weights``
    ([F]) weight the per-tree column sample (``colsample_bytree``).
    ``label_lower_bound`` and ``label_upper_bound`` ([n]) are the censoring
    intervals of ``survival:aft``; like the label they live on the
    matrix's device. ``group`` (sizes) or ``qid`` (one query id per row,
    rows of a query contiguous) sets the query groups of the ranking
    objectives and metrics; weights may then be one per group, stored as
    given."""

    #: the fields of ``set_float_info`` / ``get_float_info``
    _FLOAT_INFO = ("label", "weight", "base_margin", "label_lower_bound",
                   "label_upper_bound", "feature_weights")

    def __init__(self, data: Any, label: Any = None, *, weight: Any = None,
                 base_margin: Any = None, missing: float = np.nan,
                 feature_names: Any = None, feature_types: Any = None,
                 enable_categorical: bool = False,
                 feature_weights: Any = None,
                 label_lower_bound: Any = None, label_upper_bound: Any = None,
                 group: Any = None, qid: Any = None,
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
        self.groups: Optional[QueryGroups] = None
        if group is not None:
            self.set_group(group)
        if qid is not None:
            self._set_qid(qid)
        # by max_bin, and "exact" for the exact candidate set
        self._binned: Dict[Union[int, str], BinnedMatrix] = {}

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

    # ---- query groups (the JAX package's ``set_group`` / ``*_uint_info``) ----
    def set_group(self, group: Any) -> None:
        """Query groups from their sizes, in row order."""
        self.groups = QueryGroups(
            _group_ptr_from_sizes(np.asarray(group, dtype=np.int64)),
            self.device)

    def _set_qid(self, qid: Any) -> None:
        """Query groups from one query id per row."""
        self.groups = QueryGroups(_group_ptr_from_qid(np.asarray(qid)),
                                  self.device)

    @property
    def group_ptr(self) -> Optional[np.ndarray]:
        """[G+1] int64 group pointer on the host, or None."""
        return None if self.groups is None else self.groups.ptr

    def get_group(self) -> np.ndarray:
        """Per-group sizes (the inverse of ``set_group``)."""
        if self.groups is None:
            return np.array([], np.int64)
        return self.groups.sizes.copy()

    def set_uint_info(self, field: str, data: Any) -> None:
        if field == "group_ptr":
            self.groups = QueryGroups(data, self.device)
        elif field == "group":
            self.set_group(data)
        else:
            raise ValueError(f"unknown uint field: {field!r}")

    def get_uint_info(self, field: str) -> np.ndarray:
        """``"group"`` and ``"group_ptr"`` both give the group pointer as
        uint32, as the JAX package's do."""
        if field in ("group_ptr", "group"):
            gp = self.group_ptr
            return (np.asarray(gp, np.uint32) if gp is not None
                    else np.array([], np.uint32))
        raise ValueError(f"unknown uint field: {field!r}")

    def set_info(self, *, label=None, weight=None, base_margin=None,
                 group=None, qid=None, label_lower_bound=None,
                 label_upper_bound=None, feature_names=None,
                 feature_types=None, feature_weights=None) -> None:
        """Set any of the metadata at once (the JAX package's
        ``set_info``); None leaves a field as it is."""
        if label is not None:
            self.set_label(label)
        if weight is not None:
            self.set_weight(weight)
        if base_margin is not None:
            self.set_base_margin(base_margin)
        if group is not None:
            self.set_group(group)
        if qid is not None:
            self._set_qid(qid)
        for field, v in (("label_lower_bound", label_lower_bound),
                         ("label_upper_bound", label_upper_bound),
                         ("feature_weights", feature_weights)):
            if v is not None:
                self.set_float_info(field, v)
        if feature_names is not None:
            self.feature_names = list(feature_names)
        if feature_types is not None:
            self.feature_types = list(feature_types)

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

    def slice(self, rindex: Any, allow_groups: bool = False) -> "DMatrix":
        """A new DMatrix of the selected rows on the same device, with
        label, weight, base margin, label bounds and feature metadata
        sliced along; its bins are built anew on first use (the JAX
        package's ``DMatrix.slice``); the feature weights are kept.
        ``rindex`` is an integer index array or a boolean row mask;
        out-of-range indices raise IndexError. Query groups do not survive
        a row slice: a grouped matrix raises ValueError unless
        ``allow_groups`` drops them."""
        rindex = np.asarray(rindex)
        if rindex.dtype == np.bool_:
            rindex = np.nonzero(rindex)[0]
        rindex = rindex.astype(np.int64).ravel()
        n = self.num_row()
        if rindex.size and (rindex.min() < -n or rindex.max() >= n):
            raise IndexError(
                f"slice index out of range for {n} rows: "
                f"[{rindex.min()}, {rindex.max()}]")
        if self.groups is not None and not allow_groups:
            raise ValueError(
                "slice does not support group structure; pass "
                "allow_groups=True to drop it")
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
        out.groups = None
        out._binned = {}
        return out

    def num_row(self) -> int:
        return int(self.data.shape[0])

    def num_nonmissing(self) -> int:
        """The number of present (non-NaN) values."""
        return int((~torch.isnan(self.data)).sum())

    def get_data(self):
        """The feature matrix as a scipy CSR matrix on the host, the
        missing values left out (reference ``DMatrix.get_data``)."""
        import scipy.sparse as sp

        X = self.data.cpu().numpy()
        mask = ~np.isnan(X)
        return sp.csr_matrix(np.where(mask, X, 0.0) * mask)

    def num_col(self) -> int:
        return int(self.data.shape[1])

    def categorical_features(self) -> List[int]:
        ft = self.feature_types
        if not ft:
            return []
        return [i for i, t in enumerate(ft) if t in ("c", "categorical")]

    def get_binned(self, max_bin: int = 256,
                   sketch_weights: Optional[torch.Tensor] = None
                   ) -> BinnedMatrix:
        """Build-or-fetch the quantized matrix for this ``max_bin``
        (``build_binned`` at the first call, cached by ``max_bin``); the
        sketch is weighted by ``sketch_weights``, else by the row weights,
        as the JAX package's learner asks for it. Weights that are not one
        per row (a ranking matrix's per-group weights) raise ValueError at
        this first build, as the JAX package's sketch does; bins built
        before such weights were set stay cached and usable."""
        bm = self._binned.get(max_bin)
        if bm is None:
            bm = self.build_binned(max_bin, sketch_weights)
            self._binned[max_bin] = bm
        return bm

    def build_binned(self, max_bin: int = 256,
                     sketch_weights: Optional[torch.Tensor] = None
                     ) -> BinnedMatrix:
        """An uncached quantized matrix (the JAX package's
        ``build_binned``): ``tree_method="approx"`` builds one every round,
        sketched with that round's hessians as ``sketch_weights`` ([n], on
        the matrix's device; default the row weights). With weights, or
        more than 2^24 rows, the sketch's prefix sum runs on the host even
        for a CUDA matrix (see ``compute_cuts``). Categorical features are
        checked (``_validate_categorical``) and get identity cuts."""
        n = self.num_row()
        w = self.weight if sketch_weights is None else sketch_weights
        if w is not None and w.numel() not in (0, n):
            raise ValueError(f"the sketch takes one weight per row: "
                             f"{w.numel()} weights for {n} rows")
        cat = self.categorical_features()
        if cat:
            self._validate_categorical(cat, max_bin)
        return BinnedMatrix.from_dense(self.data, max_bin=max_bin, weights=w,
                                       categorical=cat)

    def get_binned_exact(self, cap: int = 16384) -> BinnedMatrix:
        """The quantized matrix with a cut at every distinct value, the
        candidate set ``tree_method="exact"`` trains on
        (``quantile.compute_exact_cuts``), cached under its own key. Its
        width is the widest feature's distinct count plus one, so its bins
        are int16 up to 32,766 (``storage_dtype``)."""
        bm = self._binned.get("exact")
        if bm is None:
            cat = self.categorical_features()
            cuts = compute_exact_cuts(self.data, cap=cap, categorical=cat)
            if cat:
                self._validate_categorical(cat, cuts.max_bin)
            bm = BinnedMatrix.from_dense(self.data, max_bin=cuts.max_bin,
                                         cuts=cuts, categorical=cat)
            self._binned["exact"] = bm
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
