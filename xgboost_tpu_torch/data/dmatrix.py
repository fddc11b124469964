"""DMatrix: data + labels, weights and base margins on one device.

The port of the JAX package's ``data/dmatrix.py`` (reference
``include/xgboost/data.h:47-185`` MetaInfo, ``python-package/xgboost/
core.py:501`` DMatrix). Dense input lives on the DMatrix's device as
[n, F] float32 with NaN for missing; scipy input stays a host CSR
(``sparse.CSRStorage``) until a reader of raw values asks for ``data``.
Every other input goes through ``adapters.dispatch_data``: pandas frames
and arrow tables, lists, and libsvm / csv / binary file URIs. The
quantized view (``BinnedMatrix``, the ELLPACK analog) is built on first use
and cached per ``max_bin`` (and once for the exact candidate set);
``build_binned`` makes an uncached one, as ``tree_method="approx"`` does
every round; ``QuantileDMatrix`` bins at construction, on a reference
matrix's cuts where given. Features whose ``feature_types`` entry is
``"c"`` (or ``"categorical"``) hold integer category codes and are binned
one bin per category. Ranking matrices carry query groups (``group`` sizes
or ``qid`` per row): the CSR pointer stays on the host as in the JAX
package, and the per-row tensors the ranking objective and metrics read
are built from it once, on the matrix's device (``QueryGroups``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from .adapters import dispatch_data
from .quantile import (BinnedMatrix, HistogramCuts, apply_categorical_identity,
                       compute_exact_cuts)
from .sparse import CSRStorage

__all__ = ["DMatrix", "QuantileDMatrix", "QueryGroups", "load_row_split"]


def _looks_binary(uri: str) -> bool:
    path, _, fmt = uri.partition("?format=")
    return fmt == "binary" or path.endswith((".buffer", ".npz"))


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
    """In-memory matrix + metadata, the training/predict input. ``device``
    defaults to the CUDA card; pass ``device="cpu"`` for the plain PyTorch
    versions. ``data`` is what ``adapters.dispatch_data`` takes: numpy or
    torch arrays, lists, pandas frames (categorical columns as their codes
    with ``enable_categorical``; ``feature_names`` and ``feature_types``
    from the frame), arrow tables, and libsvm (with ``qid:``), csv and
    binary (``save_binary``) file URIs, which also carry the label. scipy
    sparse input (CSR, CSC, COO) stays sparse on the host
    (``sparse.CSRStorage``): it is binned from column blocks and walked in
    row blocks, and the dense ``data`` is made only when a reader asks for
    it. ``feature_types`` marks categorical columns with ``"c"``.
    ``feature_weights`` ([F]) weight the per-tree column sample
    (``colsample_bytree``). ``label_lower_bound`` and ``label_upper_bound``
    ([n]) are the censoring intervals of ``survival:aft``; like the label
    they live on the matrix's device. ``group`` (sizes) or ``qid`` (one
    query id per row, rows of a query contiguous) sets the query groups of
    the ranking objectives and metrics; weights may then be one per group,
    stored as given."""

    #: the fields of ``set_float_info`` / ``get_float_info``
    _FLOAT_INFO = ("label", "weight", "base_margin", "label_lower_bound",
                   "label_upper_bound", "feature_weights")
    #: host CSR of sparse input, and the dense data once made (class
    #: defaults, so matrices built without ``__init__`` read None)
    _sparse: Optional[CSRStorage] = None
    _data: Optional[torch.Tensor] = None
    #: ``data`` holds values rebuilt from bins, not the input's: readers
    #: that need the raw values (the local histmaker) refuse the matrix
    data_is_reconstructed = False

    def __init__(self, data: Any, label: Any = None, *, weight: Any = None,
                 base_margin: Any = None, missing: float = np.nan,
                 feature_names: Any = None, feature_types: Any = None,
                 enable_categorical: bool = False,
                 feature_weights: Any = None,
                 label_lower_bound: Any = None, label_upper_bound: Any = None,
                 group: Any = None, qid: Any = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self._init_meta(device)
        if isinstance(data, (str, os.PathLike)) and _looks_binary(
                os.fspath(data)):
            self._load_binary(os.fspath(data))
        elif hasattr(data, "tocsr") and hasattr(data, "nnz"):
            self._sparse = CSRStorage(data, missing)
        else:
            if isinstance(data, torch.Tensor):
                data = data.cpu().numpy()
            X, names, types, auto_label, auto_qid = dispatch_data(
                data, missing=missing, enable_categorical=enable_categorical)
            if X.ndim != 2:
                raise ValueError(f"data must be 2-D, got shape {X.shape}")
            self._data = torch.as_tensor(np.ascontiguousarray(X),
                                         device=self.device)
            self.feature_names = names
            self.feature_types = types
            label = auto_label if label is None else label
            qid = auto_qid if qid is None else qid
        self.set_info(label=label, weight=weight, base_margin=base_margin,
                      group=group, qid=qid,
                      label_lower_bound=label_lower_bound,
                      label_upper_bound=label_upper_bound,
                      feature_names=feature_names or None,
                      feature_types=feature_types or None,
                      feature_weights=feature_weights)

    def _init_meta(self, device) -> None:
        """Every field unset, on ``device`` (for subclasses too)."""
        self.device = resolve_device(device)
        self.feature_names: Optional[List[str]] = None
        self.feature_types: Optional[List[str]] = None
        for name in self._FLOAT_INFO:
            setattr(self, name, None)
        self.groups: Optional[QueryGroups] = None
        # by max_bin, and "exact" for the exact candidate set
        self._binned: Dict[Union[int, str], BinnedMatrix] = {}

    @property
    def data(self) -> torch.Tensor:
        """[n, F] float32 with NaN missing, on the matrix's device. A
        CSR-backed matrix densifies here at the first touch and keeps the
        result (the JAX package's ``DMatrix.data``); training on bins and
        batch prediction never touch it, the readers of raw values (SHAP,
        the linear booster, refresh, the local histmaker, approx and exact
        sketches) do."""
        if self._data is None and self._sparse is not None:
            self._data = torch.as_tensor(self._sparse.toarray(),
                                         device=self.device)
        return self._data

    @data.setter
    def data(self, X: torch.Tensor) -> None:
        self._data, self._sparse = X, None

    def _csr_only(self) -> bool:
        """Sparse input whose dense data has not been made."""
        return self._sparse is not None and self._data is None

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
        if self._csr_only():  # stays sparse
            out._sparse = self._sparse.slice_rows(rindex)
        else:
            out._data = self.data[idx]
        for name in ("label", "weight", "base_margin", "label_lower_bound",
                     "label_upper_bound"):
            v = getattr(self, name)
            setattr(out, name, None if v is None else v[idx])
        out.groups = None
        out._binned = {}
        return out

    def num_row(self) -> int:
        if self._csr_only():
            return int(self._sparse.shape[0])
        return int(self.data.shape[0])

    def num_col(self) -> int:
        if self._csr_only():
            return int(self._sparse.shape[1])
        return int(self.data.shape[1])

    def num_nonmissing(self) -> int:
        """The number of present (non-NaN) values."""
        if self._csr_only():
            return self._sparse.nnz
        return int((~torch.isnan(self.data)).sum())

    def get_data(self):
        """The feature matrix as a scipy CSR matrix on the host, the
        missing values left out (reference ``DMatrix.get_data``); a copy of
        the CSR a sparse matrix was made from."""
        import scipy.sparse as sp

        if self._csr_only():
            return sp.csr_matrix(self._sparse.csr, copy=True)
        X = self.data.cpu().numpy()
        mask = ~np.isnan(X)
        return sp.csr_matrix(np.where(mask, X, 0.0) * mask)

    # ---- binary files (the JAX package's npz layout) ----
    def save_binary(self, fname, silent: bool = True) -> None:
        """Data and metadata for ``DMatrix(fname)`` (the reference's
        .buffer files): the JAX package's npz container, key for key
        (``data``, the set metadata fields, ``feature_names`` and
        ``feature_types``, an empty array meaning unset), so either package
        reads the other's files. Written through an open handle, so the
        file is exactly ``fname``."""
        fields = {"data": self.data.cpu().numpy().astype(np.float32)}
        for name in ("label", "weight", "base_margin", "group_ptr",
                     "label_lower_bound", "label_upper_bound",
                     "feature_weights"):
            v = getattr(self, name)
            if v is not None:
                fields[name] = np.asarray(
                    v.cpu().numpy() if torch.is_tensor(v) else v)
        fields["feature_names"] = np.asarray(
            [str(n) for n in (self.feature_names or [])])
        fields["feature_types"] = np.asarray(
            [str(t) for t in (self.feature_types or [])])
        with open(fname, "wb") as fh:
            np.savez(fh, **fields)

    def _load_binary(self, uri: str) -> None:
        """Restore a ``save_binary`` container (either package's): the data
        and every metadata field it holds; an absent or empty field stays
        unset."""
        path = uri.partition("?format=")[0]
        with np.load(path, allow_pickle=False) as z:
            self._data = torch.as_tensor(z["data"].astype(np.float32),
                                         device=self.device)
            have = {k: z[k] for k in z.files if z[k].size}
        if "group_ptr" in have:
            self.groups = QueryGroups(have["group_ptr"], self.device)
        for name in self._FLOAT_INFO:
            if name in have:
                self.set_float_info(name, have[name])
        names = [str(x) for x in have.get("feature_names", [])]
        types = [str(x) for x in have.get("feature_types", [])]
        self.feature_names, self.feature_types = names or None, types or None

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
            from ..observability import trace

            # one span per cold construction (sketch + quantize): the data
            # plane's ingest cost; a cache hit pays nothing
            with trace.span("dmatrix_build", rows=self.num_row(),
                            features=self.num_col(), max_bin=max_bin):
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
        checked (``_validate_categorical``) and get identity cuts. Under an
        active row group of several ranks (``parallel.collective_active``)
        the cuts come from the distributed sketch over every rank's rows
        (``parallel/sketch.py``), a CSR matrix made dense on its device
        first (the JAX package's ``build_binned`` under a mesh)."""
        from ..parallel.mesh import collective_active, current_mesh

        n = self.num_row()
        w = self.weight if sketch_weights is None else sketch_weights
        if w is not None and w.numel() not in (0, n):
            raise ValueError(f"the sketch takes one weight per row: "
                             f"{w.numel()} weights for {n} rows")
        cat = self.categorical_features()
        if cat:
            self._validate_categorical(cat, max_bin)
        if collective_active():
            from ..parallel.sketch import distributed_compute_cuts

            X = self.data
            cuts = distributed_compute_cuts(
                current_mesh(), X, max_bin,
                w if w is not None and w.numel() else None)
            if cat:
                apply_categorical_identity(cuts.values, cuts.min_vals, cat)
            return BinnedMatrix.from_dense(X, max_bin=max_bin, cuts=cuts,
                                           categorical=cat)
        if self._csr_only():
            return BinnedMatrix.from_sparse(self._sparse, max_bin=max_bin,
                                            weights=w, categorical=cat,
                                            device=self.device)
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
            from ..parallel.mesh import collective_active

            if collective_active():
                raise NotImplementedError(
                    "tree_method='exact' is single-process only (each "
                    "process sees only its row shard, so globally exact "
                    "cuts cannot be built); use tpu_hist")
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
        InvalidCat). The messages are the JAX package's. A CSR-backed
        matrix reads the columns' stored values, without densifying."""
        if self._csr_only():
            col = torch.full((max(len(v) for v in map(
                self._sparse.column_values, cat)), len(cat)), float("nan"))
            for j, f in enumerate(cat):
                v = self._sparse.column_values(f)
                col[:len(v), j] = torch.from_numpy(v)
        else:
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


class QuantileDMatrix(DMatrix):
    """A DMatrix binned at construction (reference ``QuantileDMatrix``; the
    JAX package's): its own sketch at ``max_bin``, or, with ``ref``, the
    cuts and categorical features of ``ref``'s first binned matrix, so a
    validation set shares the training matrix's bin edges. CSR input is
    binned from column blocks and stays sparse. Without ``ref``, under an
    active row group of several ranks, the cuts come from the distributed
    sketch (``build_binned``); with ``ref``, every rank bins against
    ``ref``'s cuts."""

    def __init__(self, data: Any, label: Any = None, *, max_bin: int = 256,
                 ref: Optional[DMatrix] = None, **kwargs: Any) -> None:
        super().__init__(data, label, **kwargs)
        self.max_bin = max_bin
        cuts: Optional[HistogramCuts] = None
        cat = self.categorical_features()
        if ref is not None and ref._binned:
            ref_bm = next(iter(ref._binned.values()))
            cuts = ref_bm.cuts
            if not cat:
                cat = list(ref_bm.categorical)
        from ..parallel.mesh import collective_active

        if cuts is None and collective_active():
            bm = self.build_binned(max_bin)
        elif self._csr_only():
            bm = BinnedMatrix.from_sparse(
                self._sparse, max_bin=max_bin, weights=self.weight,
                cuts=cuts, categorical=cat, device=self.device)
        else:
            bm = BinnedMatrix.from_dense(self.data, max_bin=max_bin,
                                         weights=self.weight, cuts=cuts,
                                         categorical=cat)
        self._binned[max_bin] = bm


def load_row_split(uri, rank: int, world: int, **kwargs) -> DMatrix:
    """Rank ``rank``'s rows of a dataset split ``world`` ways, round robin
    (rows ``rank, rank + world, ...``; the JAX package's
    ``load_row_split``, reference ``DMatrix::Load(..., load_row_split)``).
    Grouped (ranking) data raises, as ``slice`` refuses groups: shard it
    by query instead."""
    if not (0 <= rank < world):
        raise ValueError(f"rank {rank} outside [0, {world})")
    d = DMatrix(uri, **kwargs)
    if world == 1:
        return d
    out = d.slice(np.arange(rank, d.num_row(), world))
    if d.groups is not None and d.groups.n_groups > 1:
        raise ValueError(
            "load_row_split cannot split grouped (ranking) data; "
            "shard by query group instead")
    return out
