"""Streaming ingestion: DataIter callbacks -> quantized matrix in 2 passes.

The port of the JAX package's ``data/iterator.py`` (reference ``DataIter``,
``python-package/xgboost/core.py:311``, feeding
``IterativeDeviceDMatrix::Initialize``, ``iterative_device_dmatrix.h:81``):
pass 1 summarizes every batch on the matrix's device into a fixed-size
quantile summary (``sketch.local_summary``) and drops its floats; the
summaries merge into the cuts (``sketch.merge_summaries``); pass 2 bins
every batch on arrival. Only the narrow-int bins are kept, on the device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from .adapters import dispatch_data
from .dmatrix import DMatrix, QueryGroups, _group_ptr_from_qid
from .quantile import BinnedMatrix, HistogramCuts, bin_matrix
from .sketch import local_summary, merge_summaries

__all__ = ["DataIter", "StreamingQuantileDMatrix"]


class DataIter:
    """User-subclassed batch iterator (reference core.py:311): implement
    ``next(input_data)``, calling ``input_data(data=..., label=..., ...)``
    once per batch and returning 1, or returning 0 at the end; and
    ``reset()`` to rewind."""

    def __init__(self, cache_prefix: Optional[str] = None):
        self.cache_prefix = cache_prefix

    def reset(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def next(self, input_data) -> int:  # pragma: no cover - interface
        raise NotImplementedError


def _batch_reader(missing: float) -> Tuple[Callable[..., int], List[dict]]:
    """``(input_data, slot)``: the callback a ``DataIter`` calls, which
    puts the batch's float32 rows (``dispatch_data``) and its metadata in
    ``slot``, one batch at a time."""
    slot: List[dict] = []

    def input_data(data=None, label=None, weight=None, base_margin=None,
                   group=None, qid=None, **kw):
        X, *_ = dispatch_data(data, missing=missing)
        slot.append({"X": X, "label": label, "weight": weight,
                     "base_margin": base_margin, "qid": qid})
        return 1

    return input_data, slot


def sketch_batches(it: DataIter, max_bin: int, missing: float,
                   device: torch.device
                   ) -> Tuple[HistogramCuts, List[dict], int]:
    """Pass 1: every batch summarized on ``device``, its floats dropped;
    returns ``(cuts, the batches' metadata, the feature count)``. Raises
    when the iterator yields nothing."""
    input_data, slot = _batch_reader(missing)
    it.reset()
    parts: List[Tuple[torch.Tensor, ...]] = []
    meta: List[dict] = []
    F = 0
    while it.next(input_data):
        b = slot.pop()
        X = b.pop("X")
        F = X.shape[1]
        w = b["weight"]
        parts.append(local_summary(
            torch.as_tensor(X, device=device),
            None if w is None else torch.as_tensor(
                np.asarray(w, np.float32), device=device), max_bin))
        b["rows"] = X.shape[0]
        meta.append(b)
        del X
    if not meta:
        raise ValueError("DataIter produced no batches")
    cuts, mins = merge_summaries(*(torch.stack(p) for p in zip(*parts)),
                                 max_bin)
    return (HistogramCuts(values=cuts.cpu().numpy(),
                          min_vals=mins.cpu().numpy()), meta, F)


def bin_batches(it: DataIter, cuts: HistogramCuts, missing: float,
                device: torch.device, n_batches: int, message: str):
    """Pass 2: yield each batch's bins ([rows, F] on ``device``); raises
    ValueError with ``message`` when the iterator does not yield the
    ``n_batches`` batches of pass 1."""
    input_data, slot = _batch_reader(missing)
    it.reset()
    n2 = 0
    while it.next(input_data):
        yield bin_matrix(torch.as_tensor(slot.pop()["X"], device=device),
                         cuts)
        n2 += 1
    if n2 != n_batches:
        raise ValueError(message.format(n2=n2, n1=n_batches))


def set_batch_meta(dmat: DMatrix, meta: List[dict]) -> None:
    """The batches' labels, weights and base margins, concatenated, and
    their query ids as groups (the JAX package's rule: a field set in some
    batches only is the concatenation of those)."""
    for field in ("label", "weight", "base_margin"):
        parts = [b[field] for b in meta if b[field] is not None]
        if parts:
            dmat.set_float_info(field, np.concatenate(
                [np.asarray(p, np.float32) for p in parts]))
    qparts = [b["qid"] for b in meta if b["qid"] is not None]
    if qparts:
        dmat.groups = QueryGroups(_group_ptr_from_qid(np.concatenate(qparts)),
                                  dmat.device)


class StreamingQuantileDMatrix(DMatrix):
    """A quantized matrix built from a ``DataIter`` without concatenating
    the raw batches (2 passes: sketch, then bin); the bins live on
    ``device``. ``data`` is rebuilt from the bins."""

    #: ``data`` is rebuilt from the bins (see ``DMatrix``)
    data_is_reconstructed = True

    def __init__(self, it: DataIter, *, max_bin: int = 256,
                 missing: float = np.nan,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self._init_meta(device)
        self.max_bin = max_bin
        cuts, meta, _ = sketch_batches(it, max_bin, missing, self.device)
        bins = torch.cat(list(bin_batches(
            it, cuts, missing, self.device, len(meta),
            "DataIter yielded {n2} batches on the second pass vs {n1} on "
            "the first — the iterator must be deterministic across reset() "
            "for 2-pass ingestion")))
        set_batch_meta(self, meta)
        self._binned[max_bin] = BinnedMatrix(
            cuts=cuts, bins=bins,
            cut_values=torch.as_tensor(cuts.values, device=self.device))

    @property
    def data(self) -> torch.Tensor:
        """Feature values rebuilt from the bins (reference
        ``EllpackDeviceAccessor::GetFvalue``, ellpack_page.cuh:119): bin
        ``k`` of feature ``f`` is its lower cut edge (``min_vals[f]`` for
        bin 0), the missing bin NaN; made on the device at first use."""
        if self._data is None:
            bm = self._binned[self.max_bin]
            cuts, B = bm.cuts, bm.cuts.max_bin
            lower = np.concatenate([cuts.min_vals[:, None],
                                    cuts.values[:, :-1]], axis=1)
            lower = torch.as_tensor(lower, device=self.device)
            k = bm.bins.long()
            F = k.shape[1]
            x = lower[torch.arange(F, device=self.device)[None, :],
                      k.clamp(max=B - 1)]
            self._data = torch.where(k >= B, torch.full_like(x, np.nan), x)
        return self._data

    def num_row(self) -> int:
        return int(self._binned[self.max_bin].bins.shape[0])

    def num_col(self) -> int:
        return int(self._binned[self.max_bin].bins.shape[1])
