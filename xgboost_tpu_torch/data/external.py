"""External-memory (out-of-core) DMatrix: disk-backed quantized pages.

The port of the JAX package's ``data/external.py`` (reference
``SparsePageDMatrix``, ``sparse_page_source.h:80-120``). Ingestion makes
two passes over a ``DataIter`` (``iterator.py``): the batches' summaries
give the cuts, then each batch is binned on the matrix's device and spilled
to fixed-row pages ``prefix.page{k}.bin``, bit-packed at
``ceil(log2(B+1))`` bits a symbol, the JAX package's bytes. Training
(``tree/grow_fused.py:grow_tree_fused_paged``) streams the pages every
level: one background slot reads the next page while the current one is
on the device. Pages are written and read by the native page cache
(``native/pagecache.cpp``, as in the JAX package): its ring of 4 slots
reads ahead in page order on a thread of its own. The bytes go to the
device packed and are unpacked there (``device_page``); the host unpack
(``read_page``) is the JAX package's.
Device memory holds one page of bins and every page's row positions;
labels, weights and margins stay in memory.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import native
from ..resilience import chaos, policy
from .dmatrix import DMatrix
from .iterator import DataIter, bin_batches, set_batch_meta, sketch_batches
from .quantile import HistogramCuts, storage_dtype

__all__ = ["ExternalMemoryQuantileDMatrix", "PagedBins", "pack_symbols",
           "unpack_symbols"]


def _symbol_bits(n_symbols: int) -> int:
    """Bits per stored symbol: ``ceil(log2(n_symbols))`` (reference
    ``common/compressed_iterator.h`` SymbolBits)."""
    return max(1, int(np.ceil(np.log2(max(n_symbols, 2)))))


def pack_symbols(arr: np.ndarray, bits: int) -> np.ndarray:
    """Integers below ``2^bits`` -> a little-endian bitstream of ``bits``
    bits each (reference ``CompressedBufferWriter``,
    compressed_iterator.h:85): symbol ``i`` holds stream bits ``i*bits``
    on, bit ``k`` of the stream is bit ``k % 8`` of byte ``k // 8``."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    nbytes = flat.dtype.itemsize
    as_bytes = flat.astype(f"<u{nbytes}").view(np.uint8).reshape(-1, nbytes)
    bit_rows = np.unpackbits(as_bytes, axis=1, bitorder="little")[:, :bits]
    return np.packbits(bit_rows.reshape(-1), bitorder="little")


def unpack_symbols(packed: np.ndarray, bits: int, count: int,
                   dtype) -> np.ndarray:
    """The first ``count`` symbols of a ``pack_symbols`` stream, on the
    host, as ``dtype``."""
    dt = np.dtype(dtype)
    bit_rows = np.unpackbits(packed, bitorder="little",
                             count=count * bits).reshape(count, bits)
    width = dt.itemsize * 8
    if bits != width:
        bit_rows = np.concatenate(
            [bit_rows, np.zeros((count, width - bits), np.uint8)], axis=1)
    as_bytes = np.packbits(bit_rows.reshape(-1), bitorder="little")
    return as_bytes.view(f"<u{dt.itemsize}").astype(dt, copy=False)


def unpack_symbols_torch(packed: torch.Tensor, bits: int, count: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """``unpack_symbols`` on ``packed``'s device (uint8, ``bits`` <= 24):
    eight symbols take exactly ``bits`` bytes, so each of the eight
    positions is read from fixed byte columns, with no gather."""
    groups = -(-count // 8)
    P = torch.zeros(groups * bits + 3, dtype=torch.uint8,
                    device=packed.device)
    P[:packed.numel()] = packed[:groups * bits]
    P = P.to(torch.int32)
    out = torch.empty((groups, 8), dtype=torch.int32, device=packed.device)
    mask = (1 << bits) - 1
    for j in range(8):
        b0, s = (j * bits) >> 3, (j * bits) & 7
        w = P[b0:b0 + groups * bits:bits]
        for i in range(1, (s + bits + 7) >> 3):
            w = w | (P[b0 + i:b0 + i + groups * bits:bits] << (8 * i))
        out[:, j] = (w >> s) & mask
    return out.view(-1)[:count].to(dtype)


class PagedBins:
    """Disk-backed quantized matrix: pages of ``[page_rows, F]`` bins (the
    last one shorter), ``cuts.max_bin`` the missing bin, in files
    ``prefix.page{k}.bin`` written and read through ``pagecache.cpp``
    (``pc_write``; ``pc_read`` from a ring of 4 prefetched pages, opened at
    the first read). ``io`` sums the seconds spent
    reading (``read_s``, on whichever thread read), waiting for a
    prefetched read (``wait_s``) and unpacking on the host (``unpack_s``),
    and counts the reads (``reads``, ``prefetched``)."""

    #: the boosters' paged branch keys off this marker
    is_paged = True
    categorical: tuple = ()
    cat_counts: tuple = ()

    def __init__(self, prefix: str, cuts: HistogramCuts, n_rows: int,
                 n_features: int, page_rows: int, dtype) -> None:
        self.prefix = prefix
        self.cuts = cuts
        self.n_rows = n_rows
        self.n_features = n_features
        self.page_rows = page_rows
        self.dtype = np.dtype(dtype)
        self.n_pages = -(-n_rows // page_rows)
        # bin ids 0..max_bin, the missing bin included; packing is skipped
        # where it would not shrink the page
        self.bits = _symbol_bits(cuts.max_bin + 1)
        self.packed = self.bits < 8 * self.dtype.itemsize
        self._pf: Optional[Tuple[int, Any]] = None
        self._ring: Optional[int] = None  # the native reader's handle
        self._ring_lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._mid: Optional[np.ndarray] = None
        self._mid_t: Dict[torch.device, torch.Tensor] = {}
        self.io: Dict[str, float] = dict(read_s=0.0, wait_s=0.0,
                                         unpack_s=0.0, reads=0, prefetched=0)

    def rows_of(self, k: int) -> int:
        return min(self.page_rows, self.n_rows - k * self.page_rows)

    def page_path(self, k: int) -> str:
        return f"{self.prefix}.page{k}.bin"

    def page_bytes(self, k: int) -> int:
        """On-disk byte size of page ``k`` (packed or raw)."""
        n_sym = self.rows_of(k) * self.n_features
        if self.packed:
            return (n_sym * self.bits + 7) // 8
        return n_sym * self.dtype.itemsize

    def write_page(self, k: int, bins: np.ndarray) -> None:
        """Write page ``k`` with ``pc_write``: the ``pager_io`` site, its
        transient failures retried (``RetryPolicy("pager_io", retries=2)``,
        ``XGBTPU_RETRY``) as the JAX package's spill does. Open readers
        are closed first, so no ring slot keeps the page's old bytes."""
        lib = native.pagecache()
        arr = np.ascontiguousarray(bins, self.dtype)
        out = pack_symbols(arr, self.bits) if self.packed else arr
        self.close()

        def write_once() -> None:
            chaos.hit("pager_io")
            rc = lib.pc_write(os.fsencode(self.page_path(k)),
                              out.ctypes.data, out.nbytes)
            if rc:
                raise OSError(f"{self.page_path(k)}: pc_write failed ({rc})")

        policy.RetryPolicy("pager_io", retries=2).run(write_once)

    def _reader(self) -> int:
        """The native reader over every page (``pc_open``, a ring of 4),
        opened at the first read."""
        with self._ring_lock:
            if self._ring is None:
                lib = native.pagecache()
                sizes = (ctypes.c_longlong * self.n_pages)(
                    *[self.page_bytes(k) for k in range(self.n_pages)])
                self._ring = lib.pc_open(os.fsencode(self.prefix),
                                         self.n_pages, sizes, 4)
            return self._ring

    def _close_ring(self) -> None:
        with self._ring_lock:
            if self._ring is not None:
                native.pagecache().pc_close(self._ring)
                self._ring = None

    def _read_raw(self, k: int) -> np.ndarray:
        """Page ``k``'s bytes from the native reader under the
        ``pager_io`` retry policy (on the caller's thread or the prefetch
        worker alike)."""
        ring = self._reader()
        return policy.RetryPolicy("pager_io", retries=2).run(
            self._read_once, ring, k)

    def _read_once(self, ring: int, k: int) -> np.ndarray:
        chaos.hit("pager_io")
        raw = np.empty(self.page_bytes(k), np.uint8)
        t0 = time.perf_counter()
        rc = native.pagecache().pc_read(ring, k, raw.ctypes.data)
        self.io["read_s"] += time.perf_counter() - t0
        self.io["reads"] += 1
        if rc or os.path.getsize(self.page_path(k)) != raw.size:
            raise OSError(f"{self.page_path(k)}: pc_read returned {rc}; the "
                          f"page file must hold {raw.size} bytes")
        return raw

    def start_prefetch(self, k: int) -> None:
        """Begin reading page ``k`` on the background worker, without
        blocking; the next read of page ``k`` takes the result. One slot:
        a call while a read is in flight, or for a ``k`` out of range,
        does nothing."""
        if self._pf is not None or not 0 <= k < self.n_pages:
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="xgbt-page-prefetch")
        self._pf = (k, self._pool.submit(self._read_raw, k))

    def _raw(self, k: int) -> np.ndarray:
        """Page ``k``'s bytes: the prefetched read when it is page ``k``
        (a read for another page is dropped), else a read here. A
        prefetched read's failure (its retries spent) surfaces here, with
        ``page = k`` set on the exception."""
        pf, self._pf = self._pf, None
        if pf is not None and pf[0] == k:
            t0 = time.perf_counter()
            try:
                raw = pf[1].result()
            except Exception as e:
                e.page = k
                raise
            self.io["wait_s"] += time.perf_counter() - t0
            self.io["prefetched"] += 1
            return raw
        if pf is not None:
            pf[1].cancel()
        return self._read_raw(k)

    def read_page(self, k: int) -> np.ndarray:
        """``[rows_of(k), F]`` bins of page ``k`` on the host, unpacked
        with numpy (the JAX package's ``read_page``)."""
        raw = self._raw(k)
        rows = self.rows_of(k)
        if not self.packed:
            return raw.view(self.dtype).reshape(rows, self.n_features)
        t0 = time.perf_counter()
        out = unpack_symbols(raw, self.bits, rows * self.n_features,
                             self.dtype).reshape(rows, self.n_features)
        self.io["unpack_s"] += time.perf_counter() - t0
        return out

    def device_page(self, k: int, device: Union[str, torch.device]
                    ) -> torch.Tensor:
        """``[rows_of(k), F]`` bins of page ``k`` on ``device`` in the
        port's storage type (``storage_dtype``): the bytes as read go to
        the device (packed: ``bits / 8`` of a byte a bin) and are unpacked
        there (``unpack_symbols_torch``). The copy is a plain pageable
        ``.to(device)``."""
        raw = torch.from_numpy(self._raw(k)).to(device)
        rows = self.rows_of(k)
        tdt = storage_dtype(self.cuts.max_bin)
        if not self.packed:
            return raw.view(tdt).view(rows, self.n_features)
        return unpack_symbols_torch(raw, self.bits, rows * self.n_features,
                                    tdt).view(rows, self.n_features)

    def midpoints(self) -> np.ndarray:
        """``[F, B]`` float32: the midpoint of each bin's cut interval (its
        lower edge ``min_vals`` for bin 0). A model trained on these cuts
        routes a bin's midpoint as it routed the bin's values, so
        page-streamed prediction is exact for it (the JAX package's
        ``midpoints``)."""
        if self._mid is None:
            v = np.asarray(self.cuts.values, np.float64)
            lo = np.concatenate([np.asarray(self.cuts.min_vals,
                                            np.float64)[:, None], v[:, :-1]],
                                axis=1)
            self._mid = ((lo + v) / 2.0).astype(np.float32)
        return self._mid

    def float_page(self, k: int) -> np.ndarray:
        """``[rows_of(k), F]`` float32 of page ``k`` on the host: each bin's
        midpoint, NaN for the missing bin."""
        bins = self.read_page(k).astype(np.int64)
        mid = self.midpoints()
        B = mid.shape[1]
        x = mid[np.arange(self.n_features)[None, :], np.clip(bins, 0, B - 1)]
        x[bins >= B] = np.nan
        return x

    def device_float_page(self, k: int, device: Union[str, torch.device]
                          ) -> torch.Tensor:
        """``float_page(k)`` made on ``device`` from ``device_page``: the
        same values, gathered there."""
        device = torch.device(device)
        mid = self._mid_t.get(device)
        if mid is None:
            mid = self._mid_t[device] = torch.as_tensor(self.midpoints(),
                                                        device=device)
        bins = self.device_page(k, device).long()
        B = mid.shape[1]
        x = mid[torch.arange(self.n_features, device=device)[None, :],
                bins.clamp(max=B - 1)]
        return torch.where(bins >= B, torch.full_like(x, np.nan), x)

    def close(self) -> None:
        """Stop the prefetch worker and close the native reader."""
        self._pf = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._close_ring()

    def cleanup(self) -> None:
        """Close and delete the cache files (the reference's
        SparsePageDMatrix removes its disk cache on destruction)."""
        self.close()
        for k in range(self.n_pages):
            try:
                os.remove(self.page_path(k))
            except OSError:
                pass

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.cleanup()
        except Exception:
            pass


class ExternalMemoryQuantileDMatrix(DMatrix):
    """Out-of-core quantized matrix: the 2-pass streaming ingest (sketch,
    then bin on ``device``) with the bins spilled to a disk cache of
    ``page_rows``-row pages under ``cache_prefix`` (a new temporary
    directory when None) instead of kept (reference ``SparsePageDMatrix``
    with ``cache_prefix``). It trains with the depthwise ``hist`` grower
    at its own ``max_bin`` only; predict, eval and early stopping stream
    its pages."""

    def __init__(self, it: DataIter, *, cache_prefix: Optional[str] = None,
                 max_bin: int = 256, missing: float = np.nan,
                 page_rows: int = 262_144,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self._init_meta(device)
        self.max_bin = max_bin
        if cache_prefix is None:
            cache_prefix = os.path.join(
                tempfile.mkdtemp(prefix="xgbt_extmem_"), "cache")
        cuts, meta, F = sketch_batches(it, max_bin, missing, self.device)
        n_rows = sum(b["rows"] for b in meta)
        dtype = torch.empty(0, dtype=storage_dtype(max_bin)).numpy().dtype
        paged = PagedBins(cache_prefix, cuts, n_rows, F, page_rows, dtype)
        carry = np.zeros((0, F), paged.dtype)
        page_k = 0
        for part in bin_batches(
                it, cuts, missing, self.device, len(meta),
                "DataIter must be deterministic across reset() for 2-pass "
                "external-memory ingestion"):
            part = part.cpu().numpy()
            carry = part if carry.size == 0 else np.concatenate([carry, part])
            while len(carry) >= page_rows:
                paged.write_page(page_k, carry[:page_rows])
                carry = carry[page_rows:]
                page_k += 1
        if len(carry):
            paged.write_page(page_k, carry)
        self._paged = paged
        set_batch_meta(self, meta)
        self._binned = {max_bin: paged}

    def get_binned(self, max_bin: int = 256, sketch_weights=None):
        if max_bin != self.max_bin:
            raise ValueError(
                f"external-memory matrix was quantized at max_bin="
                f"{self.max_bin}; re-ingest to change it")
        return self._paged

    def build_binned(self, max_bin: int = 256, sketch_weights=None):
        raise NotImplementedError(
            "per-iteration re-sketching (tree_method='approx') needs "
            "in-memory data; external-memory matrices train with tpu_hist")

    def get_binned_exact(self, cap: int = 16384):
        raise NotImplementedError(
            "tree_method='exact' needs in-memory data; external-memory "
            "matrices train with tpu_hist")

    def num_row(self) -> int:
        return self._paged.n_rows

    def num_col(self) -> int:
        return self._paged.n_features

    @property
    def data(self):
        raise NotImplementedError(
            "raw feature values of an external-memory matrix are on disk as "
            "quantized pages; predict/eval/early-stopping stream pages "
            "automatically (learner._data_blocks) — only whole-matrix "
            "densification is refused")
