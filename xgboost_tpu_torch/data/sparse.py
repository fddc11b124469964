"""Sparse (CSR) input storage: the raw floats never densify whole.

The port of the JAX package's ``data/sparse.py`` (reference
``SparsePage`` / ``CSCPage``, ``include/xgboost/data.h:260-360``). The
scipy CSR stays on the host. The quantized matrix is dense (ELLPACK-style,
missing as a null bin), but it is built from NaN-filled **column blocks**
(``BinnedMatrix.from_sparse``), and prediction walks NaN-filled **row
blocks** (``Booster._data_blocks``): only such blocks go to the device,
never the raw CSR whole.

Absent entries are missing (libsvm semantics); a stored value equal to the
``missing`` sentinel becomes NaN; an explicitly stored zero is a real zero.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CSRStorage"]


class CSRStorage:
    """Host-side CSR with NaN-missing semantics for absent entries."""

    def __init__(self, mat, missing: float = np.nan):
        csr = mat.tocsr().astype(np.float32)
        if missing is not None and not (
                isinstance(missing, float) and np.isnan(missing)):
            csr.data = np.where(csr.data == missing, np.nan, csr.data)
        self.csr = csr
        self._csc = None

    @property
    def shape(self):
        return self.csr.shape

    @property
    def nnz(self) -> int:
        """Stored values that are not missing."""
        return int(np.count_nonzero(~np.isnan(self.csr.data)))

    def csc(self):
        if self._csc is None:
            self._csc = self.csr.tocsc()
        return self._csc

    def dense_cols(self, f0: int, f1: int) -> np.ndarray:
        """[n, f1-f0] float32, NaN where absent."""
        csc = self.csc()
        out = np.full((self.shape[0], f1 - f0), np.nan, dtype=np.float32)
        for f in range(f0, f1):
            lo, hi = csc.indptr[f], csc.indptr[f + 1]
            out[csc.indices[lo:hi], f - f0] = csc.data[lo:hi]
        return out

    def dense_rows(self, lo: int, hi: int) -> np.ndarray:
        """[hi-lo, F] float32, NaN where absent."""
        sub = self.csr[lo:hi]
        out = np.full(sub.shape, np.nan, dtype=np.float32)
        row_ids = np.repeat(np.arange(sub.shape[0]), np.diff(sub.indptr))
        out[row_ids, sub.indices] = sub.data
        return out

    def toarray(self) -> np.ndarray:
        return self.dense_rows(0, self.shape[0])

    def slice_rows(self, idx) -> "CSRStorage":
        out = CSRStorage.__new__(CSRStorage)
        out.csr = self.csr[np.asarray(idx)]
        out._csc = None
        return out

    def column_values(self, f: int) -> np.ndarray:
        """Stored (possibly NaN) values of one feature."""
        csc = self.csc()
        return csc.data[csc.indptr[f]:csc.indptr[f + 1]]
