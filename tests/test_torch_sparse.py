"""Port parity: sparse (CSR) input against the JAX package and within the port.

The same scipy matrices (made from a numpy seed, with explicit zeros among
the stored values and, where named, a ``missing`` sentinel among them) go
through ``xgboost_tpu`` and ``xgboost_tpu_torch`` on the CPU.

Bit for bit against the JAX package: the ``CSRStorage`` methods, and the
cuts and bins of ``BinnedMatrix.from_sparse`` at max_bin 16 and 256.
Within the port, bit for bit: the CSR path's cuts, bins, trees (JSON),
``predict`` and ``inplace_predict`` equal the dense path's on the same
values with NaN where entries are absent, and a CSR matrix never makes
its dense ``data`` through ``train`` + ``predict`` (the JAX package's
``test_sparse_dmatrix_never_densifies_through_train_predict``).
Within a stated tolerance of the JAX package (its pinned float level
route): trees and margins trained on CSR and on ``QuantileDMatrix`` with a
validation set on the training cuts (``ref=``) — structure and split
conditions exact, leaf values within rtol 1e-5 / atol 5e-5
(``tests/test_torch_lossguide.py``'s tolerances) — and CSR
``inplace_predict`` within 1e-5 of the JAX package's (its native walker
sums in double).
"""

import json

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from test_torch_lossguide import TOL, _assert_same_trees, _trees
from xgboost_tpu.data.quantile import BinnedMatrix as JBinned
from xgboost_tpu.data.sparse import CSRStorage as JCSR
from xgboost_tpu_torch.data.quantile import BinnedMatrix as TBinned
from xgboost_tpu_torch.data.sparse import CSRStorage as TCSR

torch.set_num_threads(1)

CPU = dict(device="cpu")
PARAMS = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32,
          "eta": 0.3, "eval_metric": ["auc", "logloss"]}


@pytest.fixture(scope="module", autouse=True)
def _pin_jax_route():
    """The JAX package's float level histograms (the parity tests' route)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        yield
    jax.clear_caches()


def _csr(n=3000, F=12, density=0.3, seed=0, zeros=40, sentinel=None):
    """A random CSR with ``zeros`` explicitly stored zeros and, with
    ``sentinel``, 30 stored values set to it; and its label."""
    rng = np.random.RandomState(seed)
    m = sp.random(n, F, density=density, format="csr", random_state=rng,
                  data_rvs=lambda k: rng.randn(k).astype(np.float32))
    m.data[rng.choice(m.nnz, zeros, replace=False)] = 0.0
    if sentinel is not None:
        m.data[rng.choice(m.nnz, 30, replace=False)] = sentinel
    w = rng.randn(F).astype(np.float32)
    y = (np.asarray(m @ w).ravel() + 0.3 * rng.randn(n) > 0).astype(
        np.float32)
    return m, y


def _dense(m, missing=np.nan):
    """The CSR's values dense, NaN where absent or equal to ``missing``."""
    out = np.full(m.shape, np.nan, np.float32)
    c = m.tocoo()
    out[c.row, c.col] = c.data
    if not np.isnan(missing):
        out[out == missing] = np.nan
    return out


@pytest.mark.parametrize("sentinel", [None, -1.0])
def test_csr_storage_matches_jax(sentinel):
    m, _ = _csr(sentinel=sentinel)
    missing = np.nan if sentinel is None else sentinel
    j, t = JCSR(m, missing), TCSR(m, missing)
    assert t.shape == j.shape and t.nnz == j.nnz
    assert t.nnz == m.nnz - (30 if sentinel is not None else 0)
    np.testing.assert_array_equal(t.toarray(), j.toarray())
    np.testing.assert_array_equal(t.toarray(), _dense(m, missing))
    np.testing.assert_array_equal(t.dense_cols(3, 9), j.dense_cols(3, 9))
    np.testing.assert_array_equal(t.dense_rows(100, 250),
                                  j.dense_rows(100, 250))
    for f in (0, 5, 11):
        np.testing.assert_array_equal(t.column_values(f), j.column_values(f))
    idx = np.arange(0, 3000, 7)
    np.testing.assert_array_equal(t.slice_rows(idx).toarray(),
                                  j.slice_rows(idx).toarray())
    # an explicitly stored zero is a value, an absent entry is missing
    assert (t.toarray() == 0.0).sum() >= 40 - 1


@pytest.mark.parametrize("max_bin", [16, 256])
@pytest.mark.parametrize("sentinel", [None, -1.0])
def test_from_sparse_matches_jax_and_dense(max_bin, sentinel):
    m, _ = _csr(seed=1, sentinel=sentinel)
    missing = np.nan if sentinel is None else sentinel
    jb = JBinned.from_sparse(JCSR(m, missing), max_bin=max_bin)
    tb = TBinned.from_sparse(TCSR(m, missing), max_bin=max_bin)
    np.testing.assert_array_equal(tb.cuts.values, np.asarray(jb.cuts.values))
    np.testing.assert_array_equal(tb.cuts.min_vals,
                                  np.asarray(jb.cuts.min_vals))
    np.testing.assert_array_equal(tb.bins.numpy().astype(np.int32),
                                  np.asarray(jb.bins).astype(np.int32))
    td = TBinned.from_dense(torch.from_numpy(_dense(m, missing)),
                            max_bin=max_bin)
    np.testing.assert_array_equal(tb.cuts.values, td.cuts.values)
    np.testing.assert_array_equal(tb.bins.numpy(), td.bins.numpy())
    assert tb.bins.dtype == td.bins.dtype


def test_csr_dmatrix_never_densifies_and_equals_dense():
    m, y = _csr(n=4000, seed=2)
    d = xgbt.DMatrix(m, y, **CPU)
    assert d._data is None and d._sparse is not None
    assert (d.num_row(), d.num_col()) == (4000, 12)
    assert d.num_nonmissing() == m.nnz
    bst = xgbt.train(PARAMS, d, 6, evals=[(d, "train")], verbose_eval=False)
    pred = bst.predict(d)
    assert d._data is None
    assert np.isfinite(pred).all()
    dd = xgbt.DMatrix(_dense(m), y, **CPU)
    bd = xgbt.train(PARAMS, dd, 6, verbose_eval=False)
    np.testing.assert_array_equal(d.get_binned(32).cuts.values,
                                  dd.get_binned(32).cuts.values)
    np.testing.assert_array_equal(d.get_binned(32).bins.numpy(),
                                  dd.get_binned(32).bins.numpy())
    assert bst.save_raw() == bd.save_raw()
    np.testing.assert_array_equal(pred, bd.predict(dd))
    np.testing.assert_array_equal(bst.predict(d, pred_leaf=True),
                                  bd.predict(dd, pred_leaf=True))
    np.testing.assert_array_equal(
        bst.predict(d, iteration_range=(1, 4), output_margin=True),
        bd.predict(dd, iteration_range=(1, 4), output_margin=True))
    assert d._data is None
    # a reader of raw values densifies once, onto the matrix's device
    np.testing.assert_array_equal(d.data.numpy(), _dense(m))
    assert d._data is not None


def test_csr_rows_walk_in_blocks(monkeypatch):
    """Prediction walks a CSR matrix in row blocks (here of 1,000 rows):
    the same margins as one walk of the dense rows."""
    from xgboost_tpu_torch import learner

    m, y = _csr(n=3500, seed=3)
    d = xgbt.DMatrix(m, y, **CPU)
    bst = xgbt.train(PARAMS, d, 3, verbose_eval=False)
    blocks = []
    real = learner.Booster._data_blocks

    def spy(self, dmat, blk=65536):
        for lo, hi, X in real(self, dmat, 1000):
            blocks.append((lo, hi))
            yield lo, hi, X
    monkeypatch.setattr(learner.Booster, "_data_blocks", spy)
    got = bst.predict(xgbt.DMatrix(m, **CPU), output_margin=True)
    assert blocks == [(0, 1000), (1000, 2000), (2000, 3000), (3000, 3500)]
    want = bst.predict(xgbt.DMatrix(_dense(m), **CPU), output_margin=True)
    np.testing.assert_array_equal(got, want)


def test_csr_inplace_predict_equals_dense_and_jax():
    m, y = _csr(n=2000, seed=4, sentinel=-1.0)
    jb = xgb.train(PARAMS, xgb.DMatrix(_dense(m, -1.0), label=y), 4,
                   verbose_eval=False)
    tb = xgbt.Booster(model_file=jb.save_raw(), **CPU)
    for kind in ("margin", "value"):
        got = tb.inplace_predict(m, missing=-1.0, predict_type=kind)
        np.testing.assert_array_equal(
            got, tb.inplace_predict(_dense(m, -1.0), predict_type=kind))
        np.testing.assert_allclose(
            got, jb.inplace_predict(m, missing=-1.0, predict_type=kind),
            rtol=0, atol=1e-5)
    for fmt in ("csc", "coo"):
        np.testing.assert_array_equal(
            tb.inplace_predict(getattr(m, "to" + fmt)(), missing=-1.0),
            tb.inplace_predict(m, missing=-1.0))


@pytest.fixture(scope="module")
def trained():
    m, y = _csr(n=2560, seed=5)
    mt, yt, mv, yv = m[:2048], y[:2048], m[2048:], y[2048:]
    out = {}
    jres, tres = {}, {}
    jb = xgb.train(PARAMS, xgb.DMatrix(mt, label=yt), 3,
                   evals=[(xgb.DMatrix(mv, label=yv), "val")],
                   evals_result=jres, verbose_eval=False)
    tb = xgbt.train(PARAMS, xgbt.DMatrix(mt, yt, **CPU), 3,
                    evals=[(xgbt.DMatrix(mv, yv, **CPU), "val")],
                    evals_result=tres, verbose_eval=False)
    out["csr"] = (mt, mv, jb, tb, jres, tres)
    jq = xgb.QuantileDMatrix(mt, label=yt, max_bin=32)
    tq = xgbt.QuantileDMatrix(mt, yt, max_bin=32, **CPU)
    jv = xgb.QuantileDMatrix(_dense(mv), label=yv, max_bin=32, ref=jq)
    tv = xgbt.QuantileDMatrix(_dense(mv), yv, max_bin=32, ref=tq, **CPU)
    np.testing.assert_array_equal(tv._binned[32].cuts.values,
                                  np.asarray(jv._binned[32].cuts.values))
    np.testing.assert_array_equal(tv._binned[32].cuts.values,
                                  tq._binned[32].cuts.values)
    np.testing.assert_array_equal(
        tv._binned[32].bins.numpy().astype(np.int32),
        np.asarray(jv._binned[32].bins).astype(np.int32))
    jres, tres = {}, {}
    jb = xgb.train(PARAMS, jq, 3, evals=[(jv, "val")], evals_result=jres,
                   verbose_eval=False)
    tb = xgbt.train(PARAMS, tq, 3, evals=[(tv, "val")], evals_result=tres,
                    verbose_eval=False)
    assert tq._data is None
    out["quantile_ref"] = (mt, mv, jb, tb, jres, tres)
    return out


def _margins(bst, m):
    if isinstance(bst, xgb.Booster):
        return bst.predict(xgb.DMatrix(m), output_margin=True)
    return bst.predict(xgbt.DMatrix(m, **CPU), output_margin=True)


@pytest.mark.parametrize("case", ["csr", "quantile_ref"])
def test_train_matches_jax(trained, case):
    mt, mv, jb, tb, jres, tres = trained[case]
    _assert_same_trees(_trees(json.loads(jb.save_raw())),
                       _trees(tb.save_json()), _dense(mt))
    for rows in (mt, mv):
        np.testing.assert_allclose(_margins(tb, rows), _margins(jb, rows),
                                   rtol=1e-5, atol=TOL)
    for k, vals in jres["val"].items():
        np.testing.assert_allclose(np.rint(np.asarray(tres["val"][k]) * 1e6),
                                   np.rint(np.asarray(vals) * 1e6),
                                   rtol=0, atol=1.0)
    assert tres["val"]["auc"][-1] > 0.8


def test_slice_stays_sparse_and_sentinel_counts():
    m, y = _csr(n=1000, F=6, seed=6, sentinel=-1.0)
    d = xgbt.DMatrix(m, y, missing=-1.0, **CPU)
    assert d.num_nonmissing() == m.nnz - 30
    s = d.slice(np.arange(0, 1000, 3))
    assert s._data is None and s.num_row() == 334
    np.testing.assert_array_equal(s.get_label(), y[::3])
    np.testing.assert_array_equal(s.data.numpy(), _dense(m, -1.0)[::3])
    got = d.get_data()
    assert sp.isspmatrix_csr(got) and got.nnz == m.nnz
    jd = xgb.DMatrix(m, label=y, missing=-1.0)
    assert d.num_nonmissing() == jd.num_nonmissing()


def test_explicit_zero_routes_apart_from_absent():
    """A stored zero is a value and an absent entry is missing: they take
    different branches of a split whose default direction disagrees with
    the zero's side (the JAX package's test, in the port)."""
    rng = np.random.RandomState(2)
    n = 2000
    x0 = rng.randn(n).astype(np.float32)
    present = rng.rand(n) < 0.5
    y = np.where(present, (x0 > 0).astype(np.float32), 1.0).astype(np.float32)
    rows = np.nonzero(present)[0]
    m = sp.csr_matrix((x0[rows], (rows, np.zeros(len(rows), np.int64))),
                      shape=(n, 1))
    bst = xgbt.train({"objective": "binary:logistic", "max_depth": 2,
                      "eta": 1.0}, xgbt.DMatrix(m, y, **CPU), 3,
                     verbose_eval=False)
    assert ((bst.predict(xgbt.DMatrix(m, **CPU)) > 0.5) == y.astype(bool)
            ).mean() > 0.95
    others = np.setdiff1d(np.arange(n), rows)
    m_all = sp.csr_matrix(
        (np.concatenate([x0[rows], np.zeros(len(others), np.float32)]),
         (np.concatenate([rows, others]), np.zeros(n, np.int64))),
        shape=(n, 1))
    assert m_all.nnz > m.nnz
    assert not np.allclose(bst.predict(xgbt.DMatrix(m, **CPU)),
                           bst.predict(xgbt.DMatrix(m_all, **CPU)))
