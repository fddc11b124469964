"""Port parity: streaming and external-memory matrices against the JAX package.

The same batches (made from a numpy seed, with NaNs) go through a
``DataIter`` into ``xgboost_tpu``'s and ``xgboost_tpu_torch``'s matrices on
the CPU.

Bit for bit against the JAX package: the summary sketch
(``local_summary`` / ``merge_summaries``) with unit weights (every partial
sum exact, so no association matters) at max_bin 16, 100 and 256 (the
levels rounded as XLA computes them, ``sketch._levels``);
``StreamingQuantileDMatrix`` cuts, bins and reconstructed ``data``;
``pack_symbols`` bytes; a cache the JAX package wrote, read by the port's
``PagedBins`` (host and device unpack); ``float_page``. With batch
weights the partial sums are inexact in float32; the port sums them in
the association of XLA:CPU's ``jnp.cumsum``, so those cuts are equal
too (and so within one float32 ulp of each cut's magnitude).
Within the port, bit for bit: a paged tree equals the streaming matrix's
tree on the same bins (without row sampling), page by page or whole.
Within a stated tolerance of the JAX package (structure and split
conditions exact, leaf values within rtol 1e-5 / atol 5e-5, margins
within the same): paged training with and without ``subsample`` (each
page sampled under ``fold_in(k_sub, k)`` in both packages).
Pages are written by ``pagecache.cpp``'s ``pc_write`` (the
``pack_symbols`` bytes of the streaming matrix's bins) and read through
``pc_read``'s ring, never ``np.fromfile``: the paged trees equal the
streaming trees bit for bit, and a page missing on disk raises OSError.
Refusals with the JAX package's messages: lossguide, categorical, approx,
exact and the local histmaker on a paged matrix, its ``data``, another
``max_bin``, and a non-deterministic iterator; a foreign booster walking a
paged matrix warns.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from test_torch_lossguide import TOL, _assert_same_trees, _trees
from xgboost_tpu.data import external as jext
from xgboost_tpu.data.iterator import DataIter as JIter
from xgboost_tpu.data.iterator import StreamingQuantileDMatrix as JStream
from xgboost_tpu.parallel.sketch import _local_summary, _merge_summaries
from xgboost_tpu_torch.data import external as text
from xgboost_tpu_torch.data import sketch as tsk
from xgboost_tpu_torch.data.iterator import StreamingQuantileDMatrix

torch.set_num_threads(1)

CPU = dict(device="cpu")
PARAMS = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32,
          "eta": 0.3}


@pytest.fixture(scope="module", autouse=True)
def _pin_jax_route():
    """The JAX package's float level histograms (the parity tests' route)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH",
                  "tree_grow=level,sibling_sub=off,hist_acc=float")
        jax.clear_caches()
        yield
    jax.clear_caches()


def _batches(n_parts=4, rows=700, F=8, seed=0, weights=False):
    rng = np.random.RandomState(seed)
    w = rng.randn(F)
    out = []
    for _ in range(n_parts):
        X = rng.randn(rows, F).astype(np.float32)
        X[rng.rand(rows, F) < 0.1] = np.nan
        X[:, 2] = np.round(X[:, 2] * 2)  # ties
        y = (np.nan_to_num(X) @ w + 0.4 * rng.randn(rows) > 0).astype(
            np.float32)
        b = {"data": X, "label": y}
        if weights:
            b["weight"] = rng.uniform(0.2, 2.0, rows).astype(np.float32)
        out.append(b)
    return out


def _iters(batches):
    """(the port's iterator, the JAX package's) over ``batches``."""
    def make(base):
        class It(base):
            def __init__(self):
                super().__init__()
                self.i = 0

            def reset(self):
                self.i = 0

            def next(self, input_data):
                if self.i >= len(batches):
                    return 0
                input_data(**batches[self.i])
                self.i += 1
                return 1
        return It()
    return make(xgbt.DataIter), make(JIter)


@pytest.mark.parametrize("max_bin", [16, 100, 256])
def test_summary_sketch_matches_jax_bitwise(max_bin):
    parts = _batches(seed=1)
    tsum, jsum = [], []
    for b in parts:
        X = b["data"]
        tsum.append(tsk.local_summary(torch.from_numpy(X), None, max_bin))
        js = _local_summary(jnp.asarray(X), jnp.ones(X.shape[0]), max_bin)
        for t, j in zip(tsum[-1], js):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        jsum.append(js)
    tc, tm = tsk.merge_summaries(*(torch.stack(p) for p in zip(*tsum)),
                                 max_bin)
    jc, jm = _merge_summaries(*(jnp.stack(p) for p in zip(*jsum)), max_bin)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("max_bin", [32, 100])
def test_summary_sketch_weighted_within_an_ulp(max_bin):
    parts = _batches(seed=2, weights=True)
    tsum, jsum = [], []
    for b in parts:
        X, w = b["data"], b.get("weight")
        tsum.append(tsk.local_summary(
            torch.from_numpy(X), None if w is None else torch.from_numpy(w),
            max_bin))
        jsum.append(_local_summary(
            jnp.asarray(X), jnp.ones(X.shape[0]) if w is None
            else jnp.asarray(w), max_bin))
    tc, _ = tsk.merge_summaries(*(torch.stack(p) for p in zip(*tsum)),
                                max_bin)
    jc, _ = _merge_summaries(*(jnp.stack(p) for p in zip(*jsum)), max_bin)
    jc = np.asarray(jc)
    np.testing.assert_array_less(np.abs(tc.numpy() - jc),
                                 np.spacing(np.abs(jc)) + 1e-30)
    np.testing.assert_array_equal(tc.numpy(), jc)


def test_streaming_matrix_matches_jax_bitwise():
    parts = _batches(seed=3)
    ti, ji = _iters(parts)
    t = StreamingQuantileDMatrix(ti, max_bin=32, **CPU)
    j = JStream(ji, max_bin=32)
    tb, jb = t._binned[32], j._binned[32]
    np.testing.assert_array_equal(tb.cuts.values, np.asarray(jb.cuts.values))
    np.testing.assert_array_equal(tb.cuts.min_vals,
                                  np.asarray(jb.cuts.min_vals))
    np.testing.assert_array_equal(tb.bins.numpy().astype(np.int32),
                                  np.asarray(jb.bins).astype(np.int32))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.get_label(), j.info.label)
    assert t.data_is_reconstructed and (t.num_row(), t.num_col()) == (2800, 8)


def test_pack_symbols_bytes_match_jax():
    rng = np.random.RandomState(0)
    for bits, n, dt in ((3, 1000, np.uint8), (6, 4096, np.uint8),
                        (7, 333, np.uint8), (9, 5000, np.int16),
                        (9, 5000, np.uint16)):
        vals = rng.randint(0, 1 << bits, n).astype(dt)
        packed = text.pack_symbols(vals, bits)
        np.testing.assert_array_equal(packed, jext.pack_symbols(vals, bits))
        np.testing.assert_array_equal(
            text.unpack_symbols(packed, bits, n, dt), vals)
        tdt = torch.int16 if dt != np.uint8 else torch.uint8
        np.testing.assert_array_equal(text.unpack_symbols_torch(
            torch.from_numpy(packed), bits, n, tdt).numpy().astype(np.int64),
            vals.astype(np.int64))


@pytest.mark.parametrize("max_bin", [32, 256])
def test_port_reads_a_jax_written_cache(tmp_path, max_bin):
    parts = _batches(seed=4)
    ti, ji = _iters(parts)
    jd = xgb.ExternalMemoryQuantileDMatrix(
        ji, cache_prefix=str(tmp_path / "j"), max_bin=max_bin, page_rows=1024)
    td = xgbt.ExternalMemoryQuantileDMatrix(
        ti, cache_prefix=str(tmp_path / "t"), max_bin=max_bin,
        page_rows=1024, **CPU)
    jp, tp = jd._paged, td._paged
    assert tp.n_pages == jp.n_pages == 3 and tp.bits == jp.bits
    np.testing.assert_array_equal(tp.cuts.values, np.asarray(jp.cuts.values))
    reader = text.PagedBins(jp.prefix, tp.cuts, jp.n_rows, jp.n_features,
                            jp.page_rows, tp.dtype)
    for k in range(jp.n_pages):
        with open(jp.page_path(k), "rb") as a, open(tp.page_path(k),
                                                    "rb") as b:
            assert a.read() == b.read()  # the same bytes on disk
        want = jp.read_page(k).astype(np.int32)
        np.testing.assert_array_equal(reader.read_page(k).astype(np.int32),
                                      want)
        np.testing.assert_array_equal(
            reader.device_page(k, "cpu").numpy().astype(np.int32), want)
        np.testing.assert_array_equal(reader.float_page(k), jp.float_page(k))
        np.testing.assert_array_equal(
            reader.device_float_page(k, "cpu").numpy(), jp.float_page(k))
    np.testing.assert_array_equal(tp.midpoints(), jp.midpoints())
    jp.close()


@pytest.fixture(scope="module")
def paged_models(tmp_path_factory):
    """Port and JAX Boosters on a paged matrix (3 pages, the last of 752
    rows) with and without ``subsample``, and the port's on the streaming
    matrix of the same batches."""
    tmp = tmp_path_factory.mktemp("cache")
    parts = _batches(seed=5)
    out = {"X": np.concatenate([b["data"] for b in parts])}
    for name, extra in (("plain", {}), ("subsample", {"subsample": 0.7}),
                        ("colsample", {"colsample_bytree": 0.6,
                                       "colsample_bylevel": 0.7})):
        ti, ji = _iters(parts)
        td = xgbt.ExternalMemoryQuantileDMatrix(
            ti, cache_prefix=str(tmp / f"t{name}"), max_bin=32,
            page_rows=1024, **CPU)
        jd = xgb.ExternalMemoryQuantileDMatrix(
            ji, cache_prefix=str(tmp / f"j{name}"), max_bin=32,
            page_rows=1024)
        p = {**PARAMS, **extra}
        out[name] = (xgbt.train(p, td, 3, verbose_eval=False),
                     xgb.train(p, jd, 3, verbose_eval=False), td)
        si, _ = _iters(parts)
        out[name + "_stream"] = xgbt.train(
            p, StreamingQuantileDMatrix(si, max_bin=32, **CPU), 3,
            verbose_eval=False)
    return out


@pytest.mark.parametrize("case", ["plain", "colsample"])
def test_paged_trees_equal_streaming_trees(paged_models, case):
    tb, _, td = paged_models[case]
    assert tb.save_raw() == paged_models[case + "_stream"].save_raw()
    # the training margins too, page by page
    np.testing.assert_array_equal(
        tb._caches[id(td)].margin.numpy(),
        paged_models[case + "_stream"].predict(
            xgbt.DMatrix(paged_models["X"], **CPU), output_margin=True,
            strict_shape=True))


@pytest.mark.parametrize("case", ["plain", "subsample", "colsample"])
def test_paged_training_matches_jax(paged_models, case):
    tb, jb, _ = paged_models[case]
    X = paged_models["X"]
    _assert_same_trees(_trees(json.loads(jb.save_raw())),
                       _trees(tb.save_json()), X)
    np.testing.assert_allclose(
        tb.predict(xgbt.DMatrix(X, **CPU), output_margin=True),
        jb.predict(xgb.DMatrix(X), output_margin=True), rtol=1e-5, atol=TOL)


def test_pages_go_through_the_native_page_cache(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("np.fromfile read a page")

    monkeypatch.setattr(np, "fromfile", refuse)
    monkeypatch.setenv("XGBTPU_RETRY", "pager_io=0")
    parts = _batches(seed=9)
    d = xgbt.ExternalMemoryQuantileDMatrix(
        _iters(parts)[0], cache_prefix=str(tmp_path / "c"), max_bin=32,
        page_rows=1024, **CPU)
    s = StreamingQuantileDMatrix(_iters(parts)[0], max_bin=32, **CPU)
    pg, whole = d._paged, s.get_binned(32)
    assert pg._ring is None and pg.n_pages == 3
    for k in range(pg.n_pages):
        lo = k * pg.page_rows
        want = text.pack_symbols(
            whole.bins[lo:lo + pg.rows_of(k)].numpy().astype(pg.dtype),
            pg.bits)
        with open(pg.page_path(k), "rb") as f:
            assert f.read() == want.tobytes()
    bp = xgbt.train(PARAMS, d, 3, verbose_eval=False)
    bs = xgbt.train(PARAMS, s, 3, verbose_eval=False)
    assert bp.save_raw() == bs.save_raw()
    assert pg._ring is not None and pg.io["reads"] >= 3 * 4 * pg.n_pages
    pg.close()
    assert pg._ring is None
    with open(pg.page_path(2), "ab") as f:  # a page of the wrong size
        f.write(b"\0")
    with pytest.raises(OSError, match="must hold"):
        pg.read_page(2)
    os.remove(pg.page_path(1))
    with pytest.raises(OSError, match="pc_read returned 2"):
        pg.read_page(1)
    pg.cleanup()


def test_page_streamed_predict_eval_and_early_stopping(tmp_path):
    parts = _batches(seed=6)
    ti, _ = _iters(parts)
    d = xgbt.ExternalMemoryQuantileDMatrix(
        ti, cache_prefix=str(tmp_path / "c"), max_bin=32, page_rows=1024,
        **CPU)
    res = {}
    bst = xgbt.train({**PARAMS, "eval_metric": "logloss"}, d, 30,
                     evals=[(d, "train")], evals_result=res,
                     early_stopping_rounds=3, verbose_eval=False)
    assert res["train"]["logloss"][-1] < res["train"]["logloss"][0]
    cached = bst.predict(d, output_margin=True)
    bst._caches.clear()  # walk the pages: bins' midpoints
    walked = bst.predict(d, output_margin=True)
    np.testing.assert_allclose(walked, cached, rtol=0, atol=1e-6)
    leaves = bst.predict(d, pred_leaf=True)
    assert leaves.shape == (2800, bst.num_boosted_rounds())
    assert d._paged.io["prefetched"] > 0
    with pytest.raises(NotImplementedError) as te:
        _ = d.data
    jd = xgb.ExternalMemoryQuantileDMatrix(_iters(parts)[1], max_bin=32)
    with pytest.raises(NotImplementedError) as je:
        _ = jd.data
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        d.get_binned(64)
    with pytest.raises(ValueError) as je:
        jd.get_binned(64)
    assert str(te.value) == str(je.value)
    d._paged.cleanup()
    assert not list(tmp_path.glob("c.page*"))


def _refusal(params, mutate=None, error=NotImplementedError):
    parts = _batches(n_parts=2, rows=600, seed=7)
    ti, ji = _iters(parts)
    td = xgbt.ExternalMemoryQuantileDMatrix(ti, max_bin=16, page_rows=512,
                                            **CPU)
    jd = xgb.ExternalMemoryQuantileDMatrix(ji, max_bin=16, page_rows=512)
    for d in (td, jd):
        if mutate:
            mutate(d._paged)
    p = {**PARAMS, "max_bin": 16, **params}
    with pytest.raises(error) as te:
        xgbt.train(p, td, 2, verbose_eval=False)
    with pytest.raises(error) as je:
        xgb.train(p, jd, 2, verbose_eval=False)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("params", [
    {"grow_policy": "lossguide", "max_leaves": 8},
    {"tree_method": "approx"},
    {"tree_method": "exact"},
    {"updater": "grow_local_histmaker"}], ids=lambda p: str(list(p.values())))
def test_paged_matrix_refuses_other_methods(params):
    _refusal(params)


def test_paged_matrix_refuses_categorical_features():
    def cats(paged):
        paged.categorical, paged.cat_counts = (0,), (3,)
    _refusal({}, cats)


def test_non_deterministic_iterator_raises():
    """An iterator whose second pass yields fewer batches raises the JAX
    package's ValueError, message for message, in both matrices."""
    parts = _batches(n_parts=3, rows=200, seed=8)

    def shrinking(base):
        class Shrinking(base):
            def __init__(self):
                super().__init__()
                self.i, self.passes = 0, 0

            def reset(self):
                self.i = 0
                self.passes += 1

            def next(self, input_data):
                if self.i >= len(parts) - (self.passes > 1):
                    return 0
                input_data(**parts[self.i])
                self.i += 1
                return 1
        return Shrinking()
    for tm, jm in ((lambda it: StreamingQuantileDMatrix(it, max_bin=16, **CPU),
                    lambda it: JStream(it, max_bin=16)),
                   (lambda it: xgbt.ExternalMemoryQuantileDMatrix(
                       it, max_bin=16, **CPU),
                    lambda it: xgb.ExternalMemoryQuantileDMatrix(
                        it, max_bin=16))):
        with pytest.raises(ValueError, match="deterministic") as te:
            tm(shrinking(xgbt.DataIter))
        with pytest.raises(ValueError) as je:
            jm(shrinking(JIter))
        assert str(te.value) == str(je.value)


def test_foreign_booster_on_paged_matrix_warns(tmp_path):
    parts = _batches(seed=9)
    ti, _ = _iters(parts)
    d = xgbt.ExternalMemoryQuantileDMatrix(
        ti, cache_prefix=str(tmp_path / "f"), max_bin=32, page_rows=1024,
        **CPU)
    own = xgbt.train(PARAMS, d, 3, verbose_eval=False)
    own._caches.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        own.predict(d)
    rng = np.random.RandomState(9)
    Xo = rng.randn(600, 8).astype(np.float32)
    foreign = xgbt.train(PARAMS, xgbt.DMatrix(Xo, (Xo[:, 0] > 0), **CPU), 3,
                         verbose_eval=False)
    with pytest.warns(UserWarning, match="midpoint"):
        foreign.predict(d)
