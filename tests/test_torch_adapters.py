"""Port parity: the input adapters and binary files against the JAX package.

The same inputs (made from a numpy seed) go through ``xgboost_tpu``'s and
``xgboost_tpu_torch``'s ``dispatch_data`` and ``DMatrix`` on the CPU, and
must come out bit for bit the same: pandas frames with categorical
columns (their codes, the names and the ``"c"`` / ``"q"`` types), arrow
tables, lists, libsvm files with ``qid:`` (rows, labels and query
groups), csv files, ``__array_interface__`` documents (dense and CSR), and
``save_binary`` files written by either package and read by the other,
metadata included; ``load_row_split`` keeps the JAX package's rows.
Frames and tables are skipped where pandas or pyarrow is absent. Files the
plain Python parsers refuse (a csv header line, an empty csv field, a
malformed libsvm token) give the JAX package's matrices: both packages
read them with their native parsers.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu.data import adapters as ja
from xgboost_tpu_torch.data import adapters as ta

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _same(a, b):
    """Two adapter results equal: arrays bitwise (NaN at the same places)
    and of one dtype, names and types as lists, None where the other is."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == np.asarray(y).dtype
        else:
            assert list(x) == list(y)


def _frame(seed=0, n=200):
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(seed)
    cat = pd.Categorical(rng.choice(["a", "b", "c", None], n))
    f = rng.randn(n)
    f[rng.rand(n) < 0.1] = np.nan
    return pd.DataFrame({"x0": f, "color": cat,
                         "k": rng.randint(0, 5, n).astype(np.int64)})


def test_pandas_categorical_codes_match_jax():
    df = _frame()
    _same(ta.dispatch_data(df, enable_categorical=True),
          ja.dispatch_data(df, enable_categorical=True))
    X, names, types, _, _ = ta.dispatch_data(df, enable_categorical=True)
    assert names == ["x0", "color", "k"] and types == ["q", "c", "q"]
    assert np.isnan(X[:, 1]).any()  # None is a missing code
    with pytest.raises(ValueError, match="enable_categorical") as te:
        ta.dispatch_data(df)
    with pytest.raises(ValueError) as je:
        ja.dispatch_data(df)
    assert str(te.value) == str(je.value)
    # a frame trains on its categorical column through DMatrix
    y = (np.nan_to_num(df["x0"].to_numpy()) > 0).astype(np.float32)
    d = xgbt.DMatrix(df, y, enable_categorical=True, **CPU)
    assert d.feature_types == ["q", "c", "q"] and d.feature_names[1] == "color"
    bst = xgbt.train({"objective": "binary:logistic", "max_depth": 3}, d, 2,
                     verbose_eval=False)
    assert json.loads(bst.save_raw())["learner"]["feature_types"] == types


def test_arrow_table_matches_jax():
    pa = pytest.importorskip("pyarrow")
    table = pa.Table.from_pandas(_frame(1), preserve_index=False)
    _same(ta.dispatch_data(table, enable_categorical=True),
          ja.dispatch_data(table, enable_categorical=True))


@pytest.mark.parametrize("missing", [np.nan, -1.0])
def test_lists_and_arrays_match_jax(missing):
    rows = [[1.0, -1.0, 2.5], [0.0, 3.0, -1.0], [4.0, 5.0, 6.0]]
    _same(ta.dispatch_data(rows, missing=missing),
          ja.dispatch_data(rows, missing=missing))
    _same(ta.dispatch_data([1.0, 2.0]), ja.dispatch_data([1.0, 2.0]))
    m = sp.random(50, 7, density=0.3, format="csr", random_state=0)
    _same(ta.dispatch_data(m), ja.dispatch_data(m))
    d = xgbt.DMatrix(rows, [0, 1, 0], missing=missing, **CPU)
    np.testing.assert_array_equal(
        d.data.numpy(), np.asarray(xgb.DMatrix(rows, missing=missing).data))


def _write_libsvm(path, seed=0, qid=True):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(120):
        feats = sorted(rng.choice(9, rng.randint(1, 6), replace=False))
        toks = [f"{rng.randint(0, 3)}"]
        if qid:
            toks.append(f"qid:{i // 10}")
        toks += [f"{j}:{rng.randn():.6g}" for j in feats]
        lines.append(" ".join(toks))
    path.write_text("# a comment\n" + "\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("qid", [True, False])
def test_libsvm_matches_jax(tmp_path, qid):
    path = _write_libsvm(tmp_path / "train.libsvm", qid=qid)
    _same(ta.load_svmlight(str(path)), ja.load_svmlight(str(path)))
    _same(ta.dispatch_data(str(path)), ja.dispatch_data(str(path)))
    for uri in (str(path), f"{path}?format=libsvm"):
        td, jd = xgbt.DMatrix(uri, **CPU), xgb.DMatrix(uri)
        np.testing.assert_array_equal(td.data.numpy(), np.asarray(jd.data))
        np.testing.assert_array_equal(td.get_label(), jd.get_label())
        np.testing.assert_array_equal(td.get_uint_info("group_ptr"),
                                      jd.get_uint_info("group_ptr"))
    assert (td.groups is not None) == qid


def test_csv_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    raw = np.round(rng.randn(80, 5), 4).astype(np.float32)
    raw[:, 0] = rng.randint(0, 2, 80)
    path = tmp_path / "train.csv"
    np.savetxt(path, raw, delimiter=",", fmt="%.4f")
    _same(ta.dispatch_data(str(path)), ja.dispatch_data(str(path)))
    X, y = ta.load_csv(str(path), label_column=2)
    jX, jy = ja.load_csv(str(path), label_column=2)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    alias = tmp_path / "train.txt"
    alias.write_text(path.read_text())
    td = xgbt.DMatrix(f"{alias}?format=csv", **CPU)
    np.testing.assert_array_equal(td.data.numpy(), raw[:, 1:])
    np.testing.assert_array_equal(td.get_label(), raw[:, 0])


@pytest.fixture
def jax_parser():
    """The JAX package's native parser loaded in this process (its loader
    remembers a failed first try, which a build racing another test
    process's can cause: one more try then)."""
    from xgboost_tpu import native as jnative

    if jnative.get_lib() is None:
        jnative._tried = False
    assert jnative.get_lib() is not None


@pytest.mark.parametrize("name,text,rows", [
    ("header.csv", "label,a,b\n1,0.5,2\n0,1.5,-3\n", 2),
    ("empty_field.csv", "1,,3\n0,2.5,\n1,4,5\n", 3),
    ("malformed.libsvm", "1 0:1.5 garbage 2:3\n0 1:2\n", 2),
])
def test_files_the_plain_parsers_refuse_match_jax(tmp_path, jax_parser,
                                                  name, text, rows):
    path = tmp_path / name
    path.write_text(text)
    td, jd = xgbt.DMatrix(str(path), **CPU), xgb.DMatrix(str(path))
    np.testing.assert_array_equal(td.data.numpy(), np.asarray(jd.data))
    np.testing.assert_array_equal(td.get_label(), jd.get_label())
    assert td.data.dtype == torch.float32 and td.num_row() == rows


def _iface(a):
    spec = dict(a.__array_interface__)
    spec["data"] = list(spec["data"])
    return json.dumps(spec)


def test_array_interface_matches_jax():
    X = np.random.RandomState(4).randn(30, 6).astype(np.float32)
    tv = ta.from_array_interface(_iface(X))
    np.testing.assert_array_equal(tv, ja.from_array_interface(_iface(X)))
    assert np.shares_memory(tv, X)
    m = sp.random(40, 6, density=0.4, format="csr", random_state=5,
                  dtype=np.float32)
    args = (_iface(m.indptr), _iface(m.indices), _iface(m.data), 6)
    tm, jm = ta.csr_from_array_interface(*args), ja.csr_from_array_interface(
        *args)
    np.testing.assert_array_equal(tm.toarray(), jm.toarray())
    np.testing.assert_array_equal(tm.toarray(), m.toarray())


def _full_meta(n, seed=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    X[rng.rand(n, 4) < 0.1] = np.nan
    return dict(data=X, label=rng.randint(0, 2, n).astype(np.float32),
                weight=rng.rand(n).astype(np.float32),
                base_margin=rng.randn(n).astype(np.float32),
                feature_names=["a", "b", "c", "d"],
                feature_types=["q", "q", "q", "q"],
                feature_weights=rng.rand(4).astype(np.float32))


def _check_same_matrix(td, jd):
    np.testing.assert_array_equal(td.data.numpy(), np.asarray(jd.data))
    for f in ("label", "weight", "base_margin", "feature_weights"):
        np.testing.assert_array_equal(td.get_float_info(f),
                                      jd.get_float_info(f))
    np.testing.assert_array_equal(td.get_uint_info("group_ptr"),
                                  jd.get_uint_info("group_ptr"))
    assert td.feature_names == jd.feature_names
    assert td.feature_types == jd.feature_types


@pytest.mark.parametrize("name", ["m.buffer", "m.npz", "m.bin?format=binary"])
def test_save_binary_round_trips_both_ways(tmp_path, name):
    meta = _full_meta(60)
    X = meta.pop("data")
    group = [20, 25, 15]
    td = xgbt.DMatrix(X, group=group, **meta, **CPU)
    jd = xgb.DMatrix(X, group=group, **meta)
    path = str(tmp_path / name)
    file = path.partition("?")[0]
    td.save_binary(file)
    _check_same_matrix(xgbt.DMatrix(path, **CPU), jd)
    _check_same_matrix(xgbt.DMatrix(path, **CPU), xgb.DMatrix(path))
    jd.save_binary(file)
    _check_same_matrix(xgbt.DMatrix(path, **CPU), jd)
    # the two packages write the same keys with the same arrays
    td.save_binary(str(tmp_path / "t.npz"))
    jd.save_binary(str(tmp_path / "j.npz"))
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])
    # unset fields stay unset; a sparse matrix saves its values dense
    m = sp.random(30, 5, density=0.3, format="csr", random_state=1)
    bare = tmp_path / "bare.buffer"
    xgbt.DMatrix(m, **CPU).save_binary(str(bare))
    back = xgbt.DMatrix(str(bare), **CPU)
    assert back.label is None and back.weight is None and back.groups is None
    np.testing.assert_array_equal(back.data.numpy(),
                                  np.asarray(xgb.DMatrix(str(bare)).data))


@pytest.mark.parametrize("world", [1, 3])
def test_load_row_split_matches_jax(tmp_path, world):
    path = _write_libsvm(tmp_path / "rows.libsvm", seed=2, qid=False)
    for rank in range(world):
        t = xgbt.load_row_split(str(path), rank, world, **CPU)
        j = xgb.load_row_split(str(path), rank, world)
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.get_label(), j.get_label())
    with pytest.raises(ValueError, match="outside"):
        xgbt.load_row_split(str(path), 3, 3, **CPU)
    grouped = _write_libsvm(tmp_path / "q.libsvm", seed=2, qid=True)
    if world > 1:
        with pytest.raises(ValueError) as te:
            xgbt.load_row_split(str(grouped), 0, world, **CPU)
        with pytest.raises(ValueError) as je:
            xgb.load_row_split(str(grouped), 0, world)
        assert str(te.value) == str(je.value)
