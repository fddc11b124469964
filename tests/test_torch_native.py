"""The port's native parser (``xgboost_tpu_torch/native/fastparse.cpp``)
held against the JAX package's (``xgboost_tpu.native``).

On the cases of ``tests/test_native.py`` (libsvm with ``qid:``, csv, an
empty csv field, malformed libsvm tokens, a csv header and comments, no
trailing newline) and on a synthetic agaricus-shaped libsvm file (6,513
rows of 22 one-hot features among 127, from a seed, in place of the
reference's demo file), ``load_svmlight_native`` / ``load_csv_native``
give bit for bit the JAX package's arrays, and where the input is
well-formed also the plain Python parsers' (``adapters._load_svmlight_py``
/ ``_load_csv_py``). ``DMatrix`` of such a file goes through the native
parser. The library is built with this machine's ``g++``: a failed build
fails the test. The loaders raise on a missing file. ``build_info()``
has the JAX package's keys, and ``GBTree``, ``Dart`` and ``GBLinear`` are
exported at the top level as there.
"""

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xgbt
from xgboost_tpu import native as jnative
from xgboost_tpu_torch import native
from xgboost_tpu_torch.data import adapters as ta


@pytest.fixture(scope="module", autouse=True)
def jax_parser():
    """The JAX package's parser loaded in this process. Its loader
    remembers a failed first try, which a build racing another test
    process's can cause: one more try then."""
    if jnative.get_lib() is None:
        jnative._tried = False
    assert jnative.get_lib() is not None, "the JAX package's parser"


def _same(a, b):
    """Tuples of arrays (or None) equal bit for bit, dtypes included."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _svm(path):
    got = native.load_svmlight_native(str(path))
    _same(got, jnative.load_svmlight_native(str(path)))
    return got


def _csv(path):
    got = native.load_csv_native(str(path))
    _same(got, jnative.load_csv_native(str(path)))
    return got


def _agaricus_like(path, n=6513, F=127, k=22, seed=0):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        feats = np.sort(rng.choice(F, k, replace=False))
        label = int(rng.rand() < 0.48)
        lines.append(f"{label} " + " ".join(f"{j}:1" for j in feats))
    path.write_text("\n".join(lines) + "\n")


def test_native_libsvm_matches_python(tmp_path):
    path = tmp_path / "agaricus.txt.train"
    _agaricus_like(path)
    X, y, qid = _svm(path)
    assert X.shape == (6513, 127) and qid is None
    _same((X, y, qid), ta._load_svmlight_py(str(path)))


def test_native_libsvm_qid(tmp_path):
    p = tmp_path / "rank.txt"
    p.write_text("1 qid:1 0:1.5 2:2.5\n0 qid:1 1:0.5\n2 qid:2 0:-1e-2\n")
    X, y, qid = _svm(p)
    np.testing.assert_array_equal(y, [1, 0, 2])
    np.testing.assert_array_equal(qid, [1, 1, 2])
    assert X.shape == (3, 3) and np.isnan(X[1, 0])
    _same((X, y, qid), ta._load_svmlight_py(str(p)))


def test_native_csv(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("1,0.5,-2.25\n0,3e2,4\n1,-0.125,0.0\n")
    X, y = _csv(p)
    np.testing.assert_array_equal(y, [1, 0, 1])
    np.testing.assert_array_equal(
        X, np.float32([[0.5, -2.25], [300.0, 4.0], [-0.125, 0.0]]))
    _same((X, y), ta._load_csv_py(str(p)))


def test_native_csv_empty_field_is_nan(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("1,,2\n0,3,\n")
    X, y = _csv(p)
    assert np.isnan(X[0, 0]) and X[0, 1] == 2
    assert X[1, 0] == 3 and np.isnan(X[1, 1])
    with pytest.raises(ValueError):  # the plain parser has no empty field
        ta._load_csv_py(str(p))


def test_native_libsvm_malformed_tokens_no_hang(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("abc 1:2\n1 0:junk 1:3.5\nNA 0:1\n0 garbage 1:2\n")
    X, y, _ = _svm(p)
    np.testing.assert_array_equal(y, [1, 0])
    assert X[0, 1] == np.float32(3.5) and X[1, 1] == np.float32(2.0)
    with pytest.raises(ValueError):  # the plain parser stops at a token
        ta._load_svmlight_py(str(p))


def test_native_csv_skips_header_and_comments(tmp_path):
    p = tmp_path / "h.csv"
    p.write_text("id,value,other\n# a comment\n1,0.5,2\n0,1.5,3\n")
    X, y = _csv(p)
    np.testing.assert_array_equal(y, [1, 0])
    np.testing.assert_array_equal(X, np.float32([[0.5, 2.0], [1.5, 3.0]]))


def test_native_no_trailing_newline(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text("1 0:2.5")
    X, y, _ = _svm(p)
    np.testing.assert_array_equal(y, [1])
    assert X[0, 0] == np.float32(2.5)
    _same((X, y, None), ta._load_svmlight_py(str(p)))


def test_dmatrix_uses_native_path(tmp_path, monkeypatch):
    path = tmp_path / "agaricus.txt.train"
    _agaricus_like(path)
    calls = []
    real = native.load_svmlight_native
    monkeypatch.setattr(native, "load_svmlight_native",
                        lambda p: calls.append(p) or real(p))
    d = xgbt.DMatrix(str(path), device="cpu")
    assert d.num_row() == 6513 and d.num_col() == 127 and calls


def test_native_loaders_raise_on_a_missing_file(tmp_path):
    for fn in (native.load_svmlight_native, native.load_csv_native):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "absent.txt"))


def test_build_info_and_boosters_match_jax_names():
    """``build_info()`` has the JAX package's keys (the card's absence
    read here as the ``cpu`` backend with the plain versions as the
    route), and the top-level booster classes are exported as there."""
    import xgboost_tpu as xgb

    info, jinfo = xgbt.build_info(), xgb.build_info()
    assert set(info) == set(jinfo)
    assert info["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert info["pallas_kernels"] is torch.cuda.is_available()
    assert info["native_pagecache"] is True and info["devices"] >= 1
    for name in ("GBTree", "Dart", "GBLinear"):
        assert hasattr(xgb, name) and name in xgbt.__all__
        assert getattr(xgbt, name).__module__.startswith("xgboost_tpu_torch")
