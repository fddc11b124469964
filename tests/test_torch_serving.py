"""The serving fast path of the port (``xgboost_tpu_torch/predictor/
serving.py`` and ``Booster.inplace_predict`` over ``_forest_snapshot``).

Against the JAX package (models cross over as model JSON):

- ``bucket_rows`` equals the JAX package's for every n up to 20,000;
- ``inplace_predict`` (margin and value) within 1e-5 absolute: dense with
  NaN, CSR with a ``missing`` sentinel, ``iteration_range``, 3 classes,
  ``base_margin``, ``strict_shape`` (the JAX package may take its native
  walker on the CPU, which sums in double, so not bitwise).

The port against itself, bit for bit: served (``predict_serving``) ==
``inplace_predict`` == ``predict`` margins of a fresh ``DMatrix``; CSR ==
dense. Behaviour: the snapshot cache hits on repeat calls and a refresh
invalidates it (the new leaves are served); a ragged stream of sizes in
[1, 4096] falls in at most 9 buckets and each size is answered as given;
``last_route``; the per-model latency label.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import xgboost_tpu as jxgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu.predictor import serving as jserving
from xgboost_tpu_torch.observability import REGISTRY
from xgboost_tpu_torch.predictor import serving as tserving

torch.set_num_threads(1)

PARAMS = {"objective": "binary:logistic", "max_depth": 4, "seed": 3}


def _counter(name, **labels):
    fam = REGISTRY.get(name)
    return 0.0 if fam is None else fam.labels(**labels).value


def _data(n=600, F=8, seed=0, nan_frac=0.15):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    if nan_frac:
        X[rng.rand(n, F) < nan_frac] = np.nan
    y = (np.nan_to_num(X).sum(1) > 0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def models():
    """The port's binary and 3-class models and the JAX package's copies
    of them (loaded from the port's model JSON)."""
    X, y = _data()
    tb = xgbt.train(PARAMS, xgbt.DMatrix(X, y, device="cpu"), 5)
    y3 = np.random.RandomState(1).randint(0, 3, len(X)).astype(np.float32)
    tb3 = xgbt.train({"objective": "multi:softprob", "num_class": 3,
                      "max_depth": 3}, xgbt.DMatrix(X, y3, device="cpu"), 3)
    return {"X": X, "y": y, "bin": (tb, jxgb.Booster(model_file=tb.save_raw())),
            "mc": (tb3, jxgb.Booster(model_file=tb3.save_raw()))}


def test_bucket_rows_equals_jax():
    got = [tserving.bucket_rows(n) for n in range(20_001)]
    want = [jserving.bucket_rows(n) for n in range(20_001)]
    assert got == want
    assert tserving.bucket_rows(100_000) == 106_496


def _sentinel(X):
    Xm = np.nan_to_num(X, nan=0.0)
    Xm[::5, 0] = -999.0
    return Xm


CASES = {
    "dense_nan": lambda X: ((X,), {}),
    "csr_sentinel": lambda X: ((sp.csr_matrix(_sentinel(X)),),
                               {"missing": -999.0}),
    "dense_sentinel": lambda X: ((_sentinel(X),), {"missing": -999.0}),
    "iteration_range": lambda X: ((X,), {"iteration_range": (1, 4)}),
    "range_to_end": lambda X: ((X,), {"iteration_range": (2, 0)}),
    "base_margin": lambda X: (
        (X,), {"base_margin": np.linspace(-1, 1, len(X)).astype(np.float32)}),
    "strict_shape": lambda X: ((X[:7],), {"strict_shape": True}),
}


@pytest.mark.parametrize("predict_type", ["margin", "value"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_inplace_predict_matches_jax(models, case, predict_type):
    tb, jb = models["bin"]
    args, kw = CASES[case](models["X"])
    got = tb.inplace_predict(*args, predict_type=predict_type, **kw)
    want = np.asarray(jb.inplace_predict(*args, predict_type=predict_type,
                                         **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"iteration_range": (0, 2)},
                                {"strict_shape": True}])
@pytest.mark.parametrize("predict_type", ["margin", "value"])
def test_three_class_inplace_predict_matches_jax(models, kw, predict_type):
    tb, jb = models["mc"]
    X = models["X"]
    got = tb.inplace_predict(X, predict_type=predict_type, **kw)
    want = np.asarray(jb.inplace_predict(X, predict_type=predict_type, **kw))
    assert got.shape == want.shape == (len(X), 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("key", ["bin", "mc"])
def test_served_equals_inplace_equals_predict_bitwise(models, key):
    tb, _ = models[key]
    X = models["X"]
    fresh = tb.predict(xgbt.DMatrix(X, device="cpu"), output_margin=True)
    inplace = tb.inplace_predict(X, predict_type="margin")
    forest, tw = tb._forest_snapshot()
    served = tserving.predict_serving(
        forest, X, np.full((len(X), tb.n_groups), tb._base_margin_val,
                           np.float32), tw)
    np.testing.assert_array_equal(inplace, fresh)
    np.testing.assert_array_equal(served.reshape(inplace.shape), inplace)
    np.testing.assert_array_equal(tb.inplace_predict(X),
                                  tb.predict(xgbt.DMatrix(X, device="cpu")))


def test_csr_equals_dense_bitwise(models):
    tb, _ = models["bin"]
    Xm = _sentinel(models["X"])
    dense = np.where(Xm == 0, np.nan, Xm)  # a CSR's absent entries
    for fmt in ("csr", "csc", "coo"):
        m = getattr(sp.csr_matrix(Xm), "to" + fmt)()
        for kind in ("margin", "value"):
            np.testing.assert_array_equal(
                tb.inplace_predict(m, missing=-999.0, predict_type=kind),
                tb.inplace_predict(dense, missing=-999.0, predict_type=kind))


def test_feature_count_is_validated(models):
    tb, jb = models["bin"]
    X = models["X"]
    for b in (tb, jb):
        with pytest.raises(ValueError, match="feature"):
            b.inplace_predict(X[:, :4])
    # validate_features=False hands the narrow input to the walk, which
    # still refuses it (it would read past the row)
    with pytest.raises(ValueError):
        tb.inplace_predict(X[:, :4], validate_features=False)


def test_snapshot_cache_hits_and_refresh_invalidates():
    X, y = _data(400, 6, seed=4)
    d = xgbt.DMatrix(X, y, device="cpu")
    bst = xgbt.train(PARAMS, d, 3)
    bst.inplace_predict(X[:10])
    h0 = _counter("predict_forest_snapshot_hits_total")
    m0 = _counter("predict_forest_snapshot_misses_total")
    for _ in range(10):
        bst.inplace_predict(X[:10])
    assert _counter("predict_forest_snapshot_misses_total") == m0
    assert _counter("predict_forest_snapshot_hits_total") - h0 == 10
    # growing the model changes the key: one new stack, then cached
    bst.update(d, 3)
    bst.inplace_predict(X[:10])
    bst.inplace_predict(X[:10])
    assert _counter("predict_forest_snapshot_misses_total") == m0 + 1
    # a refresh rewrites the leaves of all 4 trees under the same count:
    # the snapshot must go, and the new leaves must be served
    before = bst.inplace_predict(X, predict_type="margin")
    y2 = 1.0 - y
    ref = xgbt.train(dict(PARAMS, process_type="update", updater="refresh",
                          refresh_leaf=1),
                     xgbt.DMatrix(X, y2, device="cpu"), 4, xgb_model=bst)
    got = ref.inplace_predict(X, predict_type="margin")
    want = ref.predict(xgbt.DMatrix(X, device="cpu"), output_margin=True)
    assert not np.array_equal(got, before)
    np.testing.assert_array_equal(got, want)
    # the same Booster refreshed in place: the 4-tree snapshot it cached
    # before must not be served after its leaves changed
    snap = xgbt.Booster(model_file=bst.save_raw(), device="cpu")
    snap.inplace_predict(X)  # caches (4 trees, all rounds)
    snap.set_param({"process_type": "update", "updater": "refresh",
                    "refresh_leaf": 1})
    dd = xgbt.DMatrix(X, y2, device="cpu")
    for i in range(4):
        snap.update(dd, i)
    np.testing.assert_array_equal(
        snap.inplace_predict(X, predict_type="margin"),
        snap.predict(xgbt.DMatrix(X, device="cpu"), output_margin=True))
    # loading another model into a Booster drops its snapshots
    snap.load_model(bst.save_raw())
    np.testing.assert_array_equal(
        snap.inplace_predict(X, predict_type="margin"), before)


def test_ragged_stream_touches_at_most_nine_entries():
    """Sizes in [1, 4096] fall in at most the buckets 16, 32, ..., 4096,
    the JAX package's bound on its compiled programs; the port walks every
    size as given, each answer equal to the same rows' ``predict``."""
    X, y = _data(4096, 6, seed=7, nan_frac=0.0)
    bst = xgbt.train(dict(PARAMS, max_depth=2), xgbt.DMatrix(X, y, device="cpu"), 2)
    sizes = np.random.RandomState(0).randint(1, 4097, 120)
    sizes[:9] = [1, 17, 33, 65, 129, 257, 513, 1025, 2049]  # every bucket
    assert len({tserving.bucket_rows(int(n)) for n in sizes}) == 9
    full = bst.predict(xgbt.DMatrix(X, device="cpu"), output_margin=True)
    r0 = _counter("inplace_predict_rows_total")
    for n in sizes:
        np.testing.assert_array_equal(
            bst.inplace_predict(X[:n], predict_type="margin"), full[:n])
    assert _counter("inplace_predict_rows_total") - r0 == sizes.sum()


def test_last_route_and_latency_label(models):
    tb, _ = models["bin"]
    X = models["X"]
    with tserving.serving_context(model="lat@v1"):
        assert tserving.last_route() == ""
        tb.inplace_predict(X[:5])
        assert tserving.last_route() == "torch"  # the plain version, CPU
    fam = REGISTRY.get("predict_latency_seconds")
    assert fam.labels(model="lat@v1").count >= 1
    # no trees: the base alone
    empty = xgbt.Booster({"objective": "binary:logistic"}, device="cpu")
    out = empty.inplace_predict(X[:3], predict_type="margin")
    assert tserving.last_route() == "base"
    np.testing.assert_array_equal(out, np.full(3, empty._base_margin_val,
                                               np.float32))


def test_estimator_predict_takes_the_serving_path(models):
    X, y = models["X"], models["y"]
    clf = xgbt.XGBClassifier(n_estimators=3, max_depth=2, device="cpu")
    clf.fit(X, y)
    r0 = _counter("inplace_predict_rows_total")
    p = clf.predict_proba(X)
    assert _counter("inplace_predict_rows_total") - r0 == len(X)
    assert p.shape == (len(X), 2)
