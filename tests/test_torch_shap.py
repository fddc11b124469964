"""Port parity: SHAP values (``xgboost_tpu_torch/interpret.py``) against
the JAX package's ``xgboost_tpu.interpret``, on the CPU.

Each model is trained by the port on seeded numpy data (96 x 6 training
rows with 10% missing values, ``max_bin`` 16), saved as JSON and loaded
into both packages; both explain the same rows. Cases: depth 3, 4 and 6,
two categorical columns (one-hot and partition regimes), 3 classes, DART
(tree weights) and a lossguide tree. Tolerances:

- contributions (``pred_contribs``), Saabas (``approx_contribs``) and
  interactions (``pred_interactions``) within 1e-6 of the JAX package's
  (both sum float64 terms; the orders differ);
- the deep-path DP (forced in the port alone by setting its
  ``_TABLE_MAX_D`` to 0, the JAX ``tests/test_shap.py`` case) within 1e-8
  of the table path, contributions and interactions;
- row and leaf chunks (a small ``_CHUNK_BYTES``) within 1e-12 of one
  chunk;
- additivity: contributions sum to the port's margins within 1e-5
  (float32 margins), interaction rows to the contributions within 1e-6,
  interactions symmetric within 1e-12.

The JAX package's behaviours are kept and checked: the DMatrix's own
``base_margin`` and ``iteration_range`` / ``ntree_limit`` change nothing.
"""

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
from xgboost_tpu import interpret as jshap
import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch import interpret as tshap

torch.set_num_threads(1)

F = 6
FT = ["q", "c", "q", "q", "c", "q"]  # column 1: 3 categories, 4: 12
BASE = {"objective": "binary:logistic", "max_bin": 16, "eta": 0.3}
CASES = {
    "depth3": (4, dict(max_depth=3), None),
    "depth4": (3, dict(max_depth=4), None),
    "depth6": (2, dict(max_depth=6), None),
    "categorical": (3, dict(max_depth=3), FT),
    "multiclass3": (2, dict(max_depth=3, objective="multi:softprob",
                            num_class=3), None),
    "dart": (4, dict(max_depth=3, booster="dart", rate_drop=0.5), None),
    "lossguide": (2, dict(grow_policy="lossguide", max_leaves=7,
                          max_depth=0), None),
}
INTERACTION_CASES = ["depth3", "depth4", "categorical", "multiclass3",
                     "dart", "lossguide"]


def _data(seed, n, types=None, classes=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    if types:
        X[:, 1] = rng.randint(0, 3, n)
        X[:, 4] = rng.randint(0, 12, n)
    X[rng.rand(n, F) < 0.1] = np.nan
    z = np.nan_to_num(X) @ rng.randn(F, max(classes, 1))
    if classes:
        y = np.argmax(z + 0.3 * rng.randn(n, classes), 1)
    else:
        y = (z[:, 0] + 0.5 * rng.randn(n) > 0)
    return X, y.astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """Per case: (JAX Booster, port Booster, rows, feature types), both
    Boosters loaded from the port's JSON."""
    out = {}
    for name, (rounds, params, types) in CASES.items():
        X, y = _data(3, 96, types, params.get("num_class", 0))
        tb = xgbt.train({**BASE, **params},
                        xgbt.DMatrix(X, y, feature_types=types, device="cpu"),
                        rounds, verbose_eval=False)
        raw = tb.save_raw()
        out[name] = (xgb.Booster(model_file=raw),
                     xgbt.Booster(model_file=raw, device="cpu"), X, types)
    return out


def _both(models, name):
    jb, tb, X, types = models[name]
    return (jb, tb, xgb.DMatrix(X, feature_types=types),
            xgbt.DMatrix(X, feature_types=types, device="cpu"), X)


@pytest.mark.parametrize("name", list(CASES))
def test_contribs_match_jax(models, name):
    jb, tb, jd, td, X = _both(models, name)
    got = tb.predict(td, pred_contribs=True)
    want = jshap.predict_contribs(jb, jd)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got = tb.predict(td, pred_contribs=True, approx_contribs=True)
    want = jshap.predict_contribs(jb, jd, approx=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", INTERACTION_CASES)
def test_interactions_match_jax(models, name):
    jb, tb, jd, td, X = _both(models, name)
    got = tb.predict(td, pred_interactions=True)
    want = jshap.predict_interactions(jb, jd)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["depth4", "multiclass3", "lossguide",
                                  "categorical"])
def test_deep_path_matches_table(models, name, monkeypatch):
    """Every path through the row DP (``_TABLE_MAX_D`` 0) gives the table
    path's values; the counts say which route each path took."""
    _, tb, _, td, _ = _both(models, name)
    tshap.reset_path_counts()
    tab_c = tb.predict(td, pred_contribs=True)
    tab_i = tb.predict(td, pred_interactions=True)
    assert tshap.path_counts["deep"] == 0 and tshap.path_counts["table"] > 0
    monkeypatch.setattr(tshap, "_TABLE_MAX_D", 0)
    tshap.reset_path_counts()
    dp_c = tb.predict(td, pred_contribs=True)
    dp_i = tb.predict(td, pred_interactions=True)
    assert tshap.path_counts["table"] == 0 and tshap.path_counts["deep"] > 0
    np.testing.assert_allclose(dp_c, tab_c, rtol=0, atol=1e-8)
    np.testing.assert_allclose(dp_i, tab_i, rtol=0, atol=1e-8)


@pytest.mark.parametrize("table_max_d", [12, 2])
def test_row_and_leaf_chunks_change_nothing(models, table_max_d,
                                            monkeypatch):
    """A chunk budget of a few rows (and of one leaf for the tables) gives
    the one-chunk values, on both routes (2: some paths take the row
    DP)."""
    _, tb, _, td, _ = _both(models, "depth4")
    monkeypatch.setattr(tshap, "_TABLE_MAX_D", table_max_d)
    whole_c = tb.predict(td, pred_contribs=True)
    whole_i = tb.predict(td, pred_interactions=True)
    monkeypatch.setattr(tshap, "_CHUNK_BYTES", 1 << 12)
    np.testing.assert_allclose(tb.predict(td, pred_contribs=True), whole_c,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tb.predict(td, pred_interactions=True),
                               whole_i, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["depth6", "multiclass3", "dart",
                                  "categorical"])
def test_additivity_and_symmetry(models, name):
    _, tb, _, td, X = _both(models, name)
    contribs = tb.predict(td, pred_contribs=True)
    margin = tb.predict(td, output_margin=True)
    np.testing.assert_allclose(contribs.sum(-1), margin, rtol=0, atol=1e-5)
    approx = tb.predict(td, pred_contribs=True, approx_contribs=True)
    np.testing.assert_allclose(approx.sum(-1), margin, rtol=0, atol=1e-5)
    inter = tb.predict(td, pred_interactions=True)
    np.testing.assert_allclose(inter.sum(-1), contribs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(inter, np.swapaxes(inter, -1, -2), rtol=0,
                               atol=1e-12)


def test_shapes_and_the_options_they_ignore(models):
    """``[n, F+1]`` / ``[n, K, F+1]`` and the interaction shapes; the
    matrix's ``base_margin``, ``iteration_range`` and ``ntree_limit``
    change nothing, in both packages."""
    jb, tb, jd, td, X = _both(models, "multiclass3")
    n = X.shape[0]
    plain = tb.predict(td, pred_contribs=True)
    assert plain.shape == (n, 3, F + 1)
    assert tb.predict(td, pred_interactions=True).shape == (n, 3, F + 1,
                                                            F + 1)
    bm = np.random.RandomState(0).randn(n, 3).astype(np.float32)
    jd.set_base_margin(bm)
    td.set_base_margin(bm)
    for kw in ({}, {"iteration_range": (0, 1)}, {"ntree_limit": 3}):
        got = tb.predict(td, pred_contribs=True, **kw)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_allclose(
            got, jb.predict(jd, pred_contribs=True, **kw), rtol=0, atol=1e-6)
    _, tb1, _, td1, _ = _both(models, "depth3")
    assert tb1.predict(td1, pred_contribs=True).shape == (n, F + 1)
    assert tb1.predict(td1, pred_interactions=True).shape == (n, F + 1,
                                                              F + 1)


def test_port_trained_booster_matches_its_loaded_json(models):
    """The Booster that trained (device-grown trees) explains as the
    Booster loaded from its JSON."""
    X, y = _data(3, 96)
    tb = xgbt.train({**BASE, "max_depth": 3},
                    xgbt.DMatrix(X, y, device="cpu"), 3, verbose_eval=False)
    loaded = xgbt.Booster(model_file=tb.save_raw(), device="cpu")
    td = xgbt.DMatrix(X, device="cpu")
    np.testing.assert_array_equal(tb.predict(td, pred_contribs=True),
                                  loaded.predict(td, pred_contribs=True))
