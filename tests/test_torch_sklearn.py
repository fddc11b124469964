"""Port parity: the scikit-learn estimators, ``config`` and the plots
(``xgboost_tpu_torch/sklearn.py``, ``config.py``, ``plotting.py``) against
the JAX package, on the CPU.

Both packages fit the same seeded numpy data (400 x 5 with 5% missing
values; binary, 3-class and regression labels from a linear score, ranking
labels 0-3 in 40 queries of 10) at ``n_estimators`` 3, depth 3,
``max_bin`` 16; the port's estimators with ``device="cpu"``. Tolerances:
predictions, ``predict_proba``, margins and ``apply`` within 1e-5 (classes
exactly), ``feature_importances_`` within 1e-5, ``coef_`` / ``intercept_``
within rtol 1e-5, atol 1e-6 (the linear booster's float32 sums),
the evaluation history within 1e-6. ``get_params`` / ``set_params`` round
trips, ``device`` stays out of the booster parameters, and
``random_state`` becomes the learner's ``seed``.

``config_context`` nests and restores, ``verbosity`` 0 silences the
port's warnings, and the keys that change nothing warn once.
``plot_importance`` draws on matplotlib's Agg backend; ``to_graphviz``'s
source text equals the JAX package's; ``plot_tree`` is checked with the
Graphviz render replaced by a PNG that matplotlib writes (the Graphviz
binaries are not needed).
"""

import io
import warnings

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import xgboost_tpu as xgb  # noqa: E402
import xgboost_tpu_torch as xgbt  # noqa: E402
from xgboost_tpu_torch import config as tconfig  # noqa: E402

torch.set_num_threads(1)

F = 5
KW = dict(n_estimators=3, max_depth=3, max_bin=16)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    n = 400
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    z = np.nan_to_num(X) @ rng.randn(F, 3)
    yb = (z[:, 0] + 0.5 * rng.randn(n) > 0).astype(np.int64)
    ym = np.argmax(z + 0.3 * rng.randn(n, 3), 1)
    yr = (z[:, 1] + 0.1 * rng.randn(n)).astype(np.float32)
    yq = rng.randint(0, 4, n).astype(np.float32)
    Xv = np.nan_to_num(rng.randn(100, F).astype(np.float32))
    return X, yb, ym, yr, yq, Xv


CASES = {
    "classifier": ("XGBClassifier", 1, {}),
    "classifier_labels": ("XGBClassifier", "words", {}),
    "multiclass": ("XGBClassifier", 2, {}),
    "regressor": ("XGBRegressor", 3, {}),
    "gblinear": ("XGBRegressor", 3, dict(booster="gblinear")),
    "rf_classifier": ("XGBRFClassifier", 1, {}),
    "rf_regressor": ("XGBRFRegressor", 3, {}),
    "dart": ("XGBClassifier", 1, dict(booster="dart", rate_drop=0.5)),
}


def _label(data, which):
    if which == "words":
        return np.asarray(["no", "yes"])[data[1]]
    return data[which]


@pytest.mark.parametrize("name", list(CASES))
def test_estimators_match_jax(data, name):
    cls, which, extra = CASES[name]
    X, Xv = data[0], data[5]
    y = _label(data, which)
    # an eval set's labels are not encoded (in either package): numbers only
    ev = dict(eval_set=[(Xv[:50], y[:50])]) if which != "words" else {}
    j = getattr(xgb, cls)(**KW, **extra).fit(X, y, **ev)
    t = getattr(xgbt, cls)(**KW, **extra, device="cpu").fit(X, y, **ev)
    assert t.get_booster().device.type == "cpu"
    jp, tp = j.predict(Xv), t.predict(Xv)
    if cls.endswith("Classifier"):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(t.classes_, j.classes_)
        np.testing.assert_allclose(t.predict_proba(Xv), j.predict_proba(Xv),
                                   rtol=0, atol=1e-5)
        assert t.score(X, y) == j.score(X, y)
    else:
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
        np.testing.assert_allclose(t.score(X, y), j.score(X, y), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(t.predict(Xv, output_margin=True),
                               j.predict(Xv, output_margin=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t.feature_importances_,
                               j.feature_importances_, rtol=0, atol=1e-5)
    assert t.evals_result().keys() == j.evals_result().keys()
    for k, v in j.evals_result().get("validation_0", {}).items():
        np.testing.assert_allclose(t.evals_result()["validation_0"][k], v,
                                   rtol=0, atol=1e-6)
    if extra.get("booster") == "gblinear":
        np.testing.assert_allclose(t.coef_, j.coef_, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t.intercept_, j.intercept_, rtol=1e-5,
                                   atol=1e-6)
        assert t.coef_.shape == (F,) and t.intercept_.shape == (1,)
    else:
        with pytest.raises(AttributeError):
            t.coef_
        np.testing.assert_array_equal(t.apply(Xv), j.apply(Xv))
        assert (t.get_booster()._gbm.model.num_trees
                == j.get_booster()._gbm.model.num_trees)


def test_ranker_matches_jax(data):
    X, yq, Xv = data[0], data[4], data[5]
    qid = np.repeat(np.arange(40), 10)
    j = xgb.XGBRanker(**KW).fit(X, yq, qid=qid)
    t = xgbt.XGBRanker(**KW, device="cpu").fit(X, yq, qid=qid)
    np.testing.assert_allclose(t.predict(Xv), j.predict(Xv), rtol=0,
                               atol=1e-5)
    g = xgbt.XGBRanker(**KW, device="cpu").fit(X, yq, group=[10] * 40)
    np.testing.assert_array_equal(g.predict(Xv), t.predict(Xv))
    with pytest.raises(ValueError, match="group or qid"):
        xgbt.XGBRanker(device="cpu").fit(X, yq)


def test_params_round_trip_and_device_stays_out(data):
    t = xgbt.XGBClassifier(max_depth=4, random_state=7, device="cpu",
                           custom_key=1)
    p = t.get_params()
    assert p["device"] == "cpu" and p["max_depth"] == 4
    assert p["custom_key"] == 1 and p["random_state"] == 7
    again = xgbt.XGBClassifier(**p)
    assert again.get_params() == p
    assert again.set_params(max_depth=2, other=3) is again
    assert again.max_depth == 2 and again.get_params()["other"] == 3
    xp = t.get_xgb_params()
    assert "device" not in xp and "random_state" not in xp
    assert xp["seed"] == 7 and xp["custom_key"] == 1
    X, y = data[0], data[1]
    t.set_params(custom_key=None, n_estimators=2, max_bin=16)
    t.fit(X, y)
    assert t.get_booster().lparam.seed == 7  # stays at the learner
    assert t.get_booster()._gbm.train_param.seed == 0


def test_save_load_and_best_iteration(data, tmp_path):
    X, y, Xv = data[0], data[1], data[5]
    t = xgbt.XGBClassifier(n_estimators=20, max_depth=2, max_bin=16,
                           early_stopping_rounds=2, device="cpu")
    yv = np.random.RandomState(5).randint(0, 2, 50)
    t.fit(X, y, eval_set=[(Xv[:50], yv)])
    j = xgb.XGBClassifier(n_estimators=20, max_depth=2, max_bin=16,
                          early_stopping_rounds=2)
    j.fit(X, y, eval_set=[(Xv[:50], yv)])
    assert t.best_iteration == j.best_iteration is not None
    path = str(tmp_path / "m.json")
    t.save_model(path)
    back = xgbt.XGBClassifier(device="cpu")
    back.load_model(path)
    np.testing.assert_array_equal(
        back.get_booster().predict(xgbt.DMatrix(Xv, device="cpu")),
        t.get_booster().predict(xgbt.DMatrix(Xv, device="cpu")))


def test_config_context_nests_and_restores():
    assert xgbt.get_config() == {"verbosity": 1, "use_x64": False,
                                 "deterministic_histogram": True,
                                 "trace_path": None}
    with xgbt.config_context(verbosity=0):
        assert xgbt.get_config()["verbosity"] == 0
        with xgbt.config_context(verbosity=2):
            assert xgbt.get_config()["verbosity"] == 2
        assert xgbt.get_config()["verbosity"] == 0
        with pytest.raises(RuntimeError):
            with xgbt.config_context(verbosity=3):
                raise RuntimeError
        assert xgbt.get_config()["verbosity"] == 0
    assert xgbt.get_config()["verbosity"] == 1
    with pytest.raises(ValueError, match="Unknown global config key"):
        xgbt.set_config(not_a_key=1)
    assert xgbt.get_config() == xgb.get_config()


def test_verbosity_zero_silences_the_ports_warnings(data):
    X, y = data[0], data[1]
    d = xgbt.DMatrix(X, y, device="cpu")
    params = {"max_bin": 16, "sketch_eps": 0.1}
    with warnings.catch_warnings(record=True) as loud:
        warnings.simplefilter("always")
        xgbt.train(params, d, 1, verbose_eval=False)
    assert any("sketch_eps" in str(w.message) for w in loud)
    with warnings.catch_warnings(record=True) as quiet:
        warnings.simplefilter("always")
        with xgbt.config_context(verbosity=0):
            xgbt.train(params, d, 1, verbose_eval=False)
    assert not quiet


def test_inert_keys_warn_once(monkeypatch):
    monkeypatch.setattr(tconfig, "_said", set())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            with xgbt.config_context(use_x64=True,
                                     deterministic_histogram=False,
                                     trace_path="t.jsonl"):
                pass
        with xgbt.config_context(use_x64=False):
            pass
    said = [str(w.message) for w in caught]
    assert len(said) == 2, said
    for key in ("use_x64", "deterministic_histogram"):
        assert sum(key in s for s in said) == 1
    # trace_path turns span tracing on: not an inert key
    assert not any("trace_path" in s for s in said)


def test_plots(data, monkeypatch):
    import matplotlib.pyplot as plt

    X, y = data[0], data[1]
    t = xgbt.XGBClassifier(**KW, device="cpu").fit(X, y)
    raw = t.get_booster().save_raw()
    jb = xgb.Booster(model_file=raw)
    ax = xgbt.plot_importance(t, max_num_features=3)
    labels = [tl.get_text() for tl in ax.get_yticklabels()]
    score = t.get_booster().get_score()
    assert labels == sorted(score, key=score.get)[-3:]
    assert ax.get_title() == "Feature importance"
    with pytest.raises(ValueError, match="Booster or XGBModel"):
        xgbt.plot_importance(object())
    for k in (0, 2):
        got = xgbt.to_graphviz(t, num_trees=k, rankdir="LR").source
        assert got == xgb.to_graphviz(jb, num_trees=k, rankdir="LR").source
        assert "digraph" in got and "leaf=" in got
    png = io.BytesIO()
    plt.imsave(png, np.zeros((4, 4, 3)), format="png")
    import graphviz

    monkeypatch.setattr(graphviz.Source, "pipe",
                        lambda self, format=None: png.getvalue())
    ax = xgbt.plot_tree(t.get_booster(), num_trees=1)
    assert ax.images and not ax.axison
    plt.close("all")


def test_dmatrix_get_data_and_num_nonmissing(data):
    X = data[0]
    jd, td = xgb.DMatrix(X), xgbt.DMatrix(X, device="cpu")
    assert td.num_nonmissing() == jd.num_nonmissing() == int(
        np.count_nonzero(~np.isnan(X)))
    a, b = td.get_data(), jd.get_data()
    assert a.shape == b.shape and (a != b).nnz == 0
