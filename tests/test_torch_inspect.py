"""Port parity for the model-inspection surface and ``save_raw``: one model
JSON, trained by the JAX package (3 classes, so 3 trees a round, on
numerical and categorical features: trees with numerical splits, one-hot
and partition nodes), is loaded into both packages, and each function
returns what the JAX package's returns on it: ``get_dump`` (text, json,
dot and dot with attributes; with and without stats; with a feature map of
types ``q``, ``c``, ``i`` and ``int``), ``dump_model`` files,
``get_score`` of the five types and ``get_fscore``, ``trees_to_dataframe``,
``get_split_value_histogram``, ``save_config`` (equal on the keys both
packages have; ``CONFIG_ONLY_JAX`` lists the others) and its round trip
through ``load_config``, and ``save_raw`` for each format (the JAX package
writes the JSON bytes for ``"ubj"`` and ``"deprecated"`` too). Strings and
bytes are compared exactly, importances and histograms exactly (both sum
the same float32 values in the same order).
"""

import json

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt

torch.set_num_threads(1)

CPU = dict(device="cpu")
NAMES = ["a", "b", "c", "d", "e"]
TYPES = ["q", "c", "q", "c", "int"]
FMAP = "0 a q\n1 b c\n2 c i\n3 d q\n4 e int\n"
#: learner_train_param keys of the JAX package's LearnerParam that the
#: port's lacks (the device is the Booster's own)
CONFIG_ONLY_JAX = {"device"}


def _data(seed=0, n=600):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5).astype(np.float32)
    X[:, 1] = rng.randint(0, 3, n)  # one-hot regime (< max_cat_to_onehot)
    X[:, 3] = rng.randint(0, 9, n)  # partition regime
    X[:, 4] = np.round(X[:, 4] * 3)
    X[rng.rand(n, 5) < 0.05] = np.nan
    score = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 3]) % 3
             + rng.randn(n) * 0.3)
    y = (score > 1).astype(np.float32) + (X[:, 1] == 2)
    return X, y


@pytest.fixture(scope="module")
def models():
    """(JAX Booster, port Booster) holding one JAX-trained model."""
    X, y = _data()
    d = xgb.DMatrix(X, label=y, feature_types=TYPES, feature_names=NAMES)
    params = {"objective": "multi:softprob", "num_class": 3, "max_depth": 3,
              "max_bin": 16, "eta": 0.5}
    raw = xgb.train(params, d, 2).save_raw()
    jb = xgb.Booster(model_file=bytearray(raw))
    tb = xgbt.Booster(model_file=raw, **CPU)
    split_types = [set(t["split_type"]) for t in json.loads(raw)[
        "learner"]["gradient_booster"]["model"]["trees"]]
    assert {0, 1} <= set().union(*split_types)
    return jb, tb


@pytest.fixture
def fmap(tmp_path):
    p = tmp_path / "featmap.txt"
    p.write_text(FMAP)
    return str(p)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("dump_format", [
    "text", "json", "dot",
    'dot:{"rankdir": "LR", "edge": {"yes_color": "#00FF00"}, '
    '"condition_node_params": {"shape": "box"}, '
    '"leaf_node_params": {"shape": "oval"}, '
    '"graph_attrs": {"size": "8,8"}}'])
def test_get_dump_matches_jax(models, fmap, dump_format, with_stats):
    jb, tb = models
    for fm in ("", fmap):
        got = tb.get_dump(fm, with_stats, dump_format)
        assert got == jb.get_dump(fm, with_stats, dump_format)
        assert len(got) == 6
    if dump_format == "text":  # the feature map's types shape the lines
        text = "\n".join(tb.get_dump(fmap))
        assert "[c]" in text and "{" in text


def test_dump_model_files_match_jax(models, fmap, tmp_path):
    jb, tb = models
    for fmt in ("text", "json"):
        for lib, b in (("jax", jb), ("port", tb)):
            b.dump_model(str(tmp_path / f"{lib}.{fmt}"), fmap, True, fmt)
        assert (tmp_path / f"port.{fmt}").read_text() == \
            (tmp_path / f"jax.{fmt}").read_text()
    dumped = json.loads((tmp_path / "port.json").read_text())
    assert len(dumped) == 6 and dumped[0]["nodeid"] == 0


def test_unknown_dump_format_and_missing_fmap_raise(models):
    for b in models:
        with pytest.raises(ValueError, match="Unknown dump format"):
            b.get_dump(dump_format="yaml")
        with pytest.raises(ValueError, match="featmap"):
            b.get_dump("no-such-featmap.txt")


@pytest.mark.parametrize("importance_type",
                         ["weight", "gain", "cover", "total_gain",
                          "total_cover"])
def test_get_score_matches_jax(models, fmap, importance_type):
    jb, tb = models
    for fm in ("", fmap):
        got = tb.get_score(fm, importance_type)
        assert got == jb.get_score(fm, importance_type)
        assert set(got) <= set(NAMES) and got
    with pytest.raises(ValueError, match="importance_type"):
        tb.get_score(importance_type="split")


def test_get_fscore_matches_jax(models):
    jb, tb = models
    assert tb.get_fscore() == jb.get_fscore() == tb.get_score()


def test_trees_to_dataframe_matches_jax(models):
    import pandas as pd

    jb, tb = models
    got, want = tb.trees_to_dataframe(), jb.trees_to_dataframe()
    pd.testing.assert_frame_equal(got, want)
    assert list(got.columns) == ["Tree", "Node", "ID", "Feature", "Split",
                                 "Yes", "No", "Missing", "Gain", "Cover"]


@pytest.mark.parametrize("bins", [None, 3])
def test_split_value_histogram_matches_jax(models, bins):
    import pandas as pd

    jb, tb = models
    for feature in ("a", "c", "e"):
        got = tb.get_split_value_histogram(feature, bins=bins,
                                           as_pandas=False)
        want = jb.get_split_value_histogram(feature, bins=bins,
                                            as_pandas=False)
        np.testing.assert_array_equal(got, want)
        pd.testing.assert_frame_equal(
            tb.get_split_value_histogram(feature, bins=bins),
            jb.get_split_value_histogram(feature, bins=bins))
    for b in (jb, tb):  # a categorical feature; an unknown one
        with pytest.raises(ValueError, match="categorical"):
            b.get_split_value_histogram("d")
        with pytest.raises(ValueError, match="unknown feature"):
            b.get_split_value_histogram("zz")


def test_names_default_to_f_and_index(models):
    """A model without feature names dumps and scores ``f<i>``."""
    X, y = _data(1, 300)
    raw = xgb.train({"max_depth": 2, "max_bin": 16},
                    xgb.DMatrix(X, label=y), 2).save_raw()
    jb = xgb.Booster(model_file=bytearray(raw))
    tb = xgbt.Booster(model_file=raw, **CPU)
    assert tb.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    assert tb.get_score() == jb.get_score()
    assert all(k.startswith("f") for k in tb.get_score())
    np.testing.assert_array_equal(
        tb.get_split_value_histogram("f0", as_pandas=False),
        jb.get_split_value_histogram("f0", as_pandas=False))


@pytest.mark.parametrize("raw_format", ["json", "ubj", "deprecated"])
def test_save_raw_bytes_match_jax_for_each_format(models, raw_format):
    jb, tb = models
    got = tb.save_raw(raw_format)
    assert got == jb.save_raw(raw_format)
    assert json.loads(got)["learner"]["objective"]["name"] == \
        "multi:softprob"


def test_save_config_matches_jax_on_shared_keys(models):
    jb, tb = models
    for b in (jb, tb):
        b.set_param({"eta": 0.2, "max_depth": 4, "eval_metric": "mlogloss"})
    got = json.loads(tb.save_config())
    want = json.loads(jb.save_config())
    assert got["version"] == want["version"]
    tl, jl = got["learner"], want["learner"]
    assert set(tl) == set(jl)
    assert tl["objective"] == jl["objective"]
    assert tl["gradient_booster"] == jl["gradient_booster"]
    tp, jp = tl["learner_train_param"], jl["learner_train_param"]
    assert set(jp) - set(tp) == CONFIG_ONLY_JAX and set(tp) <= set(jp)
    assert {k: tp[k] for k in tp} == {k: jp[k] for k in tp}


def test_load_config_round_trip_trains_the_same_next_round():
    """A fresh Booster given the model and ``load_config`` of the
    original's configuration grows the original's next tree."""
    X, y = _data(2, 400)
    params = {"objective": "rank:ndcg", "max_depth": 3, "max_bin": 16,
              "eta": 0.4, "lambda": 2.0, "eval_metric": ["ndcg@3"]}
    d = xgbt.DMatrix(X, y, group=[100] * 4, **CPU)
    bst = xgbt.train(params, d, 2, verbose_eval=False)
    fresh = xgbt.Booster(**CPU)
    fresh.load_model(bst.save_raw())
    fresh.load_config(bst.save_config())
    # load_config forwards the learner's max_delta_step to the booster's
    # parameters, as the JAX package's does
    want = json.loads(bst.save_config())
    want["learner"]["gradient_booster"]["params"]["max_delta_step"] = 0.0
    assert json.loads(fresh.save_config()) == want
    # both take the next round's margins from the forest walk: the
    # original's cache, summed leaf by leaf onto the base margin of 0.5,
    # can round differently from a walk
    bst._caches.clear()
    for b in (bst, fresh):
        b.update(d, 2)
    assert fresh.save_raw() == bst.save_raw()
    assert fresh.eval(d) == bst.eval(d)
    # the JAX package reads the port's configuration
    jb = xgb.Booster()
    jb.load_config(bst.save_config())
    assert jb.lparam.objective == "rank:ndcg"
    assert jb.lparam.eval_metric == ["ndcg@3"]
