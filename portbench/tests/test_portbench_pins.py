"""The data rules, objectives and metrics, found by name, give the arrays
and numbers they gave before they were moved into files of their own.

The sha256 of each rule's rows and labels and of each objective's
gradients, and each metric's value, were recorded from the harness as it
was when ``traffic.make`` drew both rules itself and ``reference/objective.py``
and ``reference/metric.py`` named each objective and metric in a
dispatcher (on the CPU). A name without a file raises with the path it
looked for.

Run: ``python -m pytest portbench/tests -q``.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness, lookup, traffic, work  # noqa: E402

RULES = {
    ("make_classification", 2**31 + 5):
        "6420ffb9ea3a00650c5ae54d6a654f794574ff3ce537b4f668619f97997abce4",
    ("make_classification", 7):
        "226b47bfdce886d82f654ae2933361c7054d7f36147cb2d54f0cbad30344c0be",
    ("grades", 2**31 + 9):
        "1dce38d7815ed3bf3d7c581defcd37fdef00f7129328a50ef6c820e144ecf1f7",
    ("grades", 3):
        "26a554546d1c538fce37e51c2f5bb2fc2a1d6218d7e4957a1476f82e110fb7f3",
}
#: each rule at a small size of the cell that draws it
SMALL = {
    "make_classification": ("synth-binary.1m-bin256", {"rows": 3000, "eval_rows": 1001}),
    "grades": ("mslr-ndcg.web10k", {"rows": 2400, "queries": 20, "eval_rows": 600,
                                    "eval_queries": 5}),
}
GRADIENTS = {
    ("binary:logistic", 0): "946e5188deeadc332856cc2673a8b38836066445829a1c2b093c39eb00335457",
    ("rank:ndcg", 0): "55163dba40f9a53df6e553be5066d0980af6657ccf5e0de235c87e474c04c618",
    ("rank:ndcg", 3): "8f9827427fa44d8019bc115dc5bf850c118aafdcdfca1f4afdabe0f8c59ce3cb",
}
METRICS = {
    "auc": "0x1.05b4fe95723b5p-1",
    "logloss": "0x1.5fd033a88ed61p+0",
    "ndcg@10": "0x1.3891d42f1f61ep-2",
    "map@10": "0x1.3720be480bc62p-3",
    "ndcg@3": "0x1.4806018fe70dep-2",
}


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        if a is not None:
            a = a.contiguous().numpy() if torch.is_tensor(a) else np.ascontiguousarray(a)
            h.update(a.tobytes())
    return h.hexdigest()


def _inputs():
    """Seeded margins and labels: 1,000 binary rows, and 600 graded rows
    in 10 queries of 30-90."""
    gen = torch.Generator().manual_seed(1234)
    margin = torch.randn(1000, generator=gen) * 3
    y = torch.randint(0, 2, (1000,), generator=gen).float()
    sizes = torch.as_tensor(traffic.query_sizes(10, 600, 30, 90))
    mr = torch.randn(600, generator=gen)
    yr = torch.randint(0, 5, (600,), generator=gen).float()
    return {"binary": (margin[:, None], y, None), "rank": (mr[:, None], yr, sizes)}


@pytest.mark.parametrize("rule,seed", sorted(RULES))
def test_a_rule_draws_the_rows_it_drew_before_it_moved(rule, seed):
    cell, sizes = SMALL[rule]
    c = harness.cell(cell)
    t = dict(c["traffic"], **sizes)
    assert lookup.rule(c["config"]).__file__.endswith(os.path.join("rules", rule + ".py"))
    d = traffic.make(c["config"], t, seed, "cpu")
    assert _sha(d.train.X, d.train.y, d.train.sizes, d.valid.X, d.valid.y,
                d.valid.sizes) == RULES[(rule, seed)]


def test_make_classification_labels_n_classes():
    c = harness.cell("synth-binary.1m-bin256")
    config = dict(c["config"], data=dict(c["config"]["data"], n_classes=5, features=6,
                                         informative=6, clusters_per_class=1))
    d = traffic.make(config, {"rows": 5000, "eval_rows": 500}, 11, "cpu")
    assert set(d.train.y.tolist()) == {0.0, 1.0, 2.0, 3.0, 4.0}
    # one cluster a class, equal in size; flip_y redraws 1% among the 5
    counts = np.bincount(d.train.y.astype(np.int64))
    assert counts.min() > 950 and counts.max() < 1050


@pytest.mark.parametrize("objective,iteration", sorted(GRADIENTS))
def test_an_objective_gives_the_gradients_it_gave_before_it_moved(objective, iteration):
    mod = lookup.objective(objective)
    margin, y, sizes = _inputs()["rank" if objective == "rank:ndcg" else "binary"]
    g, h = mod.gradient(margin, y, sizes, iteration)
    assert g.shape == h.shape == margin.shape and g.dtype == h.dtype == torch.float64
    assert _sha(g, h) == GRADIENTS[(objective, iteration)]
    assert mod.outputs({"objective": objective}) == 1


@pytest.mark.parametrize("name", sorted(METRICS))
def test_a_metric_gives_the_value_it_gave_before_it_moved(name):
    mod, arg = lookup.metric(name)
    margin, y, sizes = _inputs()["rank" if "@" in name else "binary"]
    assert float(mod.evaluate(margin, y, sizes, arg)).hex() == METRICS[name]


@pytest.mark.parametrize("find,path", [
    (lambda: lookup.rule({"data": {"label": "no_such_rule"}}), "rules/no_such_rule.py"),
    (lambda: lookup.objective("multi:no_such"), "reference/objectives/multi_no_such.py"),
    (lambda: lookup.metric("no_such@3"), "reference/metrics/no_such.py"),
    (lambda: work.gradient("reg:no_such", 10), "reference/objectives/reg_no_such.py"),
    (lambda: harness.reader("no_such.binary"), "metrics/no_such.binary.py"),
])
def test_a_name_without_a_file_raises_with_the_path(find, path):
    with pytest.raises(FileNotFoundError) as e:
        find()
    assert os.path.join(lookup.BENCH, path) in str(e.value)
