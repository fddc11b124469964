"""The benchmark's plain reference on hand-worked cases (CPU), and its
comparison with the port at a small size (on the card; skips without one).

Run: ``python -m pytest portbench/tests -q`` (on the card:
``python -m pytest portbench/tests -q -m cuda``).
"""

import math
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import lookup  # noqa: E402
from portbench.reference import quantile, threefry  # noqa: E402
from portbench.reference import tree as rtree  # noqa: E402

P = rtree.Params(max_depth=1, eta=0.5)


def test_threefry_known_answer():
    # Random123's known answer of threefry2x32 (20 rounds), key 0, counter 0
    assert threefry.threefry_2x32(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)
    u = threefry.uniform(7, 3, 2, "cpu")
    assert u.shape == (3, 2) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # partitionable stream: a shorter draw is a prefix of a longer one
    assert torch.equal(threefry.uniform(7, 6, 1, "cpu").reshape(-1)[:4],
                       threefry.uniform(7, 2, 2, "cpu").reshape(-1))


def test_cuts_and_bins_by_hand():
    X = torch.tensor([[4.0, float("nan")], [1.0, 2.0], [3.0, float("nan")],
                      [2.0, 5.0]])
    values, mins = quantile.cuts(X, 4)
    # feature 0: m = 4, levels 1, 2, 3 -> sorted ranks 0, 1, 2; sentinel 4 + 4
    assert values[0].tolist() == [1.0, 2.0, 3.0, 8.0]
    # feature 1: m = 2, levels 0.5, 1, 1.5 -> ranks 0, 0, 1; sentinel 5 + 5
    assert values[1].tolist() == [2.0, 2.0, 5.0, 10.0]
    assert mins.tolist() == [1.0, 2.0]
    b = quantile.bins(X, values)
    # bin = cuts at or below the value, at most 3; NaN -> 4
    assert b[:, 0].tolist() == [3, 1, 3, 2]
    assert b[:, 1].tolist() == [4, 2, 4, 3]


def test_logistic_gradient_by_hand():
    logistic = lookup.objective("binary:logistic")
    g, h = logistic.gradient(torch.tensor([[0.0], [math.log(3.0)]]),
                             torch.tensor([1.0, 0.0]), None, 0)
    assert g.shape == h.shape == (2, 1) and g.dtype == torch.float64
    assert g[:, 0].tolist() == pytest.approx([-0.5, 0.75])
    assert h[:, 0].tolist() == pytest.approx([0.25, 0.1875])
    assert logistic.base_margin({}) == 0.0 and logistic.outputs({}) == 1
    assert lookup.objective("rank:ndcg").base_margin({}) == 0.5


def test_ndcg_gradient_two_rows():
    # one query of two rows, grades 1 and 0, tied margins: ranks 0 and 1 in
    # row order, IDCG 1, |delta NDCG| = 1 - 1/log2(3); each row's one
    # opponent is the other row or itself (no pair); the sampler's weight
    # is 2 * (1/1 + 1/1) / 2 = 2 and rho = 1/2
    y = torch.tensor([1.0, 0.0])
    g, h = lookup.objective("rank:ndcg").ndcg(torch.tensor([0.5, 0.5]), y,
                                              torch.tensor([2]), 3)
    u = threefry.uniform((3 * 2654435761) & 0x7FFFFFFF, 2, 1, "cpu")
    j = torch.minimum((u[:, 0] * 2.0).long(), torch.tensor(1))
    pairs = int(j[0] == 1) + int(j[1] == 0)
    lam = 0.5 * (1.0 - 1.0 / math.log2(3.0)) * 2.0
    assert g.tolist() == pytest.approx([-lam * pairs, lam * pairs])
    assert h.tolist() == pytest.approx([max(lam * pairs, 1e-16)] * 2)


def test_weight_and_gain_by_hand():
    G, H = torch.tensor([-2.0, 1.0]), torch.tensor([3.0, 0.5])
    assert rtree.calc_weight(G, H, P).tolist() == [0.5, 0.0]  # H < 1: 0
    assert rtree.calc_gain(G, H, P).tolist() == [1.0, 0.0]


def _toy():
    X = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    values, _ = quantile.cuts(X, 4)
    return X, values, quantile.bins(X, values)


def test_grow_one_split_by_hand():
    X, values, bins = _toy()
    g = torch.tensor([-1.0, -1.0, 1.0, 1.0], dtype=torch.float64)
    h = torch.ones(4, dtype=torch.float64)
    t = rtree.grow(bins, values, g, h, P)
    # best: the rows of x = 1, 2 left (bin <= 2, that is x < cut[2] = 3)
    assert bool(t.is_split[0]) and int(t.feature[0]) == 0
    assert float(t.cond[0]) == float(values[0, 2])
    # leaves: eta * -G / (H + 1) = 0.5 * 2/3 and 0.5 * -2/3
    assert t.value[1:3].tolist() == pytest.approx([1.0 / 3.0, -1.0 / 3.0])
    assert rtree.leaf_of(t, X, 1).tolist() == [1, 1, 2, 2]
    r = rtree.judge(t, X, bins, 4, g, h, P)
    assert r["gain_gap"] == 0.0 and r["leaf_gap"] < 1e-7


def test_judge_sees_a_worse_split_and_a_wrong_leaf():
    X, values, bins = _toy()
    g = torch.tensor([-1.0, -1.0, 1.0, 1.0], dtype=torch.float64)
    h = torch.ones(4, dtype=torch.float64)
    t = rtree.grow(bins, values, g, h, P)
    worse = rtree.HeapTree(t.is_split, t.feature, torch.tensor([2.0, 0, 0]),
                           t.default_left, t.value.clone())
    # x < 2 sends one row left: chosen 1/2 + 1/4 against the best 8/3
    r = rtree.judge(worse, X, bins, 4, g, h, P)
    assert r["gain_gap"] == pytest.approx((8 / 3 - 0.75) / (8 / 3))
    wrong = rtree.HeapTree(t.is_split, t.feature, t.cond, t.default_left,
                           t.value * torch.tensor([1.0, 1.01, 1.0]))
    # leaf 1: w = 2/3, off by 1%; its unit eta * (sum|g| + w sum h) / (H + 1)
    # = 0.5 * (4 + 8/3) / 3
    assert rtree.judge(wrong, X, bins, 4, g, h, P)["leaf_gap"] == pytest.approx(
        0.01 * 0.5 * (2 / 3) / (0.5 * (4 + 8 / 3) / 3), rel=1e-4)


def test_metrics_by_hand():
    auc, ndcg, map_at, logloss = (lookup.metric(k)[0]
                                  for k in ("auc", "ndcg@2", "map@2", "logloss"))
    s = torch.tensor([0.1, 0.4, 0.35, 0.8])
    y = torch.tensor([0.0, 0.0, 1.0, 1.0])
    assert auc.auc(s, y) == pytest.approx(0.75)
    assert auc.auc(torch.zeros(4), y) == pytest.approx(0.5)  # all tied
    sizes = torch.tensor([3, 1])
    score = torch.tensor([0.3, 0.2, 0.1, 0.0])
    lab = torch.tensor([0.0, 2.0, 1.0, 0.0])
    # query 0 ranked (0, 2, 1): DCG@2 = 0 + 3/log2(3); ideal 3 + 1/log2(3);
    # query 1 has no relevant row: 1
    q0 = (3.0 / math.log2(3.0)) / (3.0 + 1.0 / math.log2(3.0))
    assert ndcg.ndcg(score, lab, sizes, 2) == pytest.approx((q0 + 1.0) / 2)
    assert ndcg.evaluate(score[:, None], lab, sizes, "2") == pytest.approx((q0 + 1.0) / 2)
    # map@2, query 0: one relevant row in the top 2, at rank 2 (1/2), over
    # its 2 relevant rows
    assert map_at.map_at(score, lab, sizes, 2) == pytest.approx((0.25 + 1.0) / 2)
    p = torch.tensor([0.5, 0.25])
    ll = -(math.log(0.5) + math.log(0.75)) / 2
    assert logloss.logloss(p, torch.tensor([1.0, 0.0])) == pytest.approx(ll)


def test_logloss_clips_in_the_predictions_own_type():
    # a float32 probability of 1 against label 0 is clipped to 1 - 1e-7 in
    # float32, which is 1 - 2**-23: a loss of 23 log 2, not log(1e7)
    logloss = lookup.metric("logloss")[0]
    one = torch.tensor([1.0], dtype=torch.float32)
    assert logloss.logloss(one, torch.tensor([0.0])) == pytest.approx(23 * math.log(2.0),
                                                                     rel=1e-12)
    assert logloss.logloss(one.double(), torch.tensor([0.0])) == pytest.approx(
        7 * math.log(10.0), rel=1e-9)
    # at a margin of 17 the float32 probability is 1, and the clip decides
    m = torch.tensor([[17.0]], dtype=torch.float32)
    assert logloss.evaluate(m, torch.tensor([0.0]), None, None) == pytest.approx(
        23 * math.log(2.0), rel=1e-12)


@pytest.mark.cuda
def test_port_on_the_card_against_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import harness

    r = harness.run_cell("synth-binary.1m-bin256", 2**31 + 5, 1.0, False, "cuda",
                         overrides={"rows": 60000, "eval_rows": 10000})
    assert r["correct"], r["checks"]
    assert harness.forbidden_modules() == []
