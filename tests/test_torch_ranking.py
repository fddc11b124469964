"""Port parity for ranking: query groups, the LambdaMART objectives
(``rank:pairwise``/``rank:ndcg``/``rank:map`` on the all-pairs and the
sampled-pair path), the ranking metrics and the grouped AUC, each against
the JAX package on the same inputs, made from a seed with numpy.

Tolerances. The port forms every gradient term in float64 and rounds once
(so that the card and the CPU compute the same bits); the JAX package
computes in float32. So:

- gradients and hessians (``_lambda_grad``, ``_lambda_grad_sampled`` and
  ``get_gradient`` with weights) within rtol 1e-5 and atol 1e-6 of the
  array's largest magnitude. The sampled path draws the JAX package's
  opponents (``threefry``, bitwise ``jax.random``), so this tolerance
  holds there too, but for ``rank:map``: the JAX package's sampled MAP
  scan takes float32 prefix sums over the whole prediction sort and
  subtracts each group's base, which loses precision as the row count
  grows (ROADMAP queue 3; the port scans each group in float64). At the
  ~350 rows here its gradients are held within rtol 1e-4 and atol 1e-5 of
  the largest magnitude (``SAMPLED_MAP``);
- ``ndcg``/``map``/``pre`` (with and without ``@n`` and ``-``) within 1e-12
  (both sum in float64); ``ams@`` within 1e-6 relative (the JAX package
  sums its weights in float32); the grouped ``auc`` within 2e-5 (the JAX
  package's segment sums are float32);
- 3 rounds of training at depth 3, ``max_bin`` 16, the JAX package pinned
  to its per-level float route: the trees have the same structure,
  features and split conditions (exact), the margins agree within 1e-5
  (relative, atol 1e-5) and the eval histories within one unit of their
  6th decimal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu.objective import ranking as jrank
from xgboost_tpu.registry import create_metric as j_metric
from xgboost_tpu_torch import threefry
from xgboost_tpu_torch.data.dmatrix import QueryGroups
from xgboost_tpu_torch.metric import create_metric as t_metric
from xgboost_tpu_torch.objective import ranking as trank

torch.set_num_threads(1)

CPU = dict(device="cpu")
SCHEMES = ("pairwise", "ndcg", "map")
OBJECTIVES = ("rank:pairwise", "rank:ndcg", "rank:map")
BASE = {"max_depth": 3, "max_bin": 16, "eta": 0.3}
DISPATCH = "tree_grow=level,sibling_sub=off,hist_acc=float"


#: the sampled MAP path's tolerance against the JAX package's float32 scan
SAMPLED_MAP = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, rtol=1e-5, atol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _groups(seed, sizes=(1, 5, 12, 30, 7, 19, 2, 1, 64)):
    """Margins, graded labels 0-4 and the group pointer; groups of size 1
    among them."""
    rng = np.random.RandomState(seed)
    sizes = np.asarray(sizes)
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    n = int(ptr[-1])
    m = rng.randn(n).astype(np.float32)
    y = rng.randint(0, 5, n).astype(np.float32)
    return m, y, ptr


def _jax_layout(ptr):
    sizes = np.diff(ptr)
    group_of = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    rig = np.concatenate([np.arange(s, dtype=np.int32) for s in sizes])
    starts = np.asarray(ptr[:-1], np.int32)
    return sizes, group_of, rig, starts


@pytest.mark.parametrize("tied", [False, True], ids=["margins", "round0"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_all_pairs_gradients_match_jax(scheme, tied):
    """The padded all-pairs path; ``round0``: every margin equal (the base
    score), so every rank comes from tie-breaking by row order."""
    m, y, ptr = _groups(0)
    if tied:
        m[:] = 0.5
    sizes, group_of, rig, _ = _jax_layout(ptr)
    jg, jh = jrank._lambda_grad(jnp.asarray(m), jnp.asarray(y),
                                jnp.asarray(group_of), jnp.asarray(rig),
                                len(sizes), int(sizes.max()), scheme)
    tg, th = trank._lambda_grad(torch.tensor(m), torch.tensor(y),
                                QueryGroups(ptr, "cpu"), scheme)
    _close(tg.float(), jg)
    _close(th.float(), jh)


@pytest.mark.parametrize("n_pair", [1, 3])
@pytest.mark.parametrize("tied", [False, True], ids=["margins", "round0"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sampled_gradients_match_jax(scheme, tied, n_pair):
    """The sampled-pair path on the JAX package's opponents: the key of
    round 7 and ``n_pair`` draws per row."""
    m, y, ptr = _groups(1, sizes=(1, 40, 200, 3, 1, 90, 17))
    if tied:
        m[:] = 0.5
    sizes, group_of, _, starts = _jax_layout(ptr)
    seed = 7 * 2654435761 & 0x7FFFFFFF
    jg, jh = jrank._lambda_grad_sampled(
        jnp.asarray(m), jnp.asarray(y), jnp.asarray(group_of),
        jnp.asarray(starts[group_of]),
        jnp.asarray(sizes.astype(np.int32)[group_of]),
        jax.random.PRNGKey(seed), len(sizes), n_pair, scheme)
    tg, th = trank._lambda_grad_sampled(
        torch.tensor(m), torch.tensor(y), QueryGroups(ptr, "cpu"),
        threefry.prng_key(seed), n_pair, scheme)
    tol = SAMPLED_MAP if scheme == "map" else {}
    _close(tg.float(), jg, **tol)
    _close(th.float(), jh, **tol)


@pytest.mark.parametrize("weights", ["none", "group", "row"])
@pytest.mark.parametrize("path", ["all_pairs", "sampled"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_get_gradient_matches_jax(objective, path, weights, monkeypatch):
    """``get_gradient`` at round 5 with per-group weights (normalised by
    ``n_groups / sum(w)``), per-row weights or none; the sampled path
    forced by a budget of 16 elements in both packages."""
    from xgboost_tpu.objective import create_objective as j_create
    from xgboost_tpu.params import LearnerParam as JParam
    from xgboost_tpu_torch.objective import create_objective as t_create
    from xgboost_tpu_torch.params import LearnerParam as TParam

    if path == "sampled":
        monkeypatch.setattr(jrank, "_ALL_PAIRS_BUDGET", 16)
        monkeypatch.setattr(trank, "_ALL_PAIRS_BUDGET", 16)
    m, y, ptr = _groups(2)
    rng = np.random.RandomState(3)
    n, G = len(m), len(ptr) - 1
    w = {"none": None, "group": rng.uniform(0.2, 3.0, G),
         "row": rng.uniform(0.2, 3.0, n)}[weights]
    w = None if w is None else w.astype(np.float32)
    params = {"objective": objective, "lambdarank_num_pair_per_sample": 2}
    jg, jh = j_create(objective, JParam(**params)).get_gradient(
        jnp.asarray(m), jnp.asarray(y), None if w is None else jnp.asarray(w),
        5, group_ptr=ptr)
    tg, th = t_create(objective, TParam(**params)).get_gradient(
        torch.tensor(m), torch.tensor(y),
        None if w is None else torch.tensor(w), 5,
        groups=QueryGroups(ptr, "cpu"))
    assert tg.dtype == th.dtype == torch.float32
    tol = SAMPLED_MAP if (path, objective) == ("sampled", "rank:map") else {}
    _close(tg, jg, **tol)
    _close(th, jh, **tol)


RANK_METRICS = ["ndcg", "ndcg@3", "ndcg-", "ndcg@2-", "map", "map@5",
                "map-", "map@2-", "pre", "pre@3"]


@pytest.mark.parametrize("name", RANK_METRICS)
def test_rank_metrics_match_jax(name):
    """Groups with ties in the scores, an empty group and a group without
    relevant rows (1 or 0 by the ``-`` suffix)."""
    rng = np.random.RandomState(4)
    sizes = rng.randint(1, 30, 40)
    sizes[3] = 0
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    n = int(ptr[-1])
    y = rng.randint(0, 5, n).astype(np.float32)
    y[ptr[5]:ptr[6]] = 0
    p = np.round(rng.randn(n), 1).astype(np.float32)
    want = j_metric(name).evaluate(jnp.asarray(p), jnp.asarray(y), None,
                                   group_ptr=ptr)
    got = t_metric(name).evaluate(torch.tensor(p), torch.tensor(y), None,
                                  groups=QueryGroups(ptr, "cpu"))
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    # one group of every row when the matrix has none
    want = j_metric(name).evaluate(jnp.asarray(p), jnp.asarray(y), None)
    got = t_metric(name).evaluate(torch.tensor(p), torch.tensor(y), None)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("name", ["ams@0.15", "ams@0.5"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ams_matches_jax(name, weighted):
    rng = np.random.RandomState(5)
    n = 500
    p = np.round(rng.randn(n), 2).astype(np.float32)
    y = (rng.rand(n) < 0.3).astype(np.float32)
    w = rng.uniform(0.1, 2.0, n).astype(np.float32) if weighted else None
    want = j_metric(name).evaluate(jnp.asarray(p), jnp.asarray(y), w)
    got = t_metric(name).evaluate(torch.tensor(p), torch.tensor(y),
                                  None if w is None else torch.tensor(w))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("weights", ["none", "row", "group"])
def test_grouped_auc_matches_jax(weights):
    """Per-group AUCs of ``label > 0`` over groups with both classes (a
    group with one class and one of one row among them); per-group weights
    are ignored, as the JAX package ignores any weights that are not one
    per row; without groups the label is not binarised (one group)."""
    rng = np.random.RandomState(6)
    sizes = rng.randint(2, 25, 30)
    sizes[4] = 1
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    n = int(ptr[-1])
    y = rng.randint(0, 3, n).astype(np.float32)
    y[ptr[7]:ptr[8]] = 2
    p = np.round(rng.randn(n), 1).astype(np.float32)
    w = {"none": None, "row": rng.uniform(0.2, 2.0, n),
         "group": rng.uniform(0.2, 2.0, len(sizes))}[weights]
    w = None if w is None else w.astype(np.float32)
    want = j_metric("auc").evaluate(jnp.asarray(p), jnp.asarray(y), w,
                                    group_ptr=ptr)
    got = t_metric("auc").evaluate(torch.tensor(p), torch.tensor(y),
                                   None if w is None else torch.tensor(w),
                                   groups=QueryGroups(ptr, "cpu"))
    assert got == pytest.approx(want, abs=2e-5)
    yb = (y > 0).astype(np.float32)
    want = j_metric("auc").evaluate(jnp.asarray(p), jnp.asarray(yb), None,
                                    group_ptr=np.array([0, n]))
    got = t_metric("auc").evaluate(torch.tensor(p), torch.tensor(yb), None,
                                   groups=QueryGroups([0, n], "cpu"))
    assert got == pytest.approx(want, abs=2e-5)


# the reference's fixtures (tests/cpp/metric/test_rank_metric.cc, as
# tests/test_golden_parity.py:403-428 carries them: values copied)
RANK_GOLDEN = [
    ("ams@0.5", [0, 1], [0, 1], 0.311, 0.001, None),
    ("ams@0.5", [0.1, 0.9, 0.1, 0.9], [0, 0, 1, 1], 0.29710, 0.001, None),
    ("pre@2", [0, 1], [0, 1], 0.5, 1e-6, None),
    ("pre@2", [0.1, 0.9, 0.1, 0.9], [0, 0, 1, 1], 0.5, 0.001, None),
    ("ndcg", [0, 1], [0, 1], 1.0, 1e-8, None),
    ("ndcg", [0.1, 0.9, 0.1, 0.9], [0, 0, 1, 1], 0.6509, 0.001, None),
    ("ndcg@2", [0.1, 0.9, 0.1, 0.9], [0, 0, 1, 1], 0.3868, 0.001, None),
    ("ndcg-", [0.1, 0.9, 0.1, 0.9], [0, 0, 1, 1], 0.6509, 0.001, None),
    ("ndcg@2-", [0.1, 0.9, 0.1, 0.9], [0, 0, 1, 1], 0.3868, 0.001, None),
    ("map", [0, 1], [0, 1], 1.0, 1e-8, None),
    ("map", [0.1, 0.9, 0.1, 0.9], [0, 0, 1, 1], 0.5, 0.001, None),
    ("map", [0.1, 0.9, 0.2, 0.8, 0.4, 1.7], [2, 7, 1, 0, 5, 0], 0.8611,
     0.001, [0, 2, 5, 6]),
    ("map@2", [0.1, 0.9, 0.1, 0.9], [0, 0, 1, 1], 0.25, 0.001, None),
]


@pytest.mark.parametrize("case", range(len(RANK_GOLDEN)))
def test_golden_rank_metric(case):
    name, preds, labels, want, tol, ptr = RANK_GOLDEN[case]
    groups = None if ptr is None else QueryGroups(ptr, "cpu")
    got = t_metric(name).evaluate(torch.tensor(preds, dtype=torch.float32),
                                  torch.tensor(labels, dtype=torch.float32),
                                  None, groups=groups)
    assert got == pytest.approx(want, abs=tol)


# ---------------------------------------------------------------------------
# the group API
# ---------------------------------------------------------------------------

def test_group_api_matches_jax():
    rng = np.random.RandomState(7)
    X = rng.rand(10, 3).astype(np.float32)
    qid = np.array([3, 3, 1, 1, 1, 7, 7, 7, 7, 2])
    j = xgb.DMatrix(X, label=np.arange(10), qid=qid)
    t = xgbt.DMatrix(X, np.arange(10), qid=qid, **CPU)
    np.testing.assert_array_equal(t.get_group(), j.get_group())
    for field in ("group", "group_ptr"):
        a, b = t.get_uint_info(field), j.get_uint_info(field)
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.group_ptr, [0, 2, 5, 9, 10])
    for d in (j, t):
        d.set_group([4, 6])
    np.testing.assert_array_equal(t.get_group(), j.get_group())
    for d in (j, t):
        d.set_uint_info("group_ptr", [0, 1, 10])
    np.testing.assert_array_equal(t.get_group(), j.get_group())
    for d in (j, t):
        d.set_info(qid=np.repeat([5, 6], 5), weight=np.arange(10.0))
    np.testing.assert_array_equal(t.get_group(), j.get_group())
    np.testing.assert_array_equal(t.get_weight(), j.get_weight())
    for d in (j, t):
        with pytest.raises(ValueError, match="unknown uint field"):
            d.set_uint_info("label", [1])
        with pytest.raises(ValueError, match="unknown uint field"):
            d.get_uint_info("label")
        with pytest.raises(ValueError, match="allow_groups"):
            d.slice([0, 1])
        s = d.slice([0, 1, 2], allow_groups=True)
        assert s.num_row() == 3 and len(s.get_group()) == 0
    plain = xgbt.DMatrix(X, **CPU)
    assert plain.group_ptr is None and len(plain.get_group()) == 0
    assert plain.get_uint_info("group").dtype == np.uint32


def test_per_row_group_tensors_are_built_once():
    d = xgbt.DMatrix(np.zeros((6, 1), np.float32), group=[2, 1, 3], **CPU)
    group_of, start, size = d.groups.rows()
    assert d.groups.rows()[0] is group_of
    assert group_of.tolist() == [0, 0, 1, 2, 2, 2]
    assert start.tolist() == [0, 0, 2, 3, 3, 3]
    assert size.tolist() == [2, 2, 1, 3, 3, 3]


@pytest.mark.parametrize("sizes", [[4, 4], [4, 7], [0, 5, 4]])
def test_groups_that_do_not_cover_the_rows_raise(sizes):
    """Query sizes must sum to the row count: training and the ranking
    metrics raise ValueError otherwise (an input check of the port)."""
    X = np.random.RandomState(9).rand(9, 2).astype(np.float32)
    y = (np.arange(9) % 3).astype(np.float32)
    d = xgbt.DMatrix(X, y, group=sizes, **CPU)
    if sum(sizes) == 9:  # covers the rows: trains and evaluates
        xgbt.train({"objective": "rank:ndcg"}, d, 1, evals=[(d, "d")],
                   verbose_eval=False)
        return
    with pytest.raises(ValueError, match="query groups cover"):
        xgbt.train({"objective": "rank:ndcg"}, d, 1, verbose_eval=False)
    for name in ("ndcg", "auc"):
        with pytest.raises(ValueError, match="query groups cover"):
            t_metric(name).evaluate(torch.tensor(y), torch.tensor(y), None,
                                    groups=d.groups)


def test_cv_on_a_grouped_matrix_raises_as_jax_does():
    X = np.random.RandomState(8).rand(12, 2).astype(np.float32)
    y = np.arange(12) % 3
    for lib, kw in ((xgb, {}), (xgbt, CPU)):
        d = lib.DMatrix(X, y, group=[6, 6], **kw)
        with pytest.raises(ValueError, match="allow_groups"):
            lib.cv({"objective": "rank:ndcg"}, d, 2, nfold=2)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _rank_data(seed=11):
    """Queries of 8-40 rows, 6 features with 5% NaNs and a per-query
    offset; graded labels 0-4 from the within-query score. The last 10
    queries are held out."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(8, 40, 50)
    n, F = int(sizes.sum()), 6
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    X[:, 5] += np.repeat(rng.randn(len(sizes)) * 2, sizes)
    s = np.nan_to_num(X[:, :5]) @ rng.randn(5)
    y = np.clip(np.round(s + 0.5 * rng.randn(n)), 0, 4).astype(np.float32)
    cut = int(sizes[:40].sum())
    return X, y, sizes, cut


def _trees(b):
    j = b.save_json() if isinstance(b, xgbt.Booster) else json.loads(
        b.save_raw())
    return j["learner"]["gradient_booster"]["model"]["trees"]


def _assert_same(jb, tb, jres, tres, Xv):
    jt, tt = _trees(jb), _trees(tb)
    assert len(jt) == len(tt) == 3
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        internal = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[internal],
            np.asarray(b["split_conditions"], np.float32)[internal])
    np.testing.assert_allclose(
        tb.predict(xgbt.DMatrix(Xv, **CPU), output_margin=True),
        jb.predict(xgb.DMatrix(Xv), output_margin=True), rtol=1e-5,
        atol=1e-5)
    assert list(tres["val"]) == list(jres["val"])
    for name, vals in jres["val"].items():
        np.testing.assert_allclose(
            np.rint(np.asarray(tres["val"][name]) * 1e6),
            np.rint(np.asarray(vals) * 1e6), rtol=0, atol=1)


def _train_both(params, X, y, sizes, cut, weight=None):
    nq = 40
    tr_kw = dict(group=sizes[:nq])
    va_kw = dict(group=sizes[nq:])
    jd = xgb.DMatrix(X[:cut], label=y[:cut], **tr_kw)
    td = xgbt.DMatrix(X[:cut], y[:cut], **tr_kw, **CPU)
    if weight is not None:  # after the first binning
        for d in (jd, td):
            d.get_binned(params["max_bin"])
            d.set_weight(weight)
    jv = xgb.DMatrix(X[cut:], label=y[cut:], **va_kw)
    tv = xgbt.DMatrix(X[cut:], y[cut:], **va_kw, **CPU)
    jres, tres = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XGBTPU_DISPATCH", DISPATCH)
        jax.clear_caches()
        jb = xgb.train(params, jd, 3, evals=[(jv, "val")], evals_result=jres,
                       verbose_eval=False)
    tb = xgbt.train(params, td, 3, evals=[(tv, "val")], evals_result=tres,
                    verbose_eval=False)
    return jb, tb, jres, tres


@pytest.mark.parametrize("path", ["all_pairs", "sampled"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_training_matches_jax(objective, path, monkeypatch):
    """3 rounds with the default metric, ``ndcg@5``, ``pre@3``, ``map-`` and
    the grouped ``auc`` on held-out queries; the sampled path forced in
    both packages (budget 16) with 2 opponents per row."""
    params = {**BASE, "objective": objective,
              "eval_metric": ["ndcg@5", "pre@3", "map-", "auc"]}
    if path == "sampled":
        monkeypatch.setattr(jrank, "_ALL_PAIRS_BUDGET", 16)
        monkeypatch.setattr(trank, "_ALL_PAIRS_BUDGET", 16)
        params["lambdarank_num_pair_per_sample"] = 2
    X, y, sizes, cut = _rank_data()
    jb, tb, jres, tres = _train_both(params, X, y, sizes, cut)
    _assert_same(jb, tb, jres, tres, X[cut:])


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_default_metric_and_max_pairs_match_jax(objective):
    """No ``eval_metric``: the objective's default (``map`` for pairwise
    and map, ``ndcg`` for ndcg); ``max_pairs`` is accepted and changes
    nothing, as in the JAX package."""
    params = {**BASE, "objective": objective, "max_pairs": 7}
    X, y, sizes, cut = _rank_data(12)
    jb, tb, jres, tres = _train_both(params, X, y, sizes, cut)
    _assert_same(jb, tb, jres, tres, X[cut:])
    assert list(tres["val"]) == [{"rank:ndcg": "ndcg"}.get(objective, "map")]


def test_group_weights_set_after_the_first_binning_train_as_jax():
    """Per-group weights set once the bins are cached: both packages train
    on those bins and weigh the gradients per group."""
    X, y, sizes, cut = _rank_data(13)
    w = np.random.RandomState(14).uniform(0.2, 3.0, 40).astype(np.float32)
    jb, tb, jres, tres = _train_both({**BASE, "objective": "rank:ndcg"},
                                     X, y, sizes, cut, weight=w)
    _assert_same(jb, tb, jres, tres, X[cut:])


def test_group_weights_at_the_first_binning_raise_as_jax():
    """Per-group weights present when the matrix is first binned: the
    sketch takes one weight per row, and both packages raise."""
    X, y, sizes, cut = _rank_data(13)
    w = np.ones(40, np.float32)
    for lib, kw in ((xgb, {}), (xgbt, CPU)):
        d = lib.DMatrix(X[:cut], y[:cut], weight=w, group=sizes[:40], **kw)
        with pytest.raises(ValueError):
            lib.train({**BASE, "objective": "rank:ndcg"}, d, 1,
                      verbose_eval=False)
