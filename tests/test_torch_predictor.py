"""Port parity: the forest walk's plain version against the JAX package.

Forests trained by ``xgboost_tpu`` on the CPU, taken both as the device
heap stack (``GBTreeModel.stacked()`` of device-grown trees) and through
the model JSON, walked by the port's ``predict_margin`` on CPU tensors (the
plain version of kernel B) and by the JAX package's XLA walk
``_predict_margin_impl`` (the JAX Pallas walk has no interpret hook), on
inputs with NaNs and with values sitting exactly on split conditions.
allclose 1e-5.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
from xgboost_tpu.predictor import _predict_margin_impl, stack_forest
import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch.predictor import (forest_from_numpy, predict_leaf,
                                         predict_margin)

torch.set_num_threads(1)

F = 6


def _data(seed, n):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rng.randn(F)) > 0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def jax_model():
    X, y = _data(0, 1024)
    params = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16,
              "eta": 0.5}
    bst = xgb.train(params, xgb.DMatrix(X, label=y), num_boost_round=4,
                    verbose_eval=False)
    heap = bst._gbm.model.stacked()  # device heap layout, before any IO
    assert heap.heap_layout
    return bst, heap


def _on_cut_inputs(forest_cond, forest_feature, forest_left, n=600):
    """Rows with NaNs, plus rows whose split feature equals a node's
    condition exactly."""
    X, _ = _data(1, n)
    internal = np.argwhere(np.asarray(forest_left) >= 0)
    for r, (t, i) in enumerate(internal[: n // 2]):
        X[2 * r, np.asarray(forest_feature)[t, i]] = \
            np.asarray(forest_cond)[t, i]
    return X


def _jax_margin(f, X):
    T = f.left.shape[0]
    return np.asarray(_predict_margin_impl(
        jnp.asarray(X), f.left, f.right, f.feature, f.cond, f.default_left,
        f.split_type, f.cat_bits, f.tree_group, jnp.ones((T,), jnp.float32),
        jnp.zeros((X.shape[0], f.n_groups), jnp.float32), f.n_groups,
        f.max_depth, f.has_cats))


def _port_forest(f):
    return forest_from_numpy(
        np.asarray(f.left), np.asarray(f.right), np.asarray(f.feature),
        np.asarray(f.cond), np.asarray(f.default_left),
        np.asarray(f.tree_group), f.max_depth, f.n_groups)


def test_heap_forest_margins_match(jax_model):
    _, heap = jax_model
    X = _on_cut_inputs(heap.cond, heap.feature, heap.left)
    want = _jax_margin(heap, X)
    forest = _port_forest(heap)
    got = predict_margin(forest, torch.from_numpy(X),
                         torch.zeros((X.shape[0], 1))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    leaves = predict_leaf(forest, torch.from_numpy(X)).numpy()
    assert leaves.shape == (X.shape[0], heap.left.shape[0])


def test_json_forest_margins_match(jax_model):
    bst, _ = jax_model
    raw = bst.save_raw()
    trees = bst._gbm.model.trees
    jf = stack_forest(trees, bst._gbm.model.tree_info, 1)
    X = _on_cut_inputs(jf.cond, jf.feature, jf.left)
    want = _jax_margin(jf, X)
    port = xgbt.Booster(model_file=raw, device="cpu")
    got = port.predict(xgbt.DMatrix(X, device="cpu"), output_margin=True)
    base = json.loads(raw)["learner"]["learner_model_param"]["base_score"]
    assert float(base) == 0.5  # logistic base margin 0
    np.testing.assert_allclose(got, want[:, 0], rtol=1e-5, atol=1e-5)
    # and the JAX package's own public predict agrees
    np.testing.assert_allclose(
        got, bst.predict(xgb.DMatrix(X), output_margin=True),
        rtol=1e-5, atol=1e-5)


def test_walk_routes_on_cut_values_like_host_tree(jax_model):
    """x == cond goes right, NaN follows default_left: the walk agrees with
    the host RegTree oracle row by row."""
    bst, _ = jax_model
    port = xgbt.Booster(model_file=bst.save_raw(), device="cpu")
    trees = port._gbm.model.trees
    f = port._gbm.model.stacked()
    X = _on_cut_inputs(f.cond.numpy(), f.feature.numpy(), f.left.numpy(), 200)
    got = port.predict(xgbt.DMatrix(X, device="cpu"), output_margin=True)
    want = np.array([sum(np.float32(t.predict_one(x)) for t in trees)
                     for x in X], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_groups_and_tree_weights():
    """Per-group sums and tree weights (the DART hook) on a hand-made
    forest: two groups, three stumps."""
    left = np.array([[1, -1, -1]] * 3, np.int32)
    right = np.array([[2, -1, -1]] * 3, np.int32)
    feature = np.zeros((3, 3), np.int32)
    cond = np.array([[0.0, -1.0, 1.0], [0.5, 2.0, 3.0], [0.0, 4.0, 5.0]],
                    np.float32)
    dl = np.array([[True, False, False], [False, False, False],
                   [False, False, False]])
    forest = forest_from_numpy(left, right, feature, cond, dl,
                               np.array([0, 1, 0]), 1, 2)
    X = torch.tensor([[-1.0], [0.25], [float("nan")], [0.5]])
    tw = torch.tensor([1.0, 2.0, 0.5])
    got = predict_margin(forest, X, torch.ones((4, 2)), tw).numpy()
    want = np.array([[1 - 1 + 2.0, 1 + 4.0],
                     [1 + 1 + 2.5, 1 + 4.0],
                     [1 - 1 + 2.5, 1 + 6.0],
                     [1 + 1 + 2.5, 1 + 6.0]], np.float32)
    np.testing.assert_allclose(got, want)


def _table_walk(nodes, X, tree_group, n_groups, max_depth):
    """Kernel B's rule over its node records, in numpy: per step one
    record ``(cond bits, feature | default_left << 30 | leaf << 31, left,
    right)``; stay at a leaf; then add the leaf's value per group."""
    cond = nodes[..., 0].view(np.float32)
    word = nodes[..., 1]
    out = np.zeros((X.shape[0], n_groups), np.float32)
    rows = np.arange(X.shape[0])
    for t in range(nodes.shape[0]):
        node = np.zeros(X.shape[0], np.int64)
        for _ in range(max_depth):
            w = word[t, node]
            v = X[rows, w & ((1 << 30) - 1)]
            goleft = np.where(np.isnan(v), (w >> 30) & 1 == 1,
                              v < cond[t, node])
            nxt = np.where(goleft, nodes[t, node, 2], nodes[t, node, 3])
            node = np.where(w < 0, node, nxt)
        out[:, tree_group[t]] += cond[t, node]
    return out


def _unpack(nodes):
    cond = nodes[..., 0].view(np.float32)
    word = nodes[..., 1]
    return (nodes[..., 2], nodes[..., 3], word & ((1 << 30) - 1), cond,
            (word >> 30) & 1 == 1, word < 0)


def test_packed_node_table_matches_forest_arrays(jax_model):
    """The records hold each node's fields: cond bit for bit, feature (0 at
    leaves), default_left, the leaf flag (left < 0), left and right; for
    the heap stack of device-grown trees and for forests from JSON."""
    bst, heap = jax_model
    port = xgbt.Booster(model_file=bst.save_raw(), device="cpu")
    for f in (_port_forest(heap), port._gbm.model.stacked()):
        assert f.nodes.dtype == torch.int32
        assert tuple(f.nodes.shape) == (*f.left.shape, 4)
        assert torch.equal(f.unit_weights, torch.ones(f.num_trees))
        left, right, feat, cond, dl, leaf = _unpack(f.nodes.numpy())
        internal = f.left.numpy() >= 0
        np.testing.assert_array_equal(left, f.left.numpy())
        np.testing.assert_array_equal(right, f.right.numpy())
        np.testing.assert_array_equal(leaf, ~internal)
        np.testing.assert_array_equal(cond.view(np.int32),
                                      f.cond.numpy().view(np.int32))
        np.testing.assert_array_equal(feat, np.where(internal,
                                                     f.feature.numpy(), 0))
        np.testing.assert_array_equal(dl[internal],
                                      f.default_left.numpy()[internal])


def test_table_walk_matches_jax_predict_margin(jax_model):
    """Kernel B's walk over the packed records (in numpy) against the JAX
    package's walk, for the heap stack and for the JSON-loaded forest, on
    rows with NaNs and values on split conditions: allclose 1e-5."""
    bst, heap = jax_model
    jf = stack_forest(bst._gbm.model.trees, bst._gbm.model.tree_info, 1)
    for jforest in (heap, jf):
        port = _port_forest(jforest)
        X = _on_cut_inputs(jforest.cond, jforest.feature, jforest.left)
        got = _table_walk(port.nodes.numpy(), X, port.tree_group.numpy(),
                          port.n_groups, port.max_depth)
        np.testing.assert_allclose(got, _jax_margin(jforest, X), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("n,F,want", [
    (1000, 50, 1),                         # far below 2^31 elements
    ((1 << 31) // 50, 50, 1),              # the last row below 2^31
    ((1 << 31) // 50 + 1, 50, 2),          # just past 2^31 elements
    (3 * ((1 << 31) // 7), 7, 4),          # three times the bound
    (0, 5, 1),
])
def test_walk_row_chunks_stay_below_2_31_elements(n, F, want):
    """Kernel B's launch plan: chunks cover the rows in order, each holds
    fewer than 2^31 elements and starts at a multiple of 256 rows (X stays
    16-byte aligned)."""
    from xgboost_tpu_torch.predictor import walk_row_chunks

    chunks = walk_row_chunks(n, F)
    assert len(chunks) == want
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    for (lo, hi), (lo2, _) in zip(chunks, chunks[1:]):
        assert hi == lo2
    for lo, hi in chunks:
        assert lo % 256 == 0 and (hi - lo) * F < 1 << 31
