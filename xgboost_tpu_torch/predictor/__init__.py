"""Forest walk -> margins.

The port of the JAX package's ``predictor/__init__.py`` (reference
``src/predictor/gpu_predictor.cu``, one thread per row, :286). Trees are
stacked into padded struct-of-arrays tensors [T, N]; every (row, tree) walks
at most ``max_depth`` steps: go left iff ``x < cond``, NaN goes to the
default child, leaves have ``left == -1`` and hold their value in ``cond``.

``predict_margin`` launches kernel B (``csrc/predict_walk.cu``, replacing
the TPU kernel ``_predict_margin_pallas``) on a CUDA tensor and runs the
plain version (``_walk_leaves`` + the per-group sum) on a CPU tensor.
Kernel B reads the forest as one 16-byte record per node
(``_pack_nodes``), built once when the forest is stacked, as the JAX
package builds its walk tables once (``_build_pred_tables``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import _build

__all__ = ["StackedForest", "stack_forest", "forest_from_numpy",
           "predict_margin", "predict_leaf"]


class StackedForest(NamedTuple):
    """Padded SoA forest: [T, N] tensors on one device + per-tree groups."""

    left: torch.Tensor  # int32 [T, N]
    right: torch.Tensor  # int32 [T, N]
    feature: torch.Tensor  # int32 [T, N]
    cond: torch.Tensor  # f32 [T, N] (leaf value at leaves)
    default_left: torch.Tensor  # bool [T, N]
    tree_group: torch.Tensor  # int32 [T]
    max_depth: int  # walk bound
    n_groups: int
    num_feature: int  # inputs need at least this many columns
    # forests with categorical nodes are a later slice; kept for the
    # JAX package's field list
    has_cats: bool = False
    heap_layout: bool = False
    # kernel B's node records (``_pack_nodes``) and unit tree weights, made
    # once by the stacking functions (None: the wrapper makes them per call)
    nodes: Optional[torch.Tensor] = None  # int32 [T, N, 4]
    unit_weights: Optional[torch.Tensor] = None  # f32 [T]

    @property
    def num_trees(self) -> int:
        return int(self.left.shape[0])


_LEAF_BIT, _DEFAULT_LEFT_BIT = 31, 30


def _pack_nodes(left, right, feature, cond, default_left) -> torch.Tensor:
    """Kernel B's node records, int32 ``[T, N, 4]``: per node the bits of
    ``cond`` (the leaf value at a leaf), ``feature | default_left << 30 |
    leaf << 31`` (feature 0 at a leaf), ``left``, ``right``; a leaf is a
    node with ``left < 0``. Plain torch, on the forest's device."""
    leaf = left < 0
    word = (torch.where(leaf, 0, feature).long()
            | (default_left.long() << _DEFAULT_LEFT_BIT)
            | (leaf.long() << _LEAF_BIT))
    word = torch.where(word >= 1 << 31, word - (1 << 32), word)
    return torch.stack([cond.float().contiguous().view(torch.int32),
                        word.to(torch.int32), left.to(torch.int32),
                        right.to(torch.int32)], dim=-1).contiguous()


def with_walk_tables(forest: "StackedForest") -> "StackedForest":
    """``forest`` with kernel B's node records and unit tree weights."""
    return forest._replace(
        nodes=_pack_nodes(forest.left, forest.right, forest.feature,
                          forest.cond, forest.default_left),
        unit_weights=torch.ones(forest.num_trees, dtype=torch.float32,
                                device=forest.cond.device))


def forest_from_numpy(left, right, feature, cond, default_left, tree_group,
                      max_depth: int, n_groups: int,
                      device=None, heap_layout: bool = False) -> StackedForest:
    """A StackedForest from numpy arrays, e.g. a JAX ``StackedForest``'s
    fields (``np.asarray`` of each)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    left = np.asarray(left, np.int32)
    feature = np.asarray(feature, np.int32)
    internal = left >= 0
    nf = int(feature[internal].max()) + 1 if internal.any() else 0

    def t(a, dt):
        return torch.tensor(np.asarray(a, dt), device=dev)

    return with_walk_tables(StackedForest(
        left=t(left, np.int32), right=t(right, np.int32),
        feature=t(feature, np.int32), cond=t(cond, np.float32),
        default_left=t(default_left, bool),
        tree_group=t(tree_group, np.int32), max_depth=int(max_depth),
        n_groups=int(n_groups), num_feature=nf, heap_layout=heap_layout))


def stack_forest(trees: Sequence, tree_info: Sequence[int], n_groups: int,
                 device=None) -> StackedForest:
    """Pad host ``RegTree``s to a uniform node count and stack them."""
    T = len(trees)
    N = max([t.num_nodes for t in trees] + [1])
    md = max([t.max_depth() for t in trees] + [1])

    def pad(get, fill, dtype):
        out = np.full((T, N), fill, dtype=dtype)
        for i, tr in enumerate(trees):
            v = get(tr)
            out[i, :len(v)] = v
        return out

    return forest_from_numpy(
        pad(lambda t: t.left_children, -1, np.int32),
        pad(lambda t: t.right_children, -1, np.int32),
        pad(lambda t: t.split_indices, 0, np.int32),
        pad(lambda t: t.split_conditions, 0.0, np.float32),
        pad(lambda t: t.default_left, False, bool),
        np.asarray(tree_info, np.int32).reshape(T), md, n_groups, device)


def _walk_leaves(X: torch.Tensor, left, right, feature, cond, default_left,
                 max_depth: int) -> torch.Tensor:
    """Leaf index of every (tree, row): int64 [T, n] (the plain walk)."""
    T = left.shape[0]
    n = X.shape[0]
    rows = torch.arange(n, device=X.device)[None, :].expand(T, n)
    pos = torch.zeros((T, n), dtype=torch.int64, device=X.device)
    for _ in range(max_depth):
        lc = torch.gather(left, 1, pos).long()
        leaf = lc < 0
        f = torch.gather(feature, 1, pos).long()
        v = X[rows, f]
        goleft = torch.where(torch.isnan(v), torch.gather(default_left, 1, pos),
                             v < torch.gather(cond, 1, pos))
        nxt = torch.where(goleft, lc, torch.gather(right, 1, pos).long())
        pos = torch.where(leaf, pos, nxt)
    return pos


def _predict_margin_plain(forest: StackedForest, X: torch.Tensor,
                          base_margin: torch.Tensor,
                          tree_weights: torch.Tensor) -> torch.Tensor:
    """The plain version: per tree (in order), walk, then add leaf x
    weight to the tree's group column; out = base + sum."""
    out = torch.zeros((X.shape[0], max(forest.n_groups, 1)),
                      dtype=torch.float32, device=X.device)
    groups: List[int] = forest.tree_group.tolist()
    for t, g in enumerate(groups):
        sl = slice(t, t + 1)
        leaf = _walk_leaves(X, forest.left[sl], forest.right[sl],
                            forest.feature[sl], forest.cond[sl],
                            forest.default_left[sl], forest.max_depth)[0]
        out[:, g] += forest.cond[t][leaf] * tree_weights[t]
    return base_margin + out


def _predict_margin_cuda(forest: StackedForest, X: torch.Tensor,
                         base_margin: torch.Tensor,
                         tree_weights: torch.Tensor) -> torch.Tensor:
    """Launch kernel B. Checks what the kernel takes and raises otherwise."""
    what = "predict_margin"
    if forest.has_cats:
        raise NotImplementedError(
            f"{what}: categorical forests are not ported to CUDA yet")
    if forest.nodes is None:
        forest = with_walk_tables(forest)
    tensors = (X, base_margin, tree_weights, forest.nodes, forest.tree_group)
    for t in tensors:
        _build.require_kernel_device(t, what)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: forest and inputs on different devices")
    n, F = X.shape
    T, N = forest.left.shape
    G = max(forest.n_groups, 1)
    if X.dtype != torch.float32:
        raise ValueError(f"{what}: X must be float32")
    if tuple(base_margin.shape) != (n, G) or base_margin.dtype != torch.float32:
        raise ValueError(f"{what}: base_margin must be float32 [{n}, {G}]")
    if n * F >= 1 << 31:
        raise ValueError(f"{what}: n * F must be below 2^31")
    X = X.contiguous()
    if X.data_ptr() % 16:  # the kernel reads X in 16-byte vectors
        X = X.clone()
    base = base_margin.contiguous()
    nodes = forest.nodes.contiguous()
    group = forest.tree_group.contiguous()
    tw = tree_weights.to(torch.float32).contiguous()
    out = torch.empty((n, G), dtype=torch.float32, device=X.device)
    lib = _build.library("predict_walk")
    status = lib.xgbt_predict_margin(
        X.data_ptr(), n, F, nodes.data_ptr(), group.data_ptr(), tw.data_ptr(),
        T, N, forest.max_depth, G, base.data_ptr(), out.data_ptr(),
        _build.stream_of(X.device))
    _build.check_status(status, what)
    predict_margin.launches += 1
    return out


def predict_margin(forest: StackedForest, X: torch.Tensor,
                   base_margin: torch.Tensor,
                   tree_weights: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """[n, n_groups] raw margins (base + forest sums): kernel B on a CUDA
    tensor, the plain version on a CPU tensor. ``predict_margin.launches``
    counts kernel B's launches."""
    if forest.num_trees == 0:
        return base_margin
    if X.shape[1] < forest.num_feature:
        raise ValueError(
            f"feature count mismatch: model needs >= {forest.num_feature} "
            f"features, input has {X.shape[1]}")
    if tree_weights is None:
        tree_weights = (forest.unit_weights if forest.unit_weights is not None
                        else torch.ones(forest.num_trees, dtype=torch.float32,
                                        device=X.device))
    if X.device.type == "cpu":
        return _predict_margin_plain(forest, X, base_margin, tree_weights)
    return _predict_margin_cuda(forest, X, base_margin, tree_weights)


predict_margin.launches = 0


def predict_leaf(forest: StackedForest, X: torch.Tensor) -> torch.Tensor:
    """[n, T] leaf indices (reference: pred_leaf), by the plain walk."""
    if forest.num_trees == 0:
        return torch.zeros((X.shape[0], 0), dtype=torch.int32, device=X.device)
    return _walk_leaves(X, forest.left, forest.right, forest.feature,
                        forest.cond, forest.default_left,
                        forest.max_depth).t().to(torch.int32)
