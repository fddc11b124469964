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
package builds its walk tables once (``_build_pred_tables``). A launch
covers at most 2^31 - 1 elements of X; larger inputs go through the same
kernel in row chunks (``walk_row_chunks``).

A forest with categorical nodes (``has_cats``) takes the categorical walk
instead, on every device: a categorical node sends a present value right
iff its code is in the node's category bitset (``cat_bits``). The JAX
package keeps such forests off its Pallas walk and walks them with XLA
(``_walk_leaves`` there), so their port is plain torch, as
``partition_apply`` is, not a kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..resilience import chaos

__all__ = ["StackedForest", "stack_forest", "forest_from_numpy",
           "pack_cat_bits", "walk_row_chunks", "predict_margin",
           "predict_leaf"]


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
    # categorical nodes present: the forest takes the categorical walk
    has_cats: bool = False
    heap_layout: bool = False
    # kernel B's node records (``_pack_nodes``) and unit tree weights, made
    # once by the stacking functions (None: the wrapper makes them per call)
    nodes: Optional[torch.Tensor] = None  # int32 [T, N, 4]
    unit_weights: Optional[torch.Tensor] = None  # f32 [T]
    # with has_cats: which nodes split on a category, and each node's
    # right-going category set as W words of 32 bits (category c is bit
    # c % 32 of word c // 32; the JAX package's uint32 words, as int32)
    split_type: Optional[torch.Tensor] = None  # bool [T, N]
    cat_bits: Optional[torch.Tensor] = None  # int32 [T, N, W]

    @property
    def num_trees(self) -> int:
        return int(self.left.shape[0])


_LEAF_BIT, _DEFAULT_LEFT_BIT = 31, 30


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` -> int32 with the same 32 bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def _pack_nodes(left, right, feature, cond, default_left) -> torch.Tensor:
    """Kernel B's node records, int32 ``[T, N, 4]``: per node the bits of
    ``cond`` (the leaf value at a leaf), ``feature | default_left << 30 |
    leaf << 31`` (feature 0 at a leaf), ``left``, ``right``; a leaf is a
    node with ``left < 0``. Plain torch, on the forest's device."""
    leaf = left < 0
    word = (torch.where(leaf, 0, feature).long()
            | (default_left.long() << _DEFAULT_LEFT_BIT)
            | (leaf.long() << _LEAF_BIT))
    return torch.stack([cond.float().contiguous().view(torch.int32),
                        _to_int32_bits(word), left.to(torch.int32),
                        right.to(torch.int32)], dim=-1).contiguous()


def with_walk_tables(forest: "StackedForest") -> "StackedForest":
    """``forest`` with kernel B's node records and unit tree weights."""
    return forest._replace(
        nodes=_pack_nodes(forest.left, forest.right, forest.feature,
                          forest.cond, forest.default_left),
        unit_weights=torch.ones(forest.num_trees, dtype=torch.float32,
                                device=forest.cond.device))


def pack_cat_bits(cat_set: torch.Tensor) -> torch.Tensor:
    """``[..., B]`` bool right-going sets -> ``[..., W]`` int32 bitsets,
    ``W = ceil(B / 32)`` (the JAX package's ``_pack_cat_bits``, without
    its power-of-two padding of W). Plain torch, on the sets' device."""
    B = cat_set.shape[-1]
    W = max(1, -(-B // 32))
    pad = torch.zeros((*cat_set.shape[:-1], W * 32 - B), dtype=torch.bool,
                      device=cat_set.device)
    bits = torch.cat([cat_set.bool(), pad], dim=-1)
    bits = bits.reshape(*cat_set.shape[:-1], W, 32).long()
    weights = torch.ones(32, dtype=torch.int64, device=cat_set.device) \
        << torch.arange(32, device=cat_set.device)
    return _to_int32_bits((bits * weights).sum(dim=-1))


def forest_from_numpy(left, right, feature, cond, default_left, tree_group,
                      max_depth: int, n_groups: int,
                      device=None, heap_layout: bool = False,
                      split_type=None, cat_bits=None) -> StackedForest:
    """A StackedForest from numpy arrays, e.g. a JAX ``StackedForest``'s
    fields (``np.asarray`` of each). ``split_type`` [T, N] and ``cat_bits``
    [T, N, W] (uint32 or int32 words) describe categorical nodes; the
    forest has categories when some node's ``split_type`` is set."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    left = np.asarray(left, np.int32)
    feature = np.asarray(feature, np.int32)
    internal = left >= 0
    nf = int(feature[internal].max()) + 1 if internal.any() else 0

    def t(a, dt):
        return torch.tensor(np.asarray(a, dt), device=dev)

    cats = {}
    if split_type is not None and np.asarray(split_type).any():
        words = np.asarray(cat_bits)
        cats = dict(has_cats=True, split_type=t(split_type, bool),
                    cat_bits=torch.tensor(
                        words.astype(np.uint32).view(np.int32), device=dev))
    return with_walk_tables(StackedForest(
        left=t(left, np.int32), right=t(right, np.int32),
        feature=t(feature, np.int32), cond=t(cond, np.float32),
        default_left=t(default_left, bool),
        tree_group=t(tree_group, np.int32), max_depth=int(max_depth),
        n_groups=int(n_groups), num_feature=nf, heap_layout=heap_layout,
        **cats))


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

    split_type = pad(lambda t: t.categorical_nodes(), False, bool)
    cats = {(k, i): t.node_categories(i) for k, t in enumerate(trees)
            for i in np.flatnonzero(split_type[k, :t.num_nodes])}
    sets = np.zeros((T, N, max([int(c.max()) + 1 for c in cats.values()]
                               + [1])), bool)
    for (k, i), cs in cats.items():
        sets[k, i, cs[cs >= 0]] = True
    return forest_from_numpy(
        pad(lambda t: t.left_children, -1, np.int32),
        pad(lambda t: t.right_children, -1, np.int32),
        pad(lambda t: t.split_indices, 0, np.int32),
        pad(lambda t: t.split_conditions, 0.0, np.float32),
        pad(lambda t: t.default_left, False, bool),
        np.asarray(tree_info, np.int32).reshape(T), md, n_groups, device,
        split_type=split_type,
        cat_bits=pack_cat_bits(torch.from_numpy(sets)).numpy())


def _in_cat_set(v: torch.Tensor, cat_bits: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Whether each value ``v`` [T, n] is in the bitset of its tree's node
    ``pos`` [T, n]. The code is ``v`` cut toward zero, as the JAX walk's
    int32 cast cuts it; codes outside ``[0, 32 W)`` and NaN are in no set."""
    T, N, W = cat_bits.shape
    in_range = (v > -1.0) & (v < 32.0 * W)
    code = torch.where(in_range, v, torch.zeros_like(v)).long()
    word = torch.gather(cat_bits.reshape(T, N * W), 1, pos * W + (code >> 5))
    return in_range & (((word.long() >> (code & 31)) & 1) == 1)


def _walk_leaves(X: torch.Tensor, left, right, feature, cond, default_left,
                 max_depth: int, split_type=None, cat_bits=None
                 ) -> torch.Tensor:
    """Leaf index of every (tree, row): int64 [T, n] (the plain walk).
    With ``split_type``/``cat_bits``, a categorical node sends a present
    value left iff its code is NOT in the node's set (the JAX package's
    ``_walk_leaves`` with ``has_cats``)."""
    T = left.shape[0]
    n = X.shape[0]
    rows = torch.arange(n, device=X.device)[None, :].expand(T, n)
    pos = torch.zeros((T, n), dtype=torch.int64, device=X.device)
    for _ in range(max_depth):
        lc = torch.gather(left, 1, pos).long()
        leaf = lc < 0
        f = torch.gather(feature, 1, pos).long()
        v = X[rows, f]
        present_left = v < torch.gather(cond, 1, pos)
        if split_type is not None:
            present_left = torch.where(torch.gather(split_type, 1, pos),
                                       ~_in_cat_set(v, cat_bits, pos),
                                       present_left)
        goleft = torch.where(torch.isnan(v), torch.gather(default_left, 1, pos),
                             present_left)
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


def _predict_margin_cat(forest: StackedForest, X: torch.Tensor,
                        base_margin: torch.Tensor,
                        tree_weights: torch.Tensor) -> torch.Tensor:
    """The categorical walk, on every device (the JAX package's XLA
    ``_predict_margin_impl`` with ``has_cats``): every tree at once, then
    leaf x weight added to the tree's group column in tree order, the
    association of the plain version and of kernel B."""
    leaves = _walk_leaves(X, forest.left, forest.right, forest.feature,
                          forest.cond, forest.default_left, forest.max_depth,
                          forest.split_type, forest.cat_bits)
    vals = torch.gather(forest.cond, 1, leaves) * tree_weights[:, None]
    G = max(forest.n_groups, 1)
    out = torch.zeros((X.shape[0], G), dtype=torch.float32, device=X.device)
    groups = [0] * forest.num_trees if G == 1 else forest.tree_group.tolist()
    for t, g in enumerate(groups):
        out[:, g] += vals[t]
    return base_margin + out


#: kernel B addresses one launch's X with 32-bit element offsets
_WALK_MAX_ELEMS = (1 << 31) - 1
#: kernel B's rows per block: chunks that start at a multiple keep X's
#: 16-byte alignment
_WALK_ROW_STEP = 256


def walk_row_chunks(n: int, F: int):
    """Row ranges ``[lo, hi)`` of kernel B's launches over an ``[n, F]``
    input: each holds fewer than 2^31 elements and starts at a multiple of
    256 rows. One range when ``n * F < 2^31``. Rows walk independently, so
    the chunks give the bits of one launch."""
    if n * F <= _WALK_MAX_ELEMS:
        return [(0, n)]
    step = (_WALK_MAX_ELEMS // F) // _WALK_ROW_STEP * _WALK_ROW_STEP
    if step == 0:
        raise ValueError(f"predict_margin: {F} features are too many for "
                         "one block of kernel B")
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)]


def _predict_margin_cuda(forest: StackedForest, X: torch.Tensor,
                         base_margin: torch.Tensor,
                         tree_weights: torch.Tensor) -> torch.Tensor:
    """Launch kernel B, once per row chunk (``walk_row_chunks``). Checks
    what the kernel takes and raises otherwise."""
    what = "predict_margin"
    if forest.has_cats:
        raise NotImplementedError(
            f"{what}: kernel B walks numerical forests only; categorical "
            "forests take the categorical walk")
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
    X = X.contiguous()
    if X.data_ptr() % 16:  # the kernel reads X in 16-byte vectors
        X = X.clone()
    base = base_margin.contiguous()
    nodes = forest.nodes.contiguous()
    group = forest.tree_group.contiguous()
    tw = (tree_weights if tree_weights.dtype == torch.float32
          else tree_weights.to(torch.float32)).contiguous()
    out = torch.empty((n, G), dtype=torch.float32, device=X.device)
    lib = _build.library("predict_walk")
    for lo, hi in walk_row_chunks(n, F):
        status = lib.xgbt_predict_margin(
            X[lo:].data_ptr(), hi - lo, F, nodes.data_ptr(), group.data_ptr(),
            tw.data_ptr(), T, N, forest.max_depth, G, base[lo:].data_ptr(),
            out[lo:].data_ptr(), _build.stream_of(X.device))
        _build.check_status(status, what)
        predict_margin.launches += 1
    return out


def predict_margin(forest: StackedForest, X: torch.Tensor,
                   base_margin: torch.Tensor,
                   tree_weights: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """[n, n_groups] raw margins (base + forest sums, each tree's leaf
    times its weight in ``tree_weights``, one per tree; default 1): for a
    numerical forest kernel B on a CUDA tensor, the plain version on a CPU
    tensor (``predict_margin.launches`` counts kernel B's launches); for a
    forest with categorical nodes the categorical walk on either. Every
    call with trees passes the ``pallas`` chaos site (the kernel-launch
    site) first, on either device: a fired hit raises, and nothing
    retries the walk or gives way to the plain version."""
    if forest.num_trees == 0:
        return base_margin
    chaos.hit("pallas")
    if X.shape[1] < forest.num_feature:
        raise ValueError(
            f"feature count mismatch: model needs >= {forest.num_feature} "
            f"features, input has {X.shape[1]}")
    if tree_weights is None:
        tree_weights = (forest.unit_weights if forest.unit_weights is not None
                        else torch.ones(forest.num_trees, dtype=torch.float32,
                                        device=X.device))
    elif tree_weights.shape[0] != forest.num_trees:
        raise ValueError(f"{tree_weights.shape[0]} tree weights for "
                         f"{forest.num_trees} trees")
    if forest.has_cats:
        return _predict_margin_cat(forest, X, base_margin, tree_weights)
    if X.device.type == "cpu":
        return _predict_margin_plain(forest, X, base_margin, tree_weights)
    return _predict_margin_cuda(forest, X, base_margin, tree_weights)


predict_margin.launches = 0


def predict_leaf(forest: StackedForest, X: torch.Tensor) -> torch.Tensor:
    """[n, T] leaf indices (reference: pred_leaf), by the plain walk."""
    if forest.num_trees == 0:
        return torch.zeros((X.shape[0], 0), dtype=torch.int32, device=X.device)
    return _walk_leaves(X, forest.left, forest.right, forest.feature,
                        forest.cond, forest.default_left, forest.max_depth,
                        forest.split_type, forest.cat_bits
                        ).t().to(torch.int32)
