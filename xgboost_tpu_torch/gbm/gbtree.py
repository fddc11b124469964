"""GBTree booster: the fused depthwise path on one device.

The port of the single-device, in-core, depthwise part of the JAX package's
``gbm/gbtree.py`` (reference ``src/gbm/gbtree.{h,cc}``: ``DoBoost``
gbtree.cc:219, ``CommitModel`` :364). Trees grown on the device stay there
as heap-layout arrays (``_PendingTree``) and become host ``RegTree``s only
when model IO asks; the prediction cache of the training rows is updated
from the grower's per-row leaf values, with no predictor pass. Trees grown
on categorical features carry their right-going sets, stacked as bitsets
(``_stack_cats``) for the categorical walk. Each tree's row and column
samples are drawn under ``prng_key(round_seed_py(seed, iteration, group))``,
the JAX package's key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import threefry
from ..params import GBTreeParam, TrainParam
from ..predictor import (StackedForest, pack_cat_bits, stack_forest,
                         with_walk_tables)
from ..tree.grow import GrowParams
from ..tree.grow_fused import GrownTree, grow_tree_fused
from ..tree.model import RegTree
from ..tree.param import SplitParams

__all__ = ["GBTreeModel", "GBTree"]


class _PendingTree:
    """A device-grown tree (GrownTree minus the per-row delta). Trees grown
    on categorical features keep ``cat_mask`` ([F] bool, host) and their
    right-going sets ``cat_set``; otherwise both are None."""

    __slots__ = ("keep", "feature", "split_bin", "split_cond", "default_left",
                 "node_weight", "loss_chg", "node_h", "leaf_value", "cat_set",
                 "eta", "max_depth", "cat_mask")

    def __init__(self, g: GrownTree, eta: float, max_depth: int,
                 cat_mask: Optional[np.ndarray] = None):
        for f in self.__slots__[:-4]:
            setattr(self, f, getattr(g, f))
        self.cat_set = g.cat_set if cat_mask is not None else None
        self.eta = eta
        self.max_depth = max_depth
        self.cat_mask = cat_mask

    @property
    def n_nodes(self) -> int:
        return int(self.keep.shape[0])


def _materialize_pending(pending: List[_PendingTree]) -> List[RegTree]:
    """Device trees -> host RegTrees, one bulk copy per field."""
    fields = ("keep", "feature", "split_cond", "default_left", "node_weight",
              "loss_chg", "node_h")
    out = []
    for t in pending:
        h = {f: getattr(t, f).cpu().numpy() for f in fields}
        out.append(RegTree.from_heap(
            h["keep"], h["feature"], h["split_cond"], h["default_left"],
            h["node_weight"], h["loss_chg"], h["node_h"], eta=t.eta,
            cat_features=t.cat_mask,
            cat_set=None if t.cat_set is None else t.cat_set.cpu().numpy()))
    return out


def _stack_cats(entries: List[_PendingTree], keep: torch.Tensor,
                feature: torch.Tensor):
    """``(split_type [T, N], cat_bits [T, N, W])`` of device heap trees
    (the JAX package's ``_pack_cat_bits`` stacking), or ``{}`` when no tree
    was grown on a categorical feature. Trees without categories get empty
    sets."""
    if all(e.cat_mask is None for e in entries):
        return {}
    T, N = keep.shape
    dev = keep.device
    B = max(e.cat_set.shape[1] for e in entries if e.cat_set is not None)
    sets = torch.zeros((T, N, B), dtype=torch.bool, device=dev)
    is_cat = torch.zeros((T, N), dtype=torch.bool, device=dev)
    for t, e in enumerate(entries):
        if e.cat_mask is None:
            continue
        m = e.cat_set.shape[0]
        sets[t, :m, :e.cat_set.shape[1]] = e.cat_set
        mask = torch.as_tensor(e.cat_mask, device=dev)
        is_cat[t] = mask[feature[t].long().clamp(0, mask.shape[0] - 1)]
    return dict(has_cats=True, split_type=is_cat & keep,
                cat_bits=pack_cat_bits(sets))


def _stack_device(entries: List[_PendingTree], tree_info: List[int],
                  n_groups: int, num_feature: int) -> StackedForest:
    """Stacked forest straight from device heap trees, no host copy: the
    heap layout is itself a valid node indexing (children of i at
    2i+1/2i+2) and leaves carry their governing (pruned) leaf value."""
    N = max(e.n_nodes for e in entries)
    dev = entries[0].keep.device

    def field(name, fill):
        rows = []
        for e in entries:
            a = getattr(e, name)
            if a.shape[0] < N:
                a = torch.cat([a, a.new_full((N - a.shape[0],), fill)])
            rows.append(a)
        return torch.stack(rows)

    keep = field("keep", False)
    feature = field("feature", 0)
    iota = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    minus1 = torch.full_like(keep, -1, dtype=torch.int32)
    return with_walk_tables(StackedForest(
        left=torch.where(keep, 2 * iota + 1, minus1),
        right=torch.where(keep, 2 * iota + 2, minus1),
        feature=feature,
        cond=torch.where(keep, field("split_cond", 0.0),
                         field("leaf_value", 0.0)),
        default_left=field("default_left", False),
        tree_group=torch.as_tensor(np.asarray(tree_info, np.int32), device=dev),
        max_depth=max(max(e.max_depth for e in entries), 1),
        n_groups=n_groups, num_feature=num_feature, heap_layout=True,
        **_stack_cats(entries, keep, feature)))


class GBTreeModel:
    """Tree collection + group ids (reference: ``src/gbm/gbtree_model.h``)."""

    def __init__(self, n_groups: int = 1, device=None):
        self.n_groups = n_groups
        self.device = torch.device("cpu") if device is None else device
        self._entries: List[Union[RegTree, _PendingTree]] = []
        self.tree_info: List[int] = []
        self.num_feature = 0  # training width of device-grown trees

    def add(self, tree: RegTree, group: int) -> None:
        self._entries.append(tree)
        self.tree_info.append(group)

    def add_device(self, grown: GrownTree, eta: float, group: int,
                   max_depth: int, cat_mask: Optional[np.ndarray] = None
                   ) -> None:
        self._entries.append(_PendingTree(grown, eta, max_depth, cat_mask))
        self.tree_info.append(group)

    @property
    def trees(self) -> List[RegTree]:
        pending = [i for i, e in enumerate(self._entries)
                   if isinstance(e, _PendingTree)]
        if pending:
            host = _materialize_pending([self._entries[i] for i in pending])
            for i, t in zip(pending, host):
                self._entries[i] = t
        return self._entries

    @property
    def num_trees(self) -> int:
        return len(self._entries)

    def stacked_slice(self, lo: int, hi: int) -> StackedForest:
        """Stacked forest over trees [lo, hi), without host copies when the
        slice is all device-grown."""
        ents = self._entries[lo:hi]
        if ents and all(isinstance(e, _PendingTree) for e in ents):
            return _stack_device(ents, self.tree_info[lo:hi], self.n_groups,
                                 self.num_feature)
        return stack_forest(self.trees[lo:hi], self.tree_info[lo:hi],
                            self.n_groups, self.device)

    def stacked(self) -> StackedForest:
        return self.stacked_slice(0, self.num_trees)

    def slice(self, begin: int, end: int, step: int = 1) -> "GBTreeModel":
        """The trees of boosting rounds ``range(begin, end, step)`` (one
        round holds ``n_groups`` trees; reference gbtree.cc:326), as host
        trees: device-grown trees are materialized first, as in the JAX
        package's ``GBTreeModel.slice``."""
        out = GBTreeModel(self.n_groups, self.device)
        out.num_feature = self.num_feature
        trees = self.trees
        per_round = max(1, self.n_groups)
        for r in range(begin, end, step):
            for t in range(r * per_round, min((r + 1) * per_round,
                                              len(trees))):
                out.add(trees[t], self.tree_info[t])
        return out


def _cat_cfg(cfg: GrowParams, binned, tp: TrainParam
             ) -> Tuple[GrowParams, Optional[np.ndarray]]:
    """The one-hot vs optimal-partition gate (reference UseOneHot,
    ``evaluate_splits.h``: one-hot when a feature has fewer categories than
    ``max_cat_to_onehot``) applied to ``cfg`` for ``binned``'s categorical
    features. Returns ``(cfg, cat_mask)``, ``cat_mask`` [F] bool or None
    when no feature is categorical."""
    cats = tuple(binned.categorical)
    if not cats:
        return cfg, None
    counts = tuple(binned.cat_counts) or (0,) * len(cats)
    cfg = dataclasses.replace(
        cfg,
        categorical=tuple(f for f, c in zip(cats, counts)
                          if c < tp.max_cat_to_onehot),
        cat_partition=tuple(f for f, c in zip(cats, counts)
                            if c >= tp.max_cat_to_onehot))
    return cfg, cfg.cat_mask_np(binned.n_features)


def round_seed_py(seed: int, iteration: int, k: int = 0,
                  ptree: int = 0) -> int:
    """Per-tree RNG seed of boosting round ``iteration``, output group
    ``k`` and parallel tree ``ptree`` (the JAX package's formula)."""
    return (seed * 1000003 + iteration * 131 + k * 17 + ptree) & 0x7FFFFFFF


class GBTree:
    """Boosting orchestration over the fused depthwise grower."""

    name = "gbtree"

    def __init__(self, n_groups: int, params: Dict[str, Any], device):
        self.n_groups = max(1, n_groups)
        self.device = device
        self.gbtree_param = GBTreeParam()
        rest = self.gbtree_param.update(dict(params))
        self.train_param = TrainParam()
        self.train_param.update(rest)
        self._check_supported()
        self.model = GBTreeModel(self.n_groups, device)

    def _check_supported(self) -> None:
        tp, gp = self.train_param, self.gbtree_param
        if tp.sampling_method not in ("uniform", "gradient_based"):
            raise ValueError(f"Unknown sampling_method: {tp.sampling_method}")
        if tp.grow_policy != "depthwise":
            raise NotImplementedError(
                f"grow_policy={tp.grow_policy!r} is not ported yet")
        if gp.tree_method not in ("auto", "hist", "gpu_hist", "tpu_hist"):
            raise NotImplementedError(
                f"tree_method={gp.tree_method!r} is not ported yet")
        if gp.num_parallel_tree != 1:
            raise NotImplementedError("num_parallel_tree > 1 is not ported yet")

    def set_param(self, key: str, value: Any) -> None:
        """Set one parameter between rounds (the JAX package's
        ``GBTree.set_param``): the next tree grows with it; ``eta`` is
        stored with each tree as it grows. Keys of neither struct are
        ignored here (the learner has checked them)."""
        rest = self.gbtree_param.update({key: value})
        self.train_param.update(rest)
        self._check_supported()

    def _grow_params(self) -> GrowParams:
        tp = self.train_param
        return GrowParams(
            max_depth=tp.max_depth,
            subsample=tp.subsample,
            sampling_method=tp.sampling_method,
            colsample_bytree=tp.colsample_bytree,
            colsample_bylevel=tp.colsample_bylevel,
            colsample_bynode=tp.colsample_bynode,
            split=SplitParams(
                reg_lambda=tp.reg_lambda, reg_alpha=tp.reg_alpha,
                max_delta_step=tp.max_delta_step,
                min_child_weight=tp.min_child_weight, min_split_loss=tp.gamma),
            monotone=tuple(int(c) for c in tp.monotone_constraints),
            interaction=tuple(tuple(int(f) for f in grp)
                              for grp in tp.interaction_constraints))

    def boost_one_round(self, binned, grad: torch.Tensor, hess: torch.Tensor,
                        margin_cache: Optional[torch.Tensor],
                        iteration: int = 0,
                        feature_weights: Optional[torch.Tensor] = None
                        ) -> Tuple[List[GrownTree], Optional[torch.Tensor]]:
        """One round: one tree per output group (tree ``k`` from column
        ``k`` of ``grad``/``hess`` [n, K]), grown on the device; the margin
        cache, copied once, gets each tree's per-row leaf values in its
        group's column (gbtree.cc:219).
        Where the hoist plan admits it, every level streams the matrix's
        resident one-hot (built at the first round; JAX ``gbtree.py:1421``);
        otherwise kernel A reads its resident feature-major bins. Tree
        ``k`` samples under ``prng_key(round_seed_py(seed, iteration,
        k))`` (a key on the CPU: the draws themselves run on the bins'
        device), with ``feature_weights`` ([F]) weighting its column
        sample."""
        tp = self.train_param
        cfg, cat_mask = _cat_cfg(self._grow_params(), binned, tp)
        self.model.num_feature = binned.n_features
        onehot = binned.fused_onehot()
        bins_t = (binned.feature_major() if onehot is None
                  and binned.bins.device.type != "cpu" else None)
        new_trees = []
        if margin_cache is not None:
            # one copy per round (callers may hold the old cache); the
            # groups then add their columns in place
            margin_cache = margin_cache.clone()
        for k in range(self.n_groups):
            g = grad[:, k] if grad.dim() == 2 else grad
            h = hess[:, k] if hess.dim() == 2 else hess
            key = threefry.prng_key(round_seed_py(tp.seed, iteration, k))
            grown = grow_tree_fused(binned.bins, g, h, binned.cut_values,
                                    float(tp.eta), float(tp.gamma), cfg,
                                    onehot=onehot, bins_t=bins_t, key=key,
                                    feature_weights=feature_weights)
            self.model.add_device(grown, tp.eta, k, tp.max_depth, cat_mask)
            new_trees.append(grown)
            if margin_cache is not None:
                margin_cache[:, k] += grown.delta
        return new_trees, margin_cache

    def save_json(self) -> dict:
        return {
            "name": self.name,
            "model": {
                "gbtree_model_param": {
                    "num_trees": str(self.model.num_trees),
                    "num_parallel_tree": str(self.gbtree_param.num_parallel_tree),
                    "size_leaf_vector": "0",
                },
                "trees": [t.to_json(i) for i, t in enumerate(self.model.trees)],
                "tree_info": list(self.model.tree_info),
            },
        }

    def load_json(self, j: dict) -> None:
        m = j["model"]
        npt = int(m.get("gbtree_model_param", {}).get("num_parallel_tree", 1) or 1)
        if npt != 1:
            raise NotImplementedError("num_parallel_tree > 1 is not ported yet")
        self.model = GBTreeModel(self.n_groups, self.device)
        for tj, info in zip(m["trees"], m["tree_info"]):
            self.model.add(RegTree.from_json(tj), int(info))
