"""GBTree and DART boosters: the depthwise and lossguide growers on one
device.

The port of the single-device, in-core part of the JAX package's
``gbm/gbtree.py`` (reference ``src/gbm/gbtree.{h,cc}``: ``DoBoost``
gbtree.cc:219, ``CommitModel`` :364, DART :637-1020). Trees grown on the
device stay there, depthwise ones as heap-layout arrays (``_PendingTree``),
lossguide ones as allocation-ordered arrays (``_PendingAllocTree``), and
become host ``RegTree``s only when model IO asks; the prediction cache of
the training rows is updated from the grower's per-row leaf values, with
no predictor pass. Trees grown on categorical features carry their
right-going sets, stacked as bitsets (``_stack_cats``) for the categorical
walk. A round grows ``num_parallel_tree`` trees per output group; tree
``(k, p)`` of round ``iteration`` draws its row and column samples under
``prng_key(round_seed_py(seed, iteration, k, p))``, the JAX package's key.
``Dart`` drops trees at random each round and walks the whole forest with
per-tree weights (no cache). ``tree_method`` and the ``updater`` sequence
pick the matrix a round grows on (the learner reads ``needs_exact_cuts``,
``needs_iteration_sketch``, ``needs_local_sketch``): the quantile matrix,
the exact candidate set, a matrix sketched anew from each round's
hessians, or per-node cuts from the raw rows (``local_boost_one_round``);
``process_type="update"`` re-stats the existing trees instead
(``refresh_one_round``). Under a row group (``parallel.RowGroup``) a round
grows each depthwise or lossguide tree over this rank's rows with its
histograms all-reduced (``grow_tree_fused(group=)``,
``grow_tree_lossguide(group=)``); everything else raises there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import threefry
from ..config import warn
from ..observability import REGISTRY as _REGISTRY
from ..observability import kernelprof as _kernelprof
from ..observability import trace as _trace
from ..params import GBTreeParam, TrainParam
from ..objective.base import segment_sum
from ..predictor import (StackedForest, pack_cat_bits, predict_leaf,
                         stack_forest, with_walk_tables)
from ..tree.grow import GrowParams
from ..tree.grow_fused import (GrownTree, grow_tree_fused,
                               grow_tree_fused_paged)
from ..tree.grow_local import grow_tree_local
from ..tree.grow_lossguide import (AllocTree, finalize_alloc,
                                   grow_tree_lossguide)
from ..tree.model import RegTree
from ..tree.param import SplitParams, calc_gain, calc_weight

__all__ = ["GBTreeModel", "GBTree", "Dart", "GROUP_ENVELOPE"]

#: why a configuration cannot train under a row group (the JAX package's
#: envelope message, ``learner.py:270``, less lossguide, which the port
#: grows over a row group as the JAX package's 2-device mesh does)
GROUP_ENVELOPE = (
    "this configuration is outside the multi-process scan envelope "
    "(ranking/survival/DART/categorical/external-memory/custom "
    "objectives are single-process); see docs/distributed.md")


def _hist_seconds():
    return _REGISTRY.histogram(
        "hist_build_seconds",
        "Host-side wall time of one tree build dispatch "
        "(hist + split + partition)")


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


class _PendingAllocTree:
    """A device-grown lossguide tree: its allocation-ordered arrays and
    ``finalize_alloc``'s ``keep`` and ``leaf_value``; ``depth_max`` is its
    deepest node's depth, a device scalar (the walk bound)."""

    __slots__ = ("left", "right", "feature", "split_bin", "split_cond",
                 "default_left", "node_weight", "loss_chg", "node_h",
                 "n_nodes", "cat_set", "keep", "leaf_value", "depth_max",
                 "eta", "gamma", "max_depth", "cat_mask")

    def __init__(self, alloc: AllocTree, keep: torch.Tensor,
                 leaf_value: torch.Tensor, eta: float, gamma: float,
                 max_depth: int, cat_mask: Optional[np.ndarray] = None):
        for f in self.__slots__[:10]:
            setattr(self, f, getattr(alloc, f))
        self.cat_set = alloc.cat_set if cat_mask is not None else None
        self.keep = keep
        self.leaf_value = leaf_value
        self.depth_max = alloc.depth.max()
        self.eta = eta
        self.gamma = gamma
        self.max_depth = max_depth
        self.cat_mask = cat_mask


def _materialize_pending_alloc(pending: List[_PendingAllocTree]
                               ) -> List[RegTree]:
    """Device lossguide trees -> host RegTrees (``RegTree.from_alloc``:
    pruning and BFS compaction, as in the JAX package)."""
    fields = ("left", "right", "feature", "split_cond", "default_left",
              "node_weight", "loss_chg", "node_h", "split_bin")
    out = []
    for t in pending:
        h = {f: getattr(t, f).cpu().numpy() for f in fields}
        tree, _ = RegTree.from_alloc(
            h["left"], h["right"], h["feature"], h["split_cond"],
            h["default_left"], h["node_weight"], h["loss_chg"], h["node_h"],
            int(t.n_nodes), eta=t.eta, min_split_loss=t.gamma,
            split_bin=h["split_bin"], cat_features=t.cat_mask,
            cat_set=None if t.cat_set is None else t.cat_set.cpu().numpy())
        out.append(tree)
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


def _stack_field(entries, name: str, fill, N: int) -> torch.Tensor:
    """``[T, N]``: each entry's 1-D ``name`` padded with ``fill``."""
    rows = []
    for e in entries:
        a = getattr(e, name)
        if a.shape[0] < N:
            a = torch.cat([a, a.new_full((N - a.shape[0],), fill)])
        rows.append(a)
    return torch.stack(rows)


def _stack_device(entries: List[_PendingTree], tree_info: List[int],
                  n_groups: int, num_feature: int) -> StackedForest:
    """Stacked forest straight from device heap trees, no host copy: the
    heap layout is itself a valid node indexing (children of i at
    2i+1/2i+2) and leaves carry their governing (pruned) leaf value."""
    N = max(e.n_nodes for e in entries)
    dev = entries[0].keep.device

    def field(name, fill):
        return _stack_field(entries, name, fill, N)

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


def _stack_device_alloc(entries: List[_PendingAllocTree],
                        tree_info: List[int], n_groups: int,
                        num_feature: int) -> StackedForest:
    """Stacked forest straight from device lossguide trees: the explicit
    children of the kept splits (allocation order), the governing leaf
    value elsewhere. The walk bound is the deepest node of the forest plus
    one, read back once (the JAX package's rule); nothing else leaves the
    device."""
    N = max(e.left.shape[0] for e in entries)
    dev = entries[0].keep.device

    def field(name, fill):
        return _stack_field(entries, name, fill, N)

    keep = field("keep", False)
    feature = field("feature", 0)
    minus1 = torch.full_like(keep, -1, dtype=torch.int32)
    depth = int(torch.stack([e.depth_max for e in entries]).max()) + 1
    return with_walk_tables(StackedForest(
        left=torch.where(keep, field("left", -1), minus1),
        right=torch.where(keep, field("right", -1), minus1),
        feature=feature,
        cond=torch.where(keep, field("split_cond", 0.0),
                         field("leaf_value", 0.0)),
        default_left=field("default_left", False),
        tree_group=torch.as_tensor(np.asarray(tree_info, np.int32), device=dev),
        max_depth=max(depth, 1), n_groups=n_groups, num_feature=num_feature,
        **_stack_cats(entries, keep, feature)))


class GBTreeModel:
    """Tree collection + group ids (reference: ``src/gbm/gbtree_model.h``);
    a boosting round holds ``n_groups * num_parallel_tree`` trees."""

    def __init__(self, n_groups: int = 1, device=None,
                 num_parallel_tree: int = 1):
        self.n_groups = n_groups
        self.num_parallel_tree = num_parallel_tree
        self.device = torch.device("cpu") if device is None else device
        self._entries: List[Union[RegTree, _PendingTree,
                                  _PendingAllocTree]] = []
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

    def add_device_alloc(self, alloc: AllocTree, keep: torch.Tensor,
                         leaf_value: torch.Tensor, eta: float, gamma: float,
                         group: int, max_depth: int,
                         cat_mask: Optional[np.ndarray] = None) -> None:
        self._entries.append(_PendingAllocTree(alloc, keep, leaf_value, eta,
                                               gamma, max_depth, cat_mask))
        self.tree_info.append(group)

    @property
    def trees(self) -> List[RegTree]:
        for kind, convert in ((_PendingTree, _materialize_pending),
                              (_PendingAllocTree,
                               _materialize_pending_alloc)):
            pending = [i for i, e in enumerate(self._entries)
                       if isinstance(e, kind)]
            if pending:
                host = convert([self._entries[i] for i in pending])
                for i, t in zip(pending, host):
                    self._entries[i] = t
        return self._entries

    def last_tree(self) -> Optional[RegTree]:
        """The last tree as a host ``RegTree`` (None without trees), read
        alone: the model keeps its device entry."""
        if not self._entries:
            return None
        last = self._entries[-1]
        for kind, convert in ((_PendingTree, _materialize_pending),
                              (_PendingAllocTree,
                               _materialize_pending_alloc)):
            if isinstance(last, kind):
                return convert([last])[0]
        return last

    @property
    def num_trees(self) -> int:
        return len(self._entries)

    def stacked_slice(self, lo: int, hi: int) -> StackedForest:
        """Stacked forest over trees [lo, hi), without host copies when the
        slice is all device-grown by one grower."""
        ents = self._entries[lo:hi]
        for kind, stack in ((_PendingTree, _stack_device),
                            (_PendingAllocTree, _stack_device_alloc)):
            if ents and all(isinstance(e, kind) for e in ents):
                return stack(ents, self.tree_info[lo:hi], self.n_groups,
                             self.num_feature)
        return stack_forest(self.trees[lo:hi], self.tree_info[lo:hi],
                            self.n_groups, self.device)

    def stacked(self) -> StackedForest:
        return self.stacked_slice(0, self.num_trees)

    def slice(self, begin: int, end: int, step: int = 1) -> "GBTreeModel":
        """The trees of boosting rounds ``range(begin, end, step)`` (one
        round holds ``n_groups * num_parallel_tree`` trees; reference
        gbtree.cc:326), as host trees: device-grown trees are materialized
        first, as in the JAX package's ``GBTreeModel.slice``."""
        out = GBTreeModel(self.n_groups, self.device, self.num_parallel_tree)
        out.num_feature = self.num_feature
        trees = self.trees
        per_round = max(1, self.n_groups) * self.num_parallel_tree
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
    """Boosting orchestration over the depthwise and lossguide growers."""

    name = "gbtree"

    def __init__(self, n_groups: int, params: Dict[str, Any], device):
        self.n_groups = max(1, n_groups)
        self.device = device
        self.gbtree_param = GBTreeParam()
        rest = self.gbtree_param.update(dict(params))
        self.train_param = TrainParam()
        self.train_param.update(rest)
        self._configure_method()
        self._warn_inert()
        self.model = GBTreeModel(self.n_groups, device,
                                 self.gbtree_param.num_parallel_tree)
        # process_type="update": the trees still to refresh (None until the
        # first refreshed round takes them)
        self._update_queue: Optional[List[Tuple[RegTree, int]]] = None

    #: updater names and their roles (the JAX package's registry,
    #: ``gbm/gbtree.py:902``): every grower grows depthwise on the
    #: quantized matrix, ``grow_colmaker`` on the exact candidate set,
    #: ``grow_histmaker`` on cuts sketched anew every round and
    #: ``grow_local_histmaker`` on cuts sketched per node (``needs_*``)
    _KNOWN_UPDATERS = {
        "grow_quantile_histmaker": "grow", "grow_histmaker": "grow",
        "grow_local_histmaker": "grow", "grow_colmaker": "grow",
        "grow_gpu_hist": "grow", "grow_fast_histmaker": "grow",
        "distcol": "grow", "prune": "prune", "refresh": "refresh",
        "sync": "sync",
    }

    def _configure_method(self) -> None:
        """Check ``tree_method``, the ``updater`` sequence, the sampling
        method, ``process_type`` and the predictor, with the JAX package's
        errors and messages (``_configure_method``). ``prune`` in a
        sequence with a grower is the growers' own gamma pruning; alone it
        raises NotImplementedError; ``sync`` changes nothing."""
        tp, gp = self.train_param, self.gbtree_param
        if gp.tree_method not in ("auto", "exact", "hist", "gpu_hist",
                                  "tpu_hist", "approx"):
            raise ValueError(f"Unknown tree_method: {gp.tree_method}")
        self._updater_seq: List[str] = []
        for name in str(gp.updater).split(",") if gp.updater else ():
            name = name.strip()
            if name and name not in self._KNOWN_UPDATERS:
                raise ValueError(f"Unknown updater: {name!r}")
            if name:
                self._updater_seq.append(name)
        roles = {self._KNOWN_UPDATERS[u] for u in self._updater_seq}
        if "prune" in roles and not roles & {"grow", "refresh"}:
            raise NotImplementedError(
                "standalone updater='prune' is not supported; pruning "
                "runs inside every grower (gamma)")
        if tp.sampling_method not in ("uniform", "gradient_based"):
            raise ValueError(f"Unknown sampling_method: {tp.sampling_method}")
        if gp.process_type not in ("default", "update"):
            raise ValueError(f"Unknown process_type: {gp.process_type}")
        if gp.predictor not in ("auto", "cpu_predictor", "gpu_predictor",
                                "tpu_predictor"):
            raise ValueError(f"Unknown predictor: {gp.predictor}")

    @property
    def is_update_process(self) -> bool:
        """``process_type="update"`` or ``refresh`` among the updaters: a
        round re-stats the existing trees (``refresh_one_round``)."""
        return (self.gbtree_param.process_type == "update"
                or "refresh" in self._updater_seq)

    @property
    def needs_exact_cuts(self) -> bool:
        """``tree_method="exact"`` / ``grow_colmaker``: train on the exact
        candidate set (``DMatrix.get_binned_exact``)."""
        return (self.gbtree_param.tree_method == "exact"
                or "grow_colmaker" in self._updater_seq)

    @property
    def needs_iteration_sketch(self) -> bool:
        """``tree_method="approx"`` / ``grow_histmaker``: cuts sketched
        anew every round, weighted by that round's hessians
        (``DMatrix.build_binned``)."""
        return (self.gbtree_param.tree_method == "approx"
                or "grow_histmaker" in self._updater_seq)

    @property
    def needs_local_sketch(self) -> bool:
        """``grow_local_histmaker``: cuts sketched per node at every level
        from the raw values (``local_boost_one_round``)."""
        return "grow_local_histmaker" in self._updater_seq

    def _warn_inert(self) -> None:
        """The JAX package's warnings for the keys that change nothing
        (``gbm/gbtree.py:948-972``), on the same conditions
        (``config.warn``: silent at ``verbosity`` 0)."""
        tp, gp = self.train_param, self.gbtree_param
        if not tp.single_precision_histogram:
            warn(
                "single_precision_histogram=False (float64 histograms) is "
                "not available on the card; the histograms sum fixed-point "
                "integers exactly (int64)", stacklevel=3)
        if tp.is_explicit("sketch_eps"):
            warn(
                "sketch_eps is superseded by max_bin on the hist sketch "
                "(reference hist makes the same substitution)", stacklevel=3)
        if tp.is_explicit("sparse_threshold"):
            warn(
                "sparse_threshold has no effect: the quantized matrix is "
                "dense (missing encoded as a null bin)", stacklevel=3)
        if gp.is_explicit("predictor") \
                and gp.predictor in ("cpu_predictor", "gpu_predictor"):
            warn(
                f"predictor={gp.predictor} requested; the stacked-forest "
                "predictor (kernel B on the card) is always used",
                stacklevel=3)

    def set_param(self, key: str, value: Any) -> None:
        """Set one parameter between rounds (the JAX package's
        ``GBTree.set_param``): the next tree grows with it; ``eta`` is
        stored with each tree as it grows. Keys of neither struct are
        ignored here (the learner has checked them). ``updater``,
        ``process_type``, ``tree_method`` and ``sampling_method`` configure
        the method again, with its warnings."""
        rest = self.gbtree_param.update({key: value})
        self.train_param.update(rest)
        self._configure_method()
        if key in ("updater", "process_type", "tree_method",
                   "sampling_method"):
            self._warn_inert()

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

    def _lossguide_max_leaves(self) -> int:
        """The lossguide leaf budget: ``max_leaves`` when set, else
        ``2^max_depth`` up to depth 8, else 255 (the JAX package's rule:
        the grower's tensors and step count are sized by it)."""
        tp = self.train_param
        if tp.max_leaves:
            return tp.max_leaves
        if 0 < tp.max_depth <= 8:
            return 1 << tp.max_depth
        return 255

    def boost_one_round(self, binned, grad: torch.Tensor, hess: torch.Tensor,
                        margin_cache: Optional[torch.Tensor],
                        iteration: int = 0,
                        feature_weights: Optional[torch.Tensor] = None,
                        group=None
                        ) -> Tuple[List[Union[GrownTree, AllocTree]],
                                   Optional[torch.Tensor]]:
        """One round: ``num_parallel_tree`` trees per output group (group
        ``k``'s from column ``k`` of ``grad``/``hess`` [n, K], which no
        tree writes), grown on the device; the margin cache, copied once,
        gets each tree's per-row leaf values in its group's column
        (gbtree.cc:219).
        Depthwise: where the hoist plan admits it, every level streams the
        matrix's resident one-hot (built at the first round; JAX
        ``gbtree.py:1421``); otherwise kernel A reads its resident
        feature-major bins. A disk-paged matrix (``is_paged``) grows
        through ``grow_tree_fused_paged``: kernel A on every page at every
        level; lossguide and categorical features raise there, with the
        JAX package's messages. Lossguide (``grow_tree_lossguide``): kernel
        A builds every step's child histograms from the feature-major bins.
        Tree ``(k, p)`` samples under ``prng_key(round_seed_py(seed,
        iteration, k, p))`` (a key on the CPU: the draws themselves run on
        the bins' device), with ``feature_weights`` ([F]) weighting its
        column sample. Under a row ``group`` each tree grows over this
        rank's rows through ``grow_tree_fused(group=)``, on the one-hot
        of the plan agreed over the group, or through
        ``grow_tree_lossguide(group=)`` (kernel A on each rank, every
        step's child histograms all-reduced); categorical features, a
        paged matrix and ``num_parallel_tree > 1`` raise
        NotImplementedError there."""
        tp = self.train_param
        cfg, cat_mask = _cat_cfg(self._grow_params(), binned, tp)
        self.model.num_feature = binned.n_features
        lossguide = tp.grow_policy == "lossguide"
        paged = getattr(binned, "is_paged", False)
        if group is not None:
            if paged:
                raise NotImplementedError(
                    "external-memory + mesh training is not supported yet; "
                    "shard rows across processes instead "
                    "(docs/distributed.md)")
            if (cfg.has_categorical
                    or self.gbtree_param.num_parallel_tree > 1):
                raise NotImplementedError(GROUP_ENVELOPE)
        if paged and lossguide:
            raise NotImplementedError(
                "external-memory matrices support depthwise numerical "
                "training only (reference external memory has the same "
                "hist-only restriction)")
        if paged:  # no resident bins: the grower reads the pages
            onehot = bins_t = None
            cut_values = torch.as_tensor(binned.cuts.values,
                                         device=grad.device)
        else:
            if lossguide:
                binned.check_cuts(group)
            onehot = None if lossguide else binned.fused_onehot(group)
            bins_t = (binned.feature_major() if onehot is None
                      and binned.bins.device.type != "cpu" else None)
            cut_values = binned.cut_values
        new_trees: List[Union[GrownTree, AllocTree]] = []
        if margin_cache is not None:
            # one copy per round (callers may hold the old cache); the
            # trees then add their columns in place
            margin_cache = margin_cache.clone()
        for k in range(self.n_groups):
            g = grad[:, k] if grad.dim() == 2 else grad
            h = hess[:, k] if hess.dim() == 2 else hess
            for ptree in range(self.gbtree_param.num_parallel_tree):
                key = threefry.prng_key(
                    round_seed_py(tp.seed, iteration, k, ptree))
                t0 = time.perf_counter()
                policy = {"policy": "lossguide"} if lossguide else {}
                with _trace.span("build_tree", iteration=iteration, group=k,
                                 ptree=ptree, **policy):
                    if lossguide:
                        tree = grow_tree_lossguide(
                            binned.bins, g, h, cut_values, cfg,
                            self._lossguide_max_leaves(), key=key,
                            feature_weights=feature_weights, bins_t=bins_t,
                            group=group)
                        keep, leaf_value, delta = finalize_alloc(
                            tree, float(tp.eta), float(tp.gamma))
                    elif paged:
                        tree = grow_tree_fused_paged(
                            binned, g, h, cut_values, float(tp.eta),
                            float(tp.gamma), cfg, key=key,
                            feature_weights=feature_weights)
                    else:
                        # a sampled round (XGBTPU_KERNEL_PROF) brackets
                        # the same level loop's ops
                        grow = (_kernelprof.grow_tree_fused_profiled
                                if _kernelprof.active() else grow_tree_fused)
                        tree = grow(
                            binned.bins, g, h, cut_values, float(tp.eta),
                            float(tp.gamma), cfg, onehot=onehot,
                            bins_t=bins_t, key=key,
                            feature_weights=feature_weights, group=group)
                _hist_seconds().observe(time.perf_counter() - t0)
                if lossguide:
                    self.model.add_device_alloc(tree, keep, leaf_value,
                                                tp.eta, tp.gamma, k,
                                                tp.max_depth, cat_mask)
                else:
                    self.model.add_device(tree, tp.eta, k, tp.max_depth,
                                          cat_mask)
                    delta = tree.delta
                new_trees.append(tree)
                if margin_cache is not None:
                    margin_cache[:, k] += delta
        return new_trees, margin_cache

    def local_boost_one_round(self, X: torch.Tensor, grad: torch.Tensor,
                              hess: torch.Tensor,
                              margin_cache: Optional[torch.Tensor],
                              iteration: int = 0,
                              feature_weights: Optional[torch.Tensor] = None
                              ) -> Tuple[List[GrownTree],
                                         Optional[torch.Tensor]]:
        """One round of ``grow_local_histmaker`` (the JAX package's
        ``local_boost_one_round``): ``boost_one_round``'s trees, keys and
        cache contract, each tree grown on the raw rows ``X`` [n, F] with
        cuts sketched per node (``tree/grow_local.py``; kernel A builds
        every level's histogram on the card)."""
        from ..parallel.mesh import current_mesh

        tp = self.train_param
        if current_mesh() is not None:
            raise NotImplementedError(
                "grow_local_histmaker is single-process/single-device; "
                "use tree_method='tpu_hist' under a mesh")
        if tp.grow_policy == "lossguide":
            raise NotImplementedError(
                "grow_local_histmaker is depthwise (the reference's "
                "histmaker family has no lossguide variant)")
        cfg = self._grow_params()
        self.model.num_feature = X.shape[1]
        new_trees: List[GrownTree] = []
        if margin_cache is not None:
            margin_cache = margin_cache.clone()
        for k in range(self.n_groups):
            g = grad[:, k] if grad.dim() == 2 else grad
            h = hess[:, k] if hess.dim() == 2 else hess
            for ptree in range(self.gbtree_param.num_parallel_tree):
                key = threefry.prng_key(
                    round_seed_py(tp.seed, iteration, k, ptree))
                t0 = time.perf_counter()
                with _trace.span("build_tree", iteration=iteration,
                                 group=k, ptree=ptree, policy="local"):
                    tree = grow_tree_local(X, g, h, cfg, tp.max_bin,
                                           float(tp.eta), float(tp.gamma),
                                           key=key,
                                           feature_weights=feature_weights)
                _hist_seconds().observe(time.perf_counter() - t0)
                self.model.add_device(tree, tp.eta, k, tp.max_depth)
                new_trees.append(tree)
                if margin_cache is not None:
                    margin_cache[:, k] += tree.delta
        return new_trees, margin_cache

    def refresh_one_round(self, X: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor) -> List[RegTree]:
        """``process_type="update"`` / ``updater="refresh"``: the next
        round's trees of the existing model (the first call takes them all
        and starts an empty model) get their node statistics recomputed on
        ``X`` and the gradients, and their leaf values too with
        ``refresh_leaf``; no tree is added (the JAX package's
        ``refresh_one_round``; reference ``updater_refresh.cc:162``). Each
        tree walks the rows to their leaves (``predict_leaf``, on the
        rows' device); the leaves' float64 sums are taken in a fixed order
        (``segment_sum``), pushed up to the parents on the host and
        rounded to float32 once, then ``calc_weight`` / ``calc_gain`` give
        the weights and the loss changes."""
        from ..parallel.mesh import current_mesh

        if current_mesh() is not None:
            raise NotImplementedError(GROUP_ENVELOPE)
        per_round = self.n_groups * self.gbtree_param.num_parallel_tree
        if self._update_queue is None:
            trees = self.model.trees
            if not trees:
                raise ValueError(
                    "process_type=update requires an existing model "
                    "(pass xgb_model / load_model first)")
            self._update_queue = list(zip(trees, self.model.tree_info))
            num_feature = self.model.num_feature
            self.model = GBTreeModel(self.n_groups, self.device,
                                     self.gbtree_param.num_parallel_tree)
            self.model.num_feature = num_feature
        if not self._update_queue:
            raise ValueError(
                "num_boost_round exceeds the number of trees to update "
                "(reference gbtree.cc process_type=update contract)")
        batch = self._update_queue[:per_round]
        self._update_queue = self._update_queue[per_round:]
        tp = self.train_param
        p = self._grow_params().split
        eta = tp.eta
        for tree, group in batch:
            g = grad[:, group] if grad.dim() == 2 else grad
            h = hess[:, group] if hess.dim() == 2 else hess
            leaves = predict_leaf(stack_forest([tree], [group], self.n_groups,
                                               X.device), X)[:, 0].long()
            G, H = segment_sum(torch.stack([g, h]).double(), leaves,
                               tree.num_nodes).cpu().numpy()
            for i in range(tree.num_nodes - 1, 0, -1):  # parents first (BFS)
                par = tree.parents[i]
                G[par] += G[i]
                H[par] += H[i]
            G32 = torch.from_numpy(G.astype(np.float32))
            H32 = torch.from_numpy(H.astype(np.float32))
            w = calc_weight(G32, H32, p).numpy()
            gains = calc_gain(G32, H32, p).numpy()
            tree.sum_hessian = H.astype(np.float32)
            tree.base_weights = (eta * w).astype(np.float32)
            internal = tree.left_children != -1
            lc = np.where(internal, tree.left_children, 0)
            rc = np.where(internal, tree.right_children, 0)
            tree.loss_changes = np.where(
                internal, gains[lc] + gains[rc] - gains, 0.0
            ).astype(np.float32)
            if tp.refresh_leaf:
                tree.split_conditions = np.where(
                    ~internal, eta * w, tree.split_conditions
                ).astype(np.float32)
            self.model.add(tree, group)
        return [t for t, _ in batch]

    def tree_weights(self) -> Optional[torch.Tensor]:
        """Per-tree weights of every walk (DART's); None: all ones."""
        return None

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
        npt = (int(m.get("gbtree_model_param", {}).get("num_parallel_tree", 0))
               or self.gbtree_param.num_parallel_tree)
        self.gbtree_param.num_parallel_tree = npt
        self.model = GBTreeModel(self.n_groups, self.device, npt)
        for tj, info in zip(m["trees"], m["tree_info"]):
            self.model.add(RegTree.from_json(tj), int(info))


class Dart(GBTree):
    """DART: dropout of whole trees each round (reference gbtree.cc:637-1020;
    the JAX package's ``Dart``). The drops come from
    ``np.random.RandomState(seed)`` in the JAX package's draw order: one
    ``uniform()`` for ``skip_drop`` (when above 0), then one per tree, and
    ``one_drop``'s pick; none before the first tree and none at eval. Every
    walk weights each tree by ``weight_drop``; the training walk weights
    the dropped trees 0, so the booster keeps no prediction cache."""

    name = "dart"

    def __init__(self, n_groups: int, params: Dict[str, Any], device):
        super().__init__(n_groups, params, device)
        self.weight_drop: List[float] = []
        self._idx_drop: List[int] = []
        self._rng = np.random.RandomState(self.train_param.seed)

    def _drop_trees(self) -> None:
        """reference DropTrees (gbtree.cc:914)."""
        p = self.gbtree_param
        self._idx_drop = []
        if p.skip_drop > 0.0 and self._rng.uniform() < p.skip_drop:
            return
        W = self.weight_drop
        if not W:
            return
        if p.sample_type == "weighted":
            sw = sum(W)
            for i, wi in enumerate(W):
                if self._rng.uniform() < (p.rate_drop * len(W) * wi
                                          / max(sw, 1e-30)):
                    self._idx_drop.append(i)
            if p.one_drop and not self._idx_drop:
                probs = np.asarray(W) / max(sum(W), 1e-30)
                self._idx_drop.append(int(self._rng.choice(len(W), p=probs)))
        else:
            for i in range(len(W)):
                if self._rng.uniform() < p.rate_drop:
                    self._idx_drop.append(i)
            if p.one_drop and not self._idx_drop:
                self._idx_drop.append(int(self._rng.randint(len(W))))

    def _normalize_trees(self, n_new: int) -> None:
        """reference NormalizeTrees (gbtree.cc:963)."""
        lr = self.train_param.eta / max(n_new, 1)
        k = len(self._idx_drop)
        if k == 0:
            self.weight_drop.extend([1.0] * n_new)
        elif self.gbtree_param.normalize_type == "forest":
            factor = 1.0 / (1.0 + lr)
            for i in self._idx_drop:
                self.weight_drop[i] *= factor
            self.weight_drop.extend([factor] * n_new)
        else:  # "tree"
            factor = k / (k + lr)
            for i in self._idx_drop:
                self.weight_drop[i] *= factor
            self.weight_drop.extend([1.0 / (k + lr)] * n_new)

    def tree_weights(self) -> Optional[torch.Tensor]:
        if not self.weight_drop:
            return None
        return torch.as_tensor(np.asarray(self.weight_drop, np.float32),
                               device=self.device)

    def training_forest(self) -> Tuple[StackedForest,
                                       Optional[torch.Tensor]]:
        """This round's training walk: draw the drops, then the whole
        forest and its tree weights with the dropped trees' at 0 (None:
        no tree yet has a weight)."""
        self._drop_trees()
        tw = np.asarray(self.weight_drop, np.float32)
        forest = self.model.stacked()
        if not len(tw):
            return forest, None
        tw = tw.copy()
        tw[self._idx_drop] = 0.0
        return forest, torch.as_tensor(tw, device=self.device)

    def boost_one_round(self, binned, grad, hess, margin_cache,
                        iteration: int = 0, feature_weights=None,
                        group=None):
        # the dropout reweights old trees every round: no cache (the
        # reference disables it for DART too)
        new_trees, _ = super().boost_one_round(binned, grad, hess, None,
                                               iteration, feature_weights,
                                               group)
        self._normalize_trees(len(new_trees))
        return new_trees, None

    def save_json(self) -> dict:
        j = super().save_json()
        j["model"] = {"gbtree": j["model"],
                      "weight_drop": list(self.weight_drop)}
        return j

    def load_json(self, j: dict) -> None:
        super().load_json({"model": j["model"]["gbtree"]})
        self.weight_drop = [float(x) for x in j["model"]["weight_drop"]]
