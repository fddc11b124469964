"""GBTree booster: the fused depthwise path on one device.

The port of the single-device, in-core, depthwise part of the JAX package's
``gbm/gbtree.py`` (reference ``src/gbm/gbtree.{h,cc}``: ``DoBoost``
gbtree.cc:219, ``CommitModel`` :364). Trees grown on the device stay there
as heap-layout arrays (``_PendingTree``) and become host ``RegTree``s only
when model IO asks; the prediction cache of the training rows is updated
from the grower's per-row leaf values, with no predictor pass.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..params import GBTreeParam, TrainParam
from ..predictor import StackedForest, stack_forest
from ..tree.grow import GrowParams
from ..tree.grow_fused import GrownTree, grow_tree_fused
from ..tree.model import RegTree
from ..tree.param import SplitParams

__all__ = ["GBTreeModel", "GBTree"]


class _PendingTree:
    """A device-grown tree (GrownTree minus the per-row delta)."""

    __slots__ = ("keep", "feature", "split_bin", "split_cond", "default_left",
                 "node_weight", "loss_chg", "node_h", "leaf_value", "eta",
                 "max_depth")

    def __init__(self, g: GrownTree, eta: float, max_depth: int):
        for f in self.__slots__[:-2]:
            setattr(self, f, getattr(g, f))
        self.eta = eta
        self.max_depth = max_depth

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
            h["node_weight"], h["loss_chg"], h["node_h"], eta=t.eta))
    return out


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
    iota = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    minus1 = torch.full_like(keep, -1, dtype=torch.int32)
    return StackedForest(
        left=torch.where(keep, 2 * iota + 1, minus1),
        right=torch.where(keep, 2 * iota + 2, minus1),
        feature=field("feature", 0),
        cond=torch.where(keep, field("split_cond", 0.0),
                         field("leaf_value", 0.0)),
        default_left=field("default_left", False),
        tree_group=torch.as_tensor(np.asarray(tree_info, np.int32), device=dev),
        max_depth=max(max(e.max_depth for e in entries), 1),
        n_groups=n_groups, num_feature=num_feature, heap_layout=True)


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
                   max_depth: int) -> None:
        self._entries.append(_PendingTree(grown, eta, max_depth))
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


_UNSUPPORTED_DEFAULTS = {
    "subsample": 1.0, "colsample_bytree": 1.0, "colsample_bylevel": 1.0,
    "colsample_bynode": 1.0,
}


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
        for key, default in _UNSUPPORTED_DEFAULTS.items():
            if getattr(tp, key) != default:
                raise NotImplementedError(f"{key} < 1 is not ported yet")
        if any(int(c) != 0 for c in tp.monotone_constraints):
            raise NotImplementedError("monotone_constraints are not ported yet")
        if tp.interaction_constraints:
            raise NotImplementedError(
                "interaction_constraints are not ported yet")
        if tp.grow_policy != "depthwise":
            raise NotImplementedError(
                f"grow_policy={tp.grow_policy!r} is not ported yet")
        if gp.tree_method not in ("auto", "hist", "gpu_hist", "tpu_hist"):
            raise NotImplementedError(
                f"tree_method={gp.tree_method!r} is not ported yet")
        if gp.num_parallel_tree != 1:
            raise NotImplementedError("num_parallel_tree > 1 is not ported yet")

    def _grow_params(self) -> GrowParams:
        tp = self.train_param
        return GrowParams(
            max_depth=tp.max_depth,
            split=SplitParams(
                reg_lambda=tp.reg_lambda, reg_alpha=tp.reg_alpha,
                max_delta_step=tp.max_delta_step,
                min_child_weight=tp.min_child_weight, min_split_loss=tp.gamma))

    def boost_one_round(self, binned, grad: torch.Tensor, hess: torch.Tensor,
                        margin_cache: Optional[torch.Tensor]
                        ) -> Tuple[List[GrownTree], Optional[torch.Tensor]]:
        """One round: one tree per output group, grown on the device; the
        margin cache gets each tree's per-row leaf values (gbtree.cc:219)."""
        tp = self.train_param
        cfg = self._grow_params()
        self.model.num_feature = binned.n_features
        new_trees = []
        for k in range(self.n_groups):
            g = grad[:, k] if grad.dim() == 2 else grad
            h = hess[:, k] if hess.dim() == 2 else hess
            grown = grow_tree_fused(binned.bins, g, h, binned.cut_values,
                                    float(tp.eta), float(tp.gamma), cfg)
            self.model.add_device(grown, tp.eta, k, tp.max_depth)
            new_trees.append(grown)
            if margin_cache is not None:
                margin_cache = margin_cache.clone()
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
