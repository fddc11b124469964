"""RegTree: struct-of-arrays decision tree (numerical nodes).

The port of the JAX package's ``tree/model.py`` (reference
``include/xgboost/tree_model.h:131``; JSON layout ``doc/model.schema``,
``src/tree/tree_model.cc:898-911``). Host numpy arrays; node 0 is the root,
leaves have ``left_children[i] == -1`` and keep their (post-eta) leaf value
in ``split_conditions[i]``; a present value ``x < split_condition`` goes
left, missing goes to the default child.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

__all__ = ["RegTree"]


@dataclasses.dataclass
class RegTree:
    left_children: np.ndarray  # int32 [n]
    right_children: np.ndarray  # int32 [n]
    parents: np.ndarray  # int32 [n]
    split_indices: np.ndarray  # int32 [n]
    split_conditions: np.ndarray  # float32 [n] (leaf value for leaves)
    default_left: np.ndarray  # bool [n]
    base_weights: np.ndarray  # float32 [n]
    loss_changes: np.ndarray  # float32 [n]
    sum_hessian: np.ndarray  # float32 [n]

    @property
    def num_nodes(self) -> int:
        return int(self.left_children.shape[0])

    def max_depth(self) -> int:
        depth = np.zeros(self.num_nodes, dtype=np.int32)
        for i in range(1, self.num_nodes):
            depth[i] = depth[self.parents[i]] + 1
        return int(depth.max(initial=0))

    @classmethod
    def from_heap(cls, is_split: np.ndarray, feature: np.ndarray,
                  split_cond: np.ndarray, default_left: np.ndarray,
                  weight: np.ndarray, loss_chg: np.ndarray,
                  sum_hess: np.ndarray, eta: float) -> "RegTree":
        """Compact a heap-layout tree (children of heap node i at
        2i+1/2i+2; ``is_split`` already gamma-pruned) into BFS order."""
        order: List[int] = []
        queue = [0]
        while queue:
            h = queue.pop(0)
            order.append(h)
            if is_split[h]:
                queue.extend((2 * h + 1, 2 * h + 2))
        compact_of: Dict[int, int] = {h: i for i, h in enumerate(order)}
        n = len(order)
        lc = np.full(n, -1, np.int32)
        rc = np.full(n, -1, np.int32)
        par = np.full(n, -1, np.int32)
        sidx = np.zeros(n, np.int32)
        scond = np.zeros(n, np.float32)
        dleft = np.zeros(n, bool)
        bw = np.zeros(n, np.float32)
        lchg = np.zeros(n, np.float32)
        shess = np.zeros(n, np.float32)
        eta32 = np.float32(eta)
        for idx, h in enumerate(order):
            bw[idx] = eta32 * weight[h]
            shess[idx] = sum_hess[h]
            if h > 0:
                par[idx] = compact_of[(h - 1) // 2]
            if is_split[h]:
                lc[idx] = compact_of[2 * h + 1]
                rc[idx] = compact_of[2 * h + 2]
                sidx[idx] = feature[h]
                scond[idx] = split_cond[h]
                dleft[idx] = bool(default_left[h])
                lchg[idx] = loss_chg[h]
            else:
                scond[idx] = eta32 * weight[h]  # leaf value
        return cls(left_children=lc, right_children=rc, parents=par,
                   split_indices=sidx, split_conditions=scond,
                   default_left=dleft, base_weights=bw, loss_changes=lchg,
                   sum_hessian=shess)

    def to_json(self, tree_id: int = 0) -> dict:
        n = self.num_nodes
        return {
            "tree_param": {
                "num_nodes": str(n),
                "num_feature": str(int(self.split_indices.max(initial=0)) + 1),
                "num_deleted": "0",
                "size_leaf_vector": "0",
            },
            "id": tree_id,
            "left_children": self.left_children.tolist(),
            "right_children": self.right_children.tolist(),
            "parents": self.parents.tolist(),
            "split_indices": self.split_indices.tolist(),
            "split_conditions": [float(x) for x in self.split_conditions],
            "default_left": [int(x) for x in self.default_left],
            "split_type": [0] * n,
            "categories": [],
            "categories_nodes": [],
            "categories_segments": [],
            "categories_sizes": [],
            "base_weights": [float(x) for x in self.base_weights],
            "loss_changes": [float(x) for x in self.loss_changes],
            "sum_hessian": [float(x) for x in self.sum_hessian],
        }

    @classmethod
    def from_json(cls, j: dict) -> "RegTree":
        n = len(j["left_children"])
        if any(int(t) != 0 for t in j.get("split_type", [])) or \
                j.get("categories_nodes"):
            raise NotImplementedError(
                "categorical splits are not ported yet")
        return cls(
            left_children=np.asarray(j["left_children"], np.int32),
            right_children=np.asarray(j["right_children"], np.int32),
            parents=np.asarray(j["parents"], np.int32),
            split_indices=np.asarray(j["split_indices"], np.int32),
            split_conditions=np.asarray(j["split_conditions"], np.float32),
            default_left=np.asarray(j["default_left"], bool),
            base_weights=np.asarray(j.get("base_weights", [0.0] * n), np.float32),
            loss_changes=np.asarray(j.get("loss_changes", [0.0] * n), np.float32),
            sum_hessian=np.asarray(j.get("sum_hessian", [0.0] * n), np.float32),
        )

    def predict_one(self, x: np.ndarray) -> float:
        """Host reference walk of one row (the predictor's oracle)."""
        i = 0
        while self.left_children[i] != -1:
            v = x[self.split_indices[i]]
            if np.isnan(v):
                left = self.default_left[i]
            else:
                left = v < self.split_conditions[i]
            i = self.left_children[i] if left else self.right_children[i]
        return float(self.split_conditions[i])
