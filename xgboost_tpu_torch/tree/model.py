"""RegTree: struct-of-arrays decision tree.

The port of the JAX package's ``tree/model.py`` (reference
``include/xgboost/tree_model.h:131``; JSON layout ``doc/model.schema``,
``src/tree/tree_model.cc:898-911``). Host numpy arrays; node 0 is the root,
leaves have ``left_children[i] == -1`` and keep their (post-eta) leaf value
in ``split_conditions[i]``; at a numerical node a present value
``x < split_condition`` goes left, missing goes to the default child. A
categorical node (``split_type[i] == 1``) sends a present value RIGHT iff
its category is in the node's set (``categories[i]``; reference
``common/categorical.h`` Decision); a one-hot node's set is its single
category, also kept in ``split_conditions[i]``. The dump generators
(``dump_text``, ``dump_json_ref``, ``dump_dot``) write the reference's
text, JSON and Graphviz dumps.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

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
    # 0 numerical, 1 categorical; None: every node numerical
    split_type: Optional[np.ndarray] = None  # int8 [n]
    # per node its right-going category ids, sorted (empty where none);
    # None when no node has a set
    categories: Optional[List[np.ndarray]] = None

    @property
    def num_nodes(self) -> int:
        return int(self.left_children.shape[0])

    def categorical_nodes(self) -> np.ndarray:
        """[n] bool: internal nodes that split on a category."""
        if self.split_type is None:
            return np.zeros(self.num_nodes, bool)
        return (self.split_type == 1) & (self.left_children != -1)

    def node_categories(self, i: int) -> np.ndarray:
        """The right-going categories of categorical node ``i``: its set,
        or its one-hot category from ``split_conditions``."""
        if self.categories is not None and len(self.categories[i]) > 0:
            return np.asarray(self.categories[i], np.int32)
        return np.asarray([int(self.split_conditions[i])], np.int32)

    def max_depth(self) -> int:
        depth = np.zeros(self.num_nodes, dtype=np.int32)
        for i in range(1, self.num_nodes):
            depth[i] = depth[self.parents[i]] + 1
        return int(depth.max(initial=0))

    @classmethod
    def from_heap(cls, is_split: np.ndarray, feature: np.ndarray,
                  split_cond: np.ndarray, default_left: np.ndarray,
                  weight: np.ndarray, loss_chg: np.ndarray,
                  sum_hess: np.ndarray, eta: float,
                  cat_features: Optional[np.ndarray] = None,
                  cat_set: Optional[np.ndarray] = None) -> "RegTree":
        """Compact a heap-layout tree (children of heap node i at
        2i+1/2i+2; ``is_split`` already gamma-pruned) into BFS order.
        ``cat_features`` [F] bool marks the categorical features and
        ``cat_set`` [max_nodes, B] bool holds each node's right-going set;
        a categorical node keeps its set in ``categories`` and, when the
        set is one category, that category in ``split_conditions``."""
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
        stype = np.zeros(n, np.int8)
        cats = [np.empty(0, np.int32) for _ in range(n)]
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
                if cat_features is not None and cat_features[feature[h]]:
                    stype[idx] = 1
                    cats[idx] = np.flatnonzero(cat_set[h]).astype(np.int32)
                    scond[idx] = (float(cats[idx][0]) if len(cats[idx]) == 1
                                  else 0.0)
                dleft[idx] = bool(default_left[h])
                lchg[idx] = loss_chg[h]
            else:
                scond[idx] = eta32 * weight[h]  # leaf value
        any_cats = bool(stype.any())
        return cls(left_children=lc, right_children=rc, parents=par,
                   split_indices=sidx, split_conditions=scond,
                   default_left=dleft, base_weights=bw, loss_changes=lchg,
                   sum_hessian=shess, split_type=stype,
                   categories=cats if any_cats else None)

    @classmethod
    def from_alloc(cls, left: np.ndarray, right: np.ndarray,
                   feature: np.ndarray, split_cond: np.ndarray,
                   default_left: np.ndarray, weight: np.ndarray,
                   loss_chg: np.ndarray, sum_hess: np.ndarray, n_nodes: int,
                   eta: float, min_split_loss: float = 0.0,
                   split_bin: Optional[np.ndarray] = None,
                   cat_features: Optional[np.ndarray] = None,
                   cat_set: Optional[np.ndarray] = None
                   ) -> Tuple["RegTree", np.ndarray]:
        """Build from an allocation-ordered tree (the lossguide grower's
        arrays; children always have larger ids than their parent): gamma
        pruning at ``min_split_loss`` (updater_prune.cc), then BFS
        compaction. Returns ``(tree, leaf value of every original id)``,
        the second the ``[len(left)]`` cache map: the value of the leaf
        that governs each original node after pruning (NaN where none
        does). A categorical node's set is its row of ``cat_set``, or its
        ``split_bin`` when that row is empty."""
        M = len(left)
        lp = left[:n_nodes].copy()
        rp = right[:n_nodes].copy()
        if min_split_loss > 0.0:
            changed = True
            while changed:
                changed = False
                for i in range(n_nodes - 1, -1, -1):
                    li, ri = lp[i], rp[i]
                    if li != -1 and lp[li] == -1 and lp[ri] == -1 \
                            and loss_chg[i] < min_split_loss:
                        lp[i] = rp[i] = -1
                        changed = True
        eta32 = np.float32(eta)
        leaf_val = np.full(M, np.nan, np.float32)
        for i in range(n_nodes):  # one ascending pass: parents come first
            if np.isnan(leaf_val[i]) and lp[i] == -1:
                leaf_val[i] = eta32 * weight[i]
            if left[i] != -1 and not np.isnan(leaf_val[i]):
                leaf_val[left[i]] = leaf_val[right[i]] = leaf_val[i]
        order: List[int] = []
        queue = [0]
        while queue:
            i = queue.pop(0)
            order.append(i)
            if lp[i] != -1:
                queue.extend((int(lp[i]), int(rp[i])))
        compact_of: Dict[int, int] = {h: k for k, h in enumerate(order)}
        nn = len(order)
        lc = np.full(nn, -1, np.int32)
        rc = np.full(nn, -1, np.int32)
        par = np.full(nn, -1, np.int32)
        sidx = np.zeros(nn, np.int32)
        scond = np.zeros(nn, np.float32)
        dleft = np.zeros(nn, bool)
        bw = np.zeros(nn, np.float32)
        lchg = np.zeros(nn, np.float32)
        shess = np.zeros(nn, np.float32)
        stype = np.zeros(nn, np.int8)
        cats = [np.empty(0, np.int32) for _ in range(nn)]
        for idx, i in enumerate(order):
            bw[idx] = eta32 * weight[i]
            shess[idx] = sum_hess[i]
            if lp[i] == -1:
                scond[idx] = eta32 * weight[i]  # leaf value
                continue
            lc[idx], rc[idx] = compact_of[lp[i]], compact_of[rp[i]]
            par[lc[idx]] = par[rc[idx]] = idx
            sidx[idx] = feature[i]
            scond[idx] = split_cond[i]
            if cat_features is not None and split_bin is not None \
                    and cat_features[feature[i]]:
                stype[idx] = 1
                cs = (np.flatnonzero(cat_set[i]).astype(np.int32)
                      if cat_set is not None else np.empty(0, np.int32))
                cats[idx] = cs if len(cs) else np.asarray([split_bin[i]],
                                                          np.int32)
                scond[idx] = (float(cats[idx][0]) if len(cats[idx]) == 1
                              else 0.0)
            dleft[idx] = bool(default_left[i])
            lchg[idx] = loss_chg[i]
        any_cats = bool(stype.any())
        tree = cls(left_children=lc, right_children=rc, parents=par,
                   split_indices=sidx, split_conditions=scond,
                   default_left=dleft, base_weights=bw, loss_changes=lchg,
                   sum_hessian=shess, split_type=stype,
                   categories=cats if any_cats else None)
        return tree, leaf_val

    def _categories_json(self) -> dict:
        """The categorical nodes' sets in the reference's segmented layout
        (``tree_model.cc:898-911``)."""
        cats: List[int] = []
        nodes: List[int] = []
        segments: List[int] = []
        sizes: List[int] = []
        for i in np.flatnonzero(self.categorical_nodes()):
            cs = [int(c) for c in self.node_categories(i)]
            nodes.append(int(i))
            segments.append(len(cats))
            cats.extend(cs)
            sizes.append(len(cs))
        return {"categories": cats, "categories_nodes": nodes,
                "categories_segments": segments, "categories_sizes": sizes}

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
            "split_type": ([int(x) for x in self.split_type]
                           if self.split_type is not None else [0] * n),
            **self._categories_json(),
            "base_weights": [float(x) for x in self.base_weights],
            "loss_changes": [float(x) for x in self.loss_changes],
            "sum_hessian": [float(x) for x in self.sum_hessian],
        }

    @classmethod
    def from_json(cls, j: dict) -> "RegTree":
        n = len(j["left_children"])
        scond = np.asarray(j["split_conditions"], np.float32).copy()
        categories = None
        if j.get("categories_nodes"):
            cats = j.get("categories", [])
            categories = [np.empty(0, np.int32) for _ in range(n)]
            for node, seg, size in zip(j["categories_nodes"],
                                       j["categories_segments"],
                                       j["categories_sizes"]):
                categories[node] = np.asarray(cats[seg:seg + size], np.int32)
                if size == 1:  # one-hot: the category is the condition
                    scond[node] = float(categories[node][0])
        return cls(
            left_children=np.asarray(j["left_children"], np.int32),
            right_children=np.asarray(j["right_children"], np.int32),
            parents=np.asarray(j["parents"], np.int32),
            split_indices=np.asarray(j["split_indices"], np.int32),
            split_conditions=scond,
            default_left=np.asarray(j["default_left"], bool),
            base_weights=np.asarray(j.get("base_weights", [0.0] * n), np.float32),
            loss_changes=np.asarray(j.get("loss_changes", [0.0] * n), np.float32),
            sum_hessian=np.asarray(j.get("sum_hessian", [0.0] * n), np.float32),
            split_type=np.asarray(j.get("split_type", [0] * n), np.int8),
            categories=categories,
        )

    def predict_one(self, x: np.ndarray) -> float:
        """Host reference walk of one row (the predictor's oracle)."""
        is_cat = self.categorical_nodes()
        i = 0
        while self.left_children[i] != -1:
            v = x[self.split_indices[i]]
            if np.isnan(v):
                left = self.default_left[i]
            elif is_cat[i]:
                left = int(v) not in self.node_categories(i)
            else:
                left = v < self.split_conditions[i]
            i = self.left_children[i] if left else self.right_children[i]
        return float(self.split_conditions[i])

    # ---- dump generators: the reference's TreeGenerator family
    # (src/tree/tree_model.cc:235 Text, :362 Json, :550 Graphviz) with its
    # per-feature-type formatting from a feature map's types: "i"
    # (indicator: the name only, yes = the value-1 child), "int" (the
    # threshold rounded up to an integer), "q"/"float" (quantitative);
    # categorical nodes by their category set, which goes right ----

    def _fname(self, i: int, names) -> str:
        f = int(self.split_indices[i])
        return names[f] if names and f < len(names) else f"f{f}"

    def _ftype(self, i: int, types) -> str:
        f = int(self.split_indices[i])
        return types[f] if types and f < len(types) else "q"

    def _is_cat(self, i: int) -> bool:
        return self.split_type is not None and bool(self.split_type[i] == 1)

    def _cats_of(self, i: int) -> List[int]:
        if self.categories is None:
            return []
        return [int(c) for c in self.categories[i]]

    def _cond(self, i: int, ftype: str) -> str:
        cond = float(self.split_conditions[i])
        return str(int(math.ceil(cond))) if ftype == "int" else f"{cond:.6g}"

    def dump_text(self, fmap: Optional[List[str]] = None,
                  with_stats: bool = False,
                  ftypes: Optional[List[str]] = None) -> str:
        """The text dump: one line per node, depth-first, tab-indented."""
        lines: List[str] = []

        def rec(i: int, depth: int) -> None:
            indent = "\t" * depth
            if self.left_children[i] == -1:
                s = f"{indent}{i}:leaf={self.split_conditions[i]:.6g}"
                if with_stats:
                    s += f",cover={self.sum_hessian[i]:.6g}"
                lines.append(s)
                return
            fname = self._fname(i, fmap)
            ftype = self._ftype(i, ftypes)
            yes, no = self.left_children[i], self.right_children[i]
            miss = yes if self.default_left[i] else no
            if self._is_cat(i):
                # the stored set goes right: yes = right (tree_model.cc:321)
                cats = "{" + ",".join(str(c) for c in self._cats_of(i)) + "}"
                s = (f"{indent}{i}:[{fname}:{cats}] "
                     f"yes={no},no={yes},missing={miss}")
            elif ftype == "i":
                nyes = no if self.default_left[i] else yes
                s = f"{indent}{i}:[{fname}] yes={nyes},no={miss}"
            else:
                s = (f"{indent}{i}:[{fname}<{self._cond(i, ftype)}] "
                     f"yes={yes},no={no},missing={miss}")
            if with_stats:
                s += (f",gain={self.loss_changes[i]:.6g}"
                      f",cover={self.sum_hessian[i]:.6g}")
            lines.append(s)
            rec(yes, depth + 1)
            rec(no, depth + 1)

        rec(0, 0)
        return "\n".join(lines)

    def dump_json_ref(self, fmap: Optional[List[str]] = None,
                      with_stats: bool = False,
                      ftypes: Optional[List[str]] = None) -> str:
        """The reference's per-node recursive JSON dump (tree_model.cc:362
        JsonGenerator: nodeid/depth/split/split_condition/yes/no/missing/
        children), not the model schema of ``to_json``."""

        def rec(i: int, depth: int) -> str:
            ind = "  " * (depth + 1)
            if self.left_children[i] == -1:
                s = (f'{{ "nodeid": {i}, '
                     f'"leaf": {float(self.split_conditions[i]):.6g}')
                if with_stats:
                    s += f', "cover": {float(self.sum_hessian[i]):.6g} '
                return s + "}"
            fname = self._fname(i, fmap)
            ftype = self._ftype(i, ftypes)
            yes, no = int(self.left_children[i]), int(self.right_children[i])
            miss = yes if self.default_left[i] else no
            head = (f'{{ "nodeid": {i}, "depth": {depth}, '
                    f'"split": {json.dumps(fname)}, ')
            if self._is_cat(i):
                cats = "[" + ", ".join(
                    str(c) for c in self._cats_of(i)) + "]"
                head += (f'"split_condition": {cats}, "yes": {no}, '
                         f'"no": {yes}, "missing": {miss}')
            elif ftype == "i":
                nyes = no if self.default_left[i] else yes
                head += f'"yes": {nyes}, "no": {miss}'
            else:
                head += (f'"split_condition": {self._cond(i, ftype)}, '
                         f'"yes": {yes}, "no": {no}, "missing": {miss}')
            if with_stats:
                head += (f', "gain": {float(self.loss_changes[i]):.6g}, '
                         f'"cover": {float(self.sum_hessian[i]):.6g}')
            return (head + ', "children": [\n'
                    + "  " * (depth + 2) + rec(yes, depth + 1) + ",\n"
                    + "  " * (depth + 2) + rec(no, depth + 1) + "\n"
                    + ind + "]}")

        return rec(0, 0)

    def dump_dot(self, fmap: Optional[List[str]] = None,
                 ftypes: Optional[List[str]] = None,
                 attrs: Optional[dict] = None) -> str:
        """The Graphviz dump (tree_model.cc:550 GraphvizGenerator): a node
        per split ("name<cond", the name alone for indicators,
        "name:{set}" for categories), yes/no edges, ", missing" on the
        default child's. ``attrs`` takes the reference's ``rankdir``,
        ``edge`` colours, ``condition_node_params``, ``leaf_node_params``
        and ``graph_attrs``."""
        attrs = attrs or {}
        yes_color = attrs.get("edge", {}).get("yes_color", "#0000FF")
        no_color = attrs.get("edge", {}).get("no_color", "#FF0000")
        rankdir = attrs.get("rankdir", "TB")
        cond_params = " ".join(
            f'{k}="{v}"' for k, v in
            attrs.get("condition_node_params", {}).items())
        leaf_params = " ".join(
            f'{k}="{v}"' for k, v in attrs.get("leaf_node_params", {}).items())
        graph_attrs = "".join(
            f'    graph [ {k}="{v}" ]\n'
            for k, v in attrs.get("graph_attrs", {}).items())
        out: List[str] = []

        def edge(i: int, child: int, left: bool, is_cat: bool) -> str:
            miss = (self.left_children[i] if self.default_left[i]
                    else self.right_children[i])
            is_missing = child == miss
            branch = (("no" if left else "yes") if is_cat
                      else ("yes" if left else "no"))
            if is_missing:
                branch += ", missing"
            color = yes_color if is_missing else no_color
            return (f'    {i} -> {child} [label="{branch}" '
                    f'color="{color}"]\n')

        def rec(i: int) -> None:
            if self.left_children[i] == -1:
                out.append(
                    f'    {i} [ label="leaf={self.split_conditions[i]:.6g}"'
                    f' {leaf_params}]\n')
                return
            fname = self._fname(i, fmap)
            yes, no = int(self.left_children[i]), int(self.right_children[i])
            is_cat = self._is_cat(i)
            if is_cat:
                cats = "{" + ",".join(str(c) for c in self._cats_of(i)) + "}"
                label = f"{fname}:{cats}"
            elif self._ftype(i, ftypes) == "i":
                label = fname
            else:
                label = f"{fname}<{float(self.split_conditions[i]):.6g}"
            out.append(f'    {i} [ label="{label}" {cond_params}]\n')
            out.append(edge(i, yes, True, is_cat))
            out.append(edge(i, no, False, is_cat))
            rec(yes)
            rec(no)

        rec(0)
        return ("digraph {\n"
                f"    graph [ rankdir={rankdir} ]\n"
                f"{graph_attrs}\n"
                + "".join(out) + "}")
