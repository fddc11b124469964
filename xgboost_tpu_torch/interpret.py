"""SHAP values on the data's device (the port of the JAX package's
``interpret.py``; reference ``src/tree/tree_model.cc`` TreeShap and
CalculateContributionsInteractions :552-581).

The JAX package's leaf-path reformulation of TreeShap, as tensor programs.
A row meets a leaf's path only through the bits "does the row go the
path's way at each (merged) path feature"; the path's cover ratios ``z``
do not depend on the row. For each leaf and path feature ``k`` the Shapley
term is a function of the row's ``D``-bit mask: a ``[2^D, D]`` table per
leaf (``[2^D, D, D]`` for interactions), built once per tree as one
batched float64 polynomial DP over every mask, skip index and leaf of the
tree (``leaf_tables``). Every row then gathers its mask's entries and one
float64 product sums them into the feature columns. Paths with more than
``_TABLE_MAX_D`` unique features run the same DP on the rows' own bits
instead (``_weight_sums`` over rows, batched over the tree's deep leaves
and skip indices, rows in chunks of ``_CHUNK_BYTES``).

The per-tree bookkeeping (leaf paths, merged features, cover ratios, the
expected value, Saabas node expectations) reads the host tree arrays with
numpy in float32, as the JAX package does; everything per row runs on the
device of the data. ``path_counts`` counts the leaf paths each route took.

Behaviours of the JAX package kept: contributions ignore the DMatrix's own
``base_margin`` (the bias column gets the Booster's base margin) and any
``iteration_range`` / ``ntree_limit``; DART trees count with their weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["predict_contribs", "predict_interactions", "contribs",
           "interactions", "TreePlan", "leaf_tables", "path_counts",
           "reset_path_counts"]

# paths with more unique features than this use the row DP instead of the
# 2^D mask table (table memory and build are exponential in D)
_TABLE_MAX_D = 12
# bytes one batched step may hold (DP coefficients, per-row gathers)
_CHUNK_BYTES = 256 << 20

#: leaf paths evaluated by each route since the last reset (host counts)
path_counts: Dict[str, int] = {"table": 0, "deep": 0}

_F64 = torch.float64


# ---------------------------------------------------------------------------
# per-tree host bookkeeping (numpy, float32 as in the JAX package)
# ---------------------------------------------------------------------------

def _expected_value(tree) -> float:
    """Cover-weighted mean leaf value."""
    leaves = tree.left_children == -1
    w = tree.sum_hessian[leaves]
    v = tree.split_conditions[leaves]
    tot = w.sum()
    return float((w * v).sum() / tot) if tot > 0 else float(
        v.mean() if len(v) else 0.0)


def _leaf_paths(tree):
    """Yield (leaf_node, [(node, go_left_bool), ...] root->leaf edges)."""
    stack = [(0, [])]
    while stack:
        node, path = stack.pop()
        if tree.left_children[node] == -1:
            yield node, path
            continue
        stack.append((tree.left_children[node], path + [(node, True)]))
        stack.append((tree.right_children[node], path + [(node, False)]))


def _merge_path(tree, path):
    """Merge repeated features along a path: per unique feature, ``z`` the
    product of its edges' cover ratios (float32), and its edges (the row's
    bit is the AND over them). Returns (feats, z, edge_groups)."""
    feats: List[int] = []
    zs: List[np.float32] = []
    groups: List[List[Tuple[int, bool]]] = []
    index: Dict[int, int] = {}
    for node, go_left in path:
        f = int(tree.split_indices[node])
        child = (tree.left_children[node] if go_left
                 else tree.right_children[node])
        ratio = np.float32(tree.sum_hessian[child]) / np.float32(
            max(tree.sum_hessian[node], 1e-30))
        if f in index:
            zs[index[f]] = np.float32(zs[index[f]] * ratio)
            groups[index[f]].append((node, go_left))
        else:
            index[f] = len(feats)
            feats.append(f)
            zs.append(ratio)
            groups.append([(node, go_left)])
    return (np.asarray(feats, np.int64), np.asarray(zs, np.float64), groups)


def _node_values(tree) -> np.ndarray:
    """Saabas's node expectations: a leaf's value, an internal node's the
    cover-weighted mean of its children's, in float32 with the JAX
    package's rounding (``(nv_l * w_l + nv_r * w_r) / max(w_l + w_r,
    1e-30)``), computed from the deepest level up."""
    n = tree.num_nodes
    left, right = tree.left_children, tree.right_children
    depth = np.zeros(n, np.int64)
    order = [0]
    for i in order:  # BFS: a parent's depth is known before its children's
        if left[i] != -1:
            depth[left[i]] = depth[right[i]] = depth[i] + 1
            order.extend((int(left[i]), int(right[i])))
    nv = tree.split_conditions.astype(np.float32).copy()
    h = tree.sum_hessian.astype(np.float32)
    for d in range(int(depth.max(initial=0)) - 1, -1, -1):
        i = np.flatnonzero((depth == d) & (left != -1))
        if not len(i):
            continue
        li, ri = left[i], right[i]
        tot = np.maximum(h[li] + h[ri], np.float32(1e-30))
        nv[i] = (nv[li] * h[li] + nv[ri] * h[ri]) / tot
    return nv


class TreePlan:
    """One tree's leaf paths as padded arrays: for leaf ``l`` (the leaves
    with a path and a value other than 0, in the JAX package's order) its
    value ``v[l]``, ``D[l]`` unique features ``feats[l, :D]`` with cover
    ratios ``z[l, :D]``, and its edges (``e_node``, ``e_left``, the
    feature slot ``e_slot``; ``e_valid`` marks the real ones)."""

    def __init__(self, tree) -> None:
        self.tree = tree
        self.expected = _expected_value(tree)
        rows = []
        for leaf, path in _leaf_paths(tree):
            v = float(tree.split_conditions[leaf])
            if not path or v == 0.0:
                continue
            feats, z, groups = _merge_path(tree, path)
            rows.append((v, feats, z, groups))
        L = len(rows)
        self.L = L
        self.Dm = max((len(r[1]) for r in rows), default=0)
        P = max((sum(len(g) for g in r[3]) for r in rows), default=0)
        self.v = np.asarray([r[0] for r in rows], np.float64)
        self.D = np.asarray([len(r[1]) for r in rows], np.int64)
        self.feats = np.full((L, self.Dm), -1, np.int64)
        self.z = np.zeros((L, self.Dm), np.float64)
        self.e_node = np.zeros((L, P), np.int64)
        self.e_left = np.zeros((L, P), bool)
        self.e_slot = np.zeros((L, P), np.int64)
        self.e_valid = np.zeros((L, P), bool)
        for l, (_, feats, z, groups) in enumerate(rows):
            self.feats[l, :len(feats)] = feats
            self.z[l, :len(z)] = z
            p = 0
            for k, grp in enumerate(groups):
                for node, gl in grp:
                    self.e_node[l, p], self.e_left[l, p] = node, gl
                    self.e_slot[l, p], self.e_valid[l, p] = k, True
                    p += 1

    def select(self, which: np.ndarray) -> Dict[str, np.ndarray]:
        """The arrays of the leaves ``which`` (bool [L]), cut to their own
        widest path."""
        D = self.D[which]
        Dm = int(D.max(initial=0))
        return dict(v=self.v[which], D=D, feats=self.feats[which, :Dm],
                    z=self.z[which, :Dm])


# ---------------------------------------------------------------------------
# the polynomial DP, batched over masks or rows, leaves and skip indices
# ---------------------------------------------------------------------------

def _shapley_weights(D: np.ndarray, width: int, pair: bool) -> np.ndarray:
    """[L, width]: coefficient ``s``'s Shapley weight on a path of ``D``
    features without one (``s! (D-1-s)! / D!``), or without two for an
    interaction (the JAX package's ``_shap_weight_sum`` on the path less
    ``j``: ``s! (D-2-s)! / (D-1)!``); 0 past the polynomial's degree."""
    out = np.zeros((len(D), width), np.float64)
    for l, d in enumerate(D):
        n = int(d) - 1 if pair else int(d)
        for s in range(max(n, 0)):
            out[l, s] = (math.factorial(s) * math.factorial(n - 1 - s)
                         / math.factorial(n))
    return out


def _active(D: np.ndarray, Dm: int, pair: bool) -> np.ndarray:
    """[Dm (factor), L, skip...] bool: whether factor ``j`` of leaf ``l``
    enters the product that leaves out the skip index(es)."""
    j = np.arange(Dm)[:, None]
    on = j < D[None, :]  # [Dm, L]
    k = np.arange(Dm)
    if not pair:
        return on[:, :, None] & (j[:, :, None] != k[None, None, :])
    i = k[:, None]
    kk = k[None, :]
    return (on[:, :, None, None] & (j[:, :, None, None] != i[None, None])
            & (j[:, :, None, None] != kk[None, None]))


def _weight_sums(z: torch.Tensor, o: torch.Tensor, D: np.ndarray,
                 pair: bool) -> torch.Tensor:
    """The Shapley-weighted sums ``U`` of the polynomial ``prod_j (z_j +
    o_j x)`` over each leaf's path without the skip index ``k`` (``[R, L,
    Dm]``), or without ``i`` and ``j`` (``[R, L, Dm, Dm]``, ``pair``).
    ``z`` is [L, Dm] float64, ``o`` [R, L or 1, Dm] float64 bits (rows, or
    every mask); factors enter in ascending order, each step the JAX
    package's ``new[s] = coef[s] * z_j + coef[s-1] * o_j``."""
    R, L, Dm = o.shape[0], z.shape[0], z.shape[1]
    dev = z.device
    act = _active(D, Dm, pair)
    skip = act.shape[2:]
    coef = torch.zeros((R, L) + skip + (Dm,), dtype=_F64, device=dev)
    coef[..., 0] = 1.0
    extra = (1,) * (len(skip) + 1)
    for j in range(Dm):
        if not act[j].any():
            continue
        a = torch.as_tensor(act[j], device=dev).view((1, L) + skip + (1,))
        new = coef * z[:, j].view((1, L) + extra)
        new[..., 1:] += coef[..., :-1] * o[:, :, j].view(
            (o.shape[0], o.shape[1]) + extra)
        coef = torch.where(a, new, coef)
    w = torch.as_tensor(_shapley_weights(D, Dm, pair), device=dev)
    return (coef * w.view((1, L) + (1,) * len(skip) + (Dm,))).sum(-1)


def _terms(U: torch.Tensor, o: torch.Tensor, z: torch.Tensor,
           D: np.ndarray, pair: bool) -> torch.Tensor:
    """``(o_k - z_k) U_k`` per skip index ([R, L, Dm]), or ``((o_j - z_j)
    (o_i - z_i)) U_ij`` for ``i != j`` ([R, L, Dm(i), Dm(j)]); 0 on the
    padding (past a leaf's ``D``) and on the diagonal."""
    dev = z.device
    Dm = z.shape[1]
    oz = o - z.unsqueeze(0)  # [R, L, Dm]
    k = np.arange(Dm)
    valid = k[None, :] < D[:, None]  # [L, Dm]
    if not pair:
        return torch.where(torch.as_tensor(valid, device=dev), oz * U,
                           torch.zeros((), dtype=_F64, device=dev))
    ok = valid[:, :, None] & valid[:, None, :] & (k[:, None] != k[None, :])
    t = (oz.unsqueeze(2) * oz.unsqueeze(3)) * U  # (o_j - z_j)(o_i - z_i)
    return torch.where(torch.as_tensor(ok, device=dev), t,
                       torch.zeros((), dtype=_F64, device=dev))


def _mask_bits(Dm: int, device) -> torch.Tensor:
    """[2^Dm, 1, Dm] float64: bit k of mask m."""
    m = torch.arange(1 << Dm, device=device).unsqueeze(1)
    return ((m >> torch.arange(Dm, device=device)) & 1).to(_F64).unsqueeze(1)


def _leaf_chunk(D: int, pair: bool) -> int:
    """Leaves of path length ``D`` per batched table build within
    ``_CHUNK_BYTES`` (the DP's coefficients and their temporaries)."""
    per_leaf = (1 << D) * D ** (3 if pair else 2) * 8 * 4
    return max(1, _CHUNK_BYTES // max(per_leaf, 1))


def leaf_tables(sel: Dict[str, np.ndarray], device, pair: bool = False
                ) -> Tuple[torch.Tensor, np.ndarray]:
    """The mask tables of the leaves ``sel`` (``TreePlan.select``) on
    ``device``: ``(tables, first)``, leaf ``l``'s table the ``2^D_l`` rows
    from ``first[l]`` of the float64 ``tables`` [sum 2^D_l, W]; row ``m``
    holds ``(o_k - z_k) U_k`` for the bits ``o`` of ``m`` (the JAX
    package's ``_leaf_tables``; ``W`` = ``Dm``, the widest path), or the
    pair terms ``[Dm, Dm]`` flattened (``W = Dm^2``) for interactions,
    zero-padded. One batched DP per path length and chunk of leaves."""
    D = sel["D"]
    Dm = int(D.max(initial=0))
    W = Dm * Dm if pair else Dm
    sizes = np.left_shift(1, D)
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    tables = torch.zeros((int(sizes.sum()), W), dtype=_F64, device=device)
    for d in np.unique(D):
        d = int(d)
        idx = np.flatnonzero(D == d)
        bits = _mask_bits(d, device)
        z = torch.as_tensor(sel["z"][idx, :d], device=device)
        step = _leaf_chunk(d, pair)
        for lo in range(0, len(idx), step):
            part, zc = idx[lo:lo + step], z[lo:lo + step]
            U = _weight_sums(zc, bits, D[part], pair)
            tab = _terms(U, bits.expand(-1, len(part), -1), zc, D[part],
                         pair).transpose(0, 1)  # [Lc, 2^d, d(, d)]
            if d < Dm:
                tab = torch.nn.functional.pad(
                    tab, (0, Dm - d) * (2 if pair else 1))
            rows = first[part][:, None] + np.arange(1 << d)[None, :]
            tables[torch.as_tensor(rows.reshape(-1), device=device)] = (
                tab.reshape(-1, W))
    return tables, first


# ---------------------------------------------------------------------------
# the row pass
# ---------------------------------------------------------------------------

def _node_go_left(tree, X: torch.Tensor) -> torch.Tensor:
    """[n, nodes] bool: would the row go LEFT at each internal node (missing
    -> the default child; at a categorical node a present category in the
    node's set goes right), one gather of ``X[:, split_indices]`` for every
    node and one ``isin`` for the categorical ones."""
    dev = X.device
    feat = torch.as_tensor(tree.split_indices.astype(np.int64), device=dev)
    cond = torch.as_tensor(tree.split_conditions.astype(np.float32),
                           device=dev)
    dleft = torch.as_tensor(tree.default_left.astype(bool), device=dev)
    v = X.index_select(1, feat)  # [n, nodes]
    miss = torch.isnan(v)
    left = v < cond
    cat = np.flatnonzero(tree.categorical_nodes())
    if len(cat):
        sets = [tree.node_categories(int(i)).astype(np.int64) for i in cat]
        W = int(max(int(s.max(initial=-1)) for s in sets)) + 2
        keys = np.concatenate([j * W + s for j, s in enumerate(sets)])
        ci = torch.as_tensor(cat, device=dev)
        vc = v.index_select(1, ci)
        codes = torch.where(torch.isnan(vc), torch.full_like(vc, -1.0),
                            vc).clamp(-1.0, float(W - 1)).to(torch.int64)
        slot = torch.arange(len(cat), device=dev) * W
        in_set = torch.isin(codes + slot, torch.as_tensor(keys, device=dev))
        left[:, ci] = ~in_set
    out = torch.where(miss, dleft, left)
    return out & torch.as_tensor(tree.left_children != -1, device=dev)


def _path_bits(plan: TreePlan, go_left: torch.Tensor) -> torch.Tensor:
    """[n, L, Dm] bool: the row goes the path's way at every edge of each
    path feature (AND over the feature's edges)."""
    dev = go_left.device
    n = go_left.shape[0]
    L, P, Dm = plan.e_node.shape[0], plan.e_node.shape[1], plan.Dm
    node = torch.as_tensor(plan.e_node, device=dev)
    ok = go_left[:, node.reshape(-1)].view(n, L, P) == torch.as_tensor(
        plan.e_left, device=dev)
    bad = (~ok & torch.as_tensor(plan.e_valid, device=dev)).to(torch.int32)
    miss = torch.zeros((n, L, Dm), dtype=torch.int32, device=dev)
    slot = torch.as_tensor(plan.e_slot, device=dev)
    miss.scatter_add_(2, slot.unsqueeze(0).expand(n, L, P), bad)
    return miss == 0


def _row_bytes(plan: TreePlan, pair: bool, deep: int) -> int:
    """Bytes per row of one tree's row pass (go-left bits, edge checks, the
    gathered terms, the deep leaves' DP)."""
    L, P, Dm = plan.L, plan.e_node.shape[1], max(plan.Dm, 1)
    width = Dm * Dm if pair else Dm
    dp = deep * Dm ** (3 if pair else 2) * 8 * 4
    return (plan.tree.num_nodes * 2 + L * P * 6
            + L * width * 8 * (8 if pair else 4) + dp + 64)


def _row_terms(plan: TreePlan, X: torch.Tensor, tables, is_deep: np.ndarray,
               pair: bool) -> torch.Tensor:
    """[n, L, Dm] (or [n, L, Dm, Dm]) terms of every leaf for the rows
    ``X``: table leaves gather their mask's entries, deep leaves run the DP
    on the rows' own bits."""
    dev = X.device
    n, L, Dm = X.shape[0], plan.L, plan.Dm
    obits = _path_bits(plan, _node_go_left(plan.tree, X))
    shape = (n, L) + (Dm,) * (2 if pair else 1)
    out = torch.zeros(shape, dtype=_F64, device=dev)
    tab_idx = np.flatnonzero(~is_deep)
    if len(tab_idx):
        tables, first = tables
        Dl = plan.D[tab_idx]
        Dt = int(Dl.max())
        ti = torch.as_tensor(tab_idx, device=dev)
        # each leaf's own bits (a padded slot's bit reads True)
        own = torch.as_tensor(np.arange(Dt)[None, :] < Dl[:, None],
                              device=dev)
        ob = (obits.index_select(1, ti)[:, :, :Dt] & own).to(torch.int64)
        mask = (ob << torch.arange(Dt, device=dev)).sum(-1)  # [n, Lt]
        row = torch.as_tensor(first, device=dev) + mask
        got = tables[row.reshape(-1)].view(
            (n, len(tab_idx)) + (Dt,) * (2 if pair else 1))
        pad = Dm - Dt
        if pad:
            got = torch.nn.functional.pad(got, (0, pad) * (2 if pair else 1))
        out[:, ti] = got
    deep_idx = np.flatnonzero(is_deep)
    if len(deep_idx):
        sel = plan.select(is_deep)
        Dd = sel["z"].shape[1]
        di = torch.as_tensor(deep_idx, device=dev)
        o = obits.index_select(1, di)[:, :, :Dd].to(_F64)
        z = torch.as_tensor(sel["z"], device=dev)
        U = _weight_sums(z, o, sel["D"], pair)
        t = _terms(U, o, z, sel["D"], pair)
        pad = Dm - Dd
        if pad:
            t = torch.nn.functional.pad(t, (0, pad) * (2 if pair else 1))
        out[:, di] = t
    return out


def _chunks(plan: TreePlan, n: int, pair: bool, deep: int):
    step = max(1, _CHUNK_BYTES // _row_bytes(plan, pair, deep))
    for lo in range(0, n, step):
        yield lo, min(n, lo + step)


def _tree_inputs(plan: TreePlan, device, pair: bool):
    """(is_deep [L], ``leaf_tables`` of the table leaves or None) of one
    tree; counts the paths of each route."""
    is_deep = plan.D > _TABLE_MAX_D
    path_counts["deep"] += int(is_deep.sum())
    path_counts["table"] += int((~is_deep).sum())
    tables = (leaf_tables(plan.select(~is_deep), device, pair)
              if (~is_deep).any() else None)
    return is_deep, tables


def _tree_contribs(plan: TreePlan, X: torch.Tensor) -> torch.Tensor:
    """[n, F+1] float64 contributions of one tree (the JAX package's
    ``_vector_contribs``): the expected value in the bias column, each
    leaf's terms times its value summed into their features' columns by
    one float64 product with a one-hot ``[L*Dm, F+1]``."""
    dev = X.device
    n, F = X.shape
    phi = torch.zeros((n, F + 1), dtype=_F64, device=dev)
    phi[:, F] = plan.expected
    if not plan.L:
        return phi
    is_deep, tables = _tree_inputs(plan, dev, False)
    L, Dm = plan.L, plan.Dm
    cols = np.where(plan.feats >= 0, plan.feats, F + 1).reshape(-1)
    onehot = np.zeros((L * Dm, F + 2), np.float64)
    onehot[np.arange(L * Dm), cols] = 1.0
    onehot = torch.as_tensor(onehot[:, :F + 1], device=dev)
    v = torch.as_tensor(plan.v, device=dev).view(1, L, 1)
    for lo, hi in _chunks(plan, n, False, int(is_deep.sum())):
        t = _row_terms(plan, X[lo:hi], tables, is_deep, False) * v
        phi[lo:hi] += t.reshape(hi - lo, L * Dm) @ onehot
    return phi


def _tree_interactions(plan: TreePlan, X: torch.Tensor, out: torch.Tensor,
                       g: int, w: float) -> None:
    """Add ``w`` times one tree's [n, F+1, F+1] interaction values (the
    JAX package's ``_vector_interactions``, off the diagonal: ``(t_ij +
    t_ji) * v / 2``) into ``out[:, g]``, by one deterministic accumulating
    ``index_put_`` over the leaves' cells per row chunk."""
    if not plan.L:
        return
    dev = X.device
    n, F = X.shape
    C = (F + 1) * (F + 1)
    is_deep, tables = _tree_inputs(plan, dev, True)
    L, Dm = plan.L, plan.Dm
    f = np.where(plan.feats >= 0, plan.feats, 0)
    cell = f[:, :, None] * (F + 1) + f[:, None, :]  # [L, Dm, Dm]
    valid = (plan.feats[:, :, None] >= 0) & (plan.feats[:, None, :] >= 0)
    cell = torch.as_tensor(np.where(valid, cell, C).reshape(-1), device=dev)
    half = torch.as_tensor(0.5 * plan.v, device=dev).view(1, L, 1, 1)
    for lo, hi in _chunks(plan, n, True, int(is_deep.sum())):
        t = _row_terms(plan, X[lo:hi], tables, is_deep, True)
        sym = (t + t.transpose(-1, -2)) * half
        acc = torch.zeros((hi - lo, C + 1), dtype=_F64, device=dev)
        lin = (torch.arange(hi - lo, device=dev).unsqueeze(1) * (C + 1)
               + cell.unsqueeze(0))
        acc.view(-1).index_put_((lin.reshape(-1),), sym.reshape(-1),
                                accumulate=True)
        out[lo:hi, g] += acc[:, :C].view(hi - lo, F + 1, F + 1) * w


def _saabas(tree, X: torch.Tensor) -> torch.Tensor:
    """[n, F+1] float64 Saabas attributions of one tree (the JAX package's
    ``_saabas``): the root's expectation in the bias column, then every
    row steps down its path, level by level for all rows together, adding
    each step's change of node expectation (float32) to the split's
    feature."""
    dev = X.device
    n, F = X.shape
    nv = torch.as_tensor(_node_values(tree), device=dev)
    phi = torch.zeros((n, F + 2), dtype=_F64, device=dev)
    phi[:, F] = nv[0].to(_F64)
    go_left = _node_go_left(tree, X)
    left = torch.as_tensor(tree.left_children.astype(np.int64), device=dev)
    right = torch.as_tensor(tree.right_children.astype(np.int64),
                            device=dev)
    feat = torch.as_tensor(tree.split_indices.astype(np.int64), device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(tree.max_depth()):
        active = left[cur] != -1
        gl = go_left.gather(1, cur.unsqueeze(1)).squeeze(1)
        nxt = torch.where(gl, left[cur], right[cur])
        nxt = torch.where(active, nxt, cur)
        d = torch.where(active, nv[nxt] - nv[cur],
                        torch.zeros((), dtype=nv.dtype, device=dev))
        col = torch.where(active, feat[cur], torch.full_like(cur, F + 1))
        phi.scatter_add_(1, col.unsqueeze(1), d.to(_F64).unsqueeze(1))
        cur = nxt
    return phi[:, :F + 1]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _forest(booster):
    """(host trees, their groups, their weights as floats) of the model."""
    booster._configure()
    model = booster._gbm.model
    trees = model.trees
    tw = booster._gbm.tree_weights()
    tw = (np.asarray(tw.cpu(), np.float32) if tw is not None
          else np.ones(len(trees), np.float32))
    return trees, list(model.tree_info), tw


def contribs(booster, X: torch.Tensor, approx: bool = False) -> torch.Tensor:
    """[n, K, F+1] float64 SHAP contributions (``approx``: Saabas) of the
    rows ``X`` ([n, F] float32, NaN missing) on ``X``'s device, bias
    column last: per tree, times its weight, into its group."""
    n, F = X.shape
    K = booster.n_groups
    trees, info, tw = _forest(booster)
    out = torch.zeros((n, K, F + 1), dtype=_F64, device=X.device)
    for t, g, w in zip(trees, info, tw):
        phi = _saabas(t, X) if approx else _tree_contribs(TreePlan(t), X)
        out[:, g, :] += phi * float(w)
    out[:, :, F] += booster._base_margin_val
    return out


def interactions(booster, X: torch.Tensor) -> torch.Tensor:
    """[n, K, F+1, F+1] float64 SHAP interaction values of the rows ``X``
    on its device; the diagonal is the feature's contribution less its
    row's off-diagonal sum, so every row sums to the contributions."""
    n, F = X.shape
    K = booster.n_groups
    trees, info, tw = _forest(booster)
    out = torch.zeros((n, K, F + 1, F + 1), dtype=_F64, device=X.device)
    for t, g, w in zip(trees, info, tw):
        _tree_interactions(TreePlan(t), X, out, g, float(w))
    base = contribs(booster, X)
    diag = out.diagonal(dim1=-2, dim2=-1)
    offsum = out.sum(-1) - diag
    diag.copy_(base - offsum)
    return out


def predict_contribs(booster, dmat, approx: bool = False) -> np.ndarray:
    """``[n, F+1]`` (``[n, K, F+1]`` for K groups) float64 contributions
    plus the bias column (reference ``pred_contribs``); exact TreeShap, or
    Saabas with ``approx``. Computed on the matrix's device."""
    out = contribs(booster, dmat.data, approx).cpu().numpy()
    return out[:, 0, :] if out.shape[1] == 1 else out


def predict_interactions(booster, dmat) -> np.ndarray:
    """``[n, F+1, F+1]`` (``[n, K, F+1, F+1]``) float64 SHAP interaction
    values (reference ``pred_interactions``), on the matrix's device."""
    out = interactions(booster, dmat.data).cpu().numpy()
    return out[:, 0] if out.shape[1] == 1 else out


def reset_path_counts() -> None:
    path_counts["table"] = path_counts["deep"] = 0
