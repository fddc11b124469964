"""Depthwise histogram trees: the level histograms, the greedy split
search, a grower, the walk, and the judge of a given tree.

A tree is held in heap layout (``HeapTree``: the children of node ``i``
at ``2i + 1`` and ``2i + 2``). A row at a split node goes left when its
value is below the node's condition, or, when the value is missing, when
the node's default is left. Gains and weights are the reference's
second-order ones (``src/tree/param.h``): ``w = -G / (H + lambda)`` and
``gain = G^2 / (H + lambda)``, both 0 where ``H`` is below
``min_child_weight``; a split needs ``min_child_weight`` of hessian on
both sides and a loss change above ``1e-6``. The split search enumerates,
for every feature and bin ``b``, the split "bin <= b goes left", with the
missing values sent right, then left; the first best wins.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

F64 = torch.float64
RT_EPS = 1e-6
#: rows a block when a level's histogram is summed
ROW_BLOCK = 1 << 18


@dataclasses.dataclass(frozen=True)
class Params:
    max_depth: int
    eta: float
    reg_lambda: float = 1.0
    min_child_weight: float = 1.0


def calc_weight(G, H, p: Params):
    w = -G / (H + p.reg_lambda)
    return torch.where((H < p.min_child_weight) | (H <= 0), torch.zeros_like(w), w)


def calc_gain(G, H, p: Params):
    g = G * G / (H + p.reg_lambda)
    return torch.where(H < p.min_child_weight, torch.zeros_like(g), g)


@dataclasses.dataclass
class HeapTree:
    is_split: torch.Tensor  # bool [N]
    feature: torch.Tensor  # int64 [N]
    cond: torch.Tensor  # float32 [N]
    default_left: torch.Tensor  # bool [N]
    value: torch.Tensor  # float32 [N]: the leaf value where a path stops

    def to(self, device) -> "HeapTree":
        return HeapTree(*(getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)))


def heap_size(depth: int) -> int:
    return (1 << (depth + 1)) - 1


def trees_from_model(model: dict, depth: int) -> List[HeapTree]:
    """The trees of a model in the reference's JSON schema, in heap
    layout (a leaf's ``split_conditions`` entry is its value)."""
    out = []
    N = heap_size(depth)
    for t in model["learner"]["gradient_booster"]["model"]["trees"]:
        lc, rc = t["left_children"], t["right_children"]
        si, sc, dl = t["split_indices"], t["split_conditions"], t["default_left"]
        is_split = [False] * N
        feature, cond = [0] * N, [0.0] * N
        dleft, value = [False] * N, [0.0] * N
        stack = [(0, 0)]
        while stack:
            i, h = stack.pop()
            if h >= N:
                raise ValueError(f"tree {t.get('id')} is deeper than {depth}")
            if lc[i] == -1:
                value[h] = sc[i]
                continue
            is_split[h], feature[h], cond[h] = True, si[i], sc[i]
            dleft[h] = bool(dl[i])
            stack += [(lc[i], 2 * h + 1), (rc[i], 2 * h + 2)]
        out.append(HeapTree(torch.tensor(is_split), torch.tensor(feature),
                            torch.tensor(cond, dtype=torch.float32),
                            torch.tensor(dleft),
                            torch.tensor(value, dtype=torch.float32)))
    return out


def route(tree: HeapTree, X: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """Each row one step down from ``node`` by the raw values ``X``; rows
    at a leaf stay."""
    f = tree.feature[node]
    x = torch.gather(X, 1, f[:, None])[:, 0]
    left = torch.where(torch.isnan(x), tree.default_left[node], x < tree.cond[node])
    child = torch.where(left, 2 * node + 1, 2 * node + 2)
    return torch.where(tree.is_split[node], child, node)


def leaf_of(tree: HeapTree, X: torch.Tensor, depth: int) -> torch.Tensor:
    node = torch.zeros(X.shape[0], dtype=torch.long, device=X.device)
    for _ in range(depth):
        node = route(tree, X, node)
    return node


def node_sums(node: torch.Tensor, g: torch.Tensor, h: torch.Tensor, N: int):
    """``(G, H)`` [N] float64 over the rows at each heap node."""
    G = torch.zeros(N, dtype=F64, device=g.device).index_add_(0, node, g.to(F64))
    H = torch.zeros(N, dtype=F64, device=g.device).index_add_(0, node, h.to(F64))
    return G, H


def level_hist(bins: torch.Tensor, node: torch.Tensor, d: int, g: torch.Tensor,
               h: torch.Tensor, B: int, dtype=F64) -> torch.Tensor:
    """``[K, F, B + 1, 2]`` sums of (g, h) of the rows at level ``d``'s
    ``K = 2^d`` nodes by feature and bin (bin ``B``: missing)."""
    n, F = bins.shape
    K, off, W = 1 << d, (1 << d) - 1, B + 1
    dev = bins.device
    hg = torch.zeros(K * F * W, dtype=dtype, device=dev)
    hh = torch.zeros(K * F * W, dtype=dtype, device=dev)
    fcol = torch.arange(F, device=dev)[None, :] * W
    for r0 in range(0, n, ROW_BLOCK):
        loc = node[r0:r0 + ROW_BLOCK] - off
        keep = (loc >= 0) & (loc < K)
        idx = (loc[keep][:, None] * (F * W) + fcol
               + bins[r0:r0 + ROW_BLOCK][keep].long()).reshape(-1)
        gb = g[r0:r0 + ROW_BLOCK][keep].to(dtype)[:, None].expand(-1, F)
        hb = h[r0:r0 + ROW_BLOCK][keep].to(dtype)[:, None].expand(-1, F)
        hg.index_add_(0, idx, gb.reshape(-1))
        hh.index_add_(0, idx, hb.reshape(-1))
    return torch.stack([hg, hh], dim=-1).reshape(K, F, W, 2)


def best_split(hist: torch.Tensor, G: torch.Tensor, H: torch.Tensor, p: Params):
    """``(chg, dir, feature, bin)`` [K] of each node's best split (``chg``
    ``-inf`` where none is valid); ``dir`` 1: missing goes left."""
    K, F, W, _ = hist.shape
    B = W - 1
    GL = torch.cumsum(hist[:, :, :B, 0], dim=-1)
    HL = torch.cumsum(hist[:, :, :B, 1], dim=-1)
    gm, hm = hist[:, :, B, 0], hist[:, :, B, 1]
    GLd = torch.stack([GL, GL + gm[..., None]], dim=1)  # [K, 2, F, B]
    HLd = torch.stack([HL, HL + hm[..., None]], dim=1)
    GRd = G[:, None, None, None] - GLd
    HRd = H[:, None, None, None] - HLd
    chg = (calc_gain(GLd, HLd, p) + calc_gain(GRd, HRd, p)
           - calc_gain(G, H, p)[:, None, None, None])
    valid = (HLd >= p.min_child_weight) & (HRd >= p.min_child_weight)
    score = torch.where(valid, chg, torch.full_like(chg, float("-inf"))).reshape(K, -1)
    best = torch.argmax(score, dim=1)
    FB = F * B
    return (torch.gather(score, 1, best[:, None])[:, 0], best // FB,
            (best % FB) // B, best % B)


def _route_bins(node, bins, is_split, feature, split_bin, default_left, B):
    f = feature[node]
    b = torch.gather(bins, 1, f[:, None])[:, 0].long()
    left = torch.where(b == B, default_left[node], b <= split_bin[node])
    child = torch.where(left, 2 * node + 1, 2 * node + 2)
    return torch.where(is_split[node], child, node)


def grow(bins: torch.Tensor, cut_values: torch.Tensor, g: torch.Tensor,
         h: torch.Tensor, p: Params, dtype=F64) -> HeapTree:
    """The greedy depthwise tree on ``bins`` with histograms summed in
    ``dtype``; conditions are the cut values of the winning bins."""
    n, F = bins.shape
    B = cut_values.shape[1]
    D, N = p.max_depth, heap_size(p.max_depth)
    dev = bins.device
    is_split = torch.zeros(N, dtype=torch.bool, device=dev)
    feature = torch.zeros(N, dtype=torch.long, device=dev)
    split_bin = torch.zeros(N, dtype=torch.long, device=dev)
    cond = torch.zeros(N, dtype=torch.float32, device=dev)
    default_left = torch.zeros(N, dtype=torch.bool, device=dev)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    for d in range(D):
        K, off = 1 << d, (1 << d) - 1
        hist = level_hist(bins, node, d, g, h, B, dtype)
        Gn, Hn = hist[:, 0, :, 0].sum(-1), hist[:, 0, :, 1].sum(-1)
        chg, dr, f, b = best_split(hist, Gn, Hn, p)
        s = slice(off, off + K)
        is_split[s] = (chg > RT_EPS) & (Hn > 0)
        feature[s], split_bin[s] = f, b
        cond[s] = cut_values[f, b]
        default_left[s] = dr == 1
        node = _route_bins(node, bins, is_split, feature, split_bin,
                           default_left, B)
    G, H = node_sums(node, g.to(dtype), h.to(dtype), N)
    value = (p.eta * calc_weight(G.to(dtype), H.to(dtype), p)).to(torch.float32)
    return HeapTree(is_split, feature, cond, default_left, value)


def _median(x: torch.Tensor) -> float:
    return float(x.median()) if x.numel() else 0.0


def judge(tree: HeapTree, X: torch.Tensor, bins: torch.Tensor, B: int,
          g: torch.Tensor, h: torch.Tensor, p: Params) -> Dict[str, float]:
    """How far ``tree``, grown on the gradients ``(g, h)`` of the rows
    ``X`` (binned as ``bins``), lies from the greedy tree, node by node:

    - ``gain_gap``: at each node that holds rows above the last level, the
      best loss change the reference finds less the change of the tree's
      own split there (its children's rows routed by the raw values; none
      where the tree stops although a split pays), over the larger of
      that best change and the tree's median best change;
    - ``leaf_gap``: at each node where rows end, the distance from the
      tree's value to ``eta * w`` of those rows, in units of
      ``eta * (sum |g| + |w| sum h) / (H + lambda)`` with the sums over all
      the tree's rows: the error of the leaf's gradient sums as a share of
      the round's gradient mass. Sums of float32 carry errors in
      proportion to that mass, not to the leaf's own net sum, which is
      small in later rounds and small leaves.

    ``bins`` hold ``B`` bins and the missing bin ``B``. Returns the widest
    of each."""
    D, N = p.max_depth, heap_size(p.max_depth)
    n = X.shape[0]
    dev = X.device
    node = torch.zeros(n, dtype=torch.long, device=dev)
    lost, bests = [], []
    for d in range(D):
        K, off = 1 << d, (1 << d) - 1
        hist = level_hist(bins, node, d, g, h, B, F64)
        Gn, Hn = hist[:, 0, :, 0].sum(-1), hist[:, 0, :, 1].sum(-1)
        best = best_split(hist, Gn, Hn, p)[0]
        best = torch.where(torch.isfinite(best), best, torch.zeros_like(best))
        node = route(tree, X, node)
        Gc, Hc = node_sums(node, g, h, N)
        c0 = 2 * off + 1
        GL, HL = Gc[c0:c0 + 2 * K:2], Hc[c0:c0 + 2 * K:2]
        GR, HR = Gc[c0 + 1:c0 + 2 * K:2], Hc[c0 + 1:c0 + 2 * K:2]
        chosen = calc_gain(GL, HL, p) + calc_gain(GR, HR, p) - calc_gain(Gn, Hn, p)
        split = tree.is_split[off:off + K]
        miss = torch.where(best > RT_EPS, best, torch.zeros_like(best))
        has = Hn > 0
        lost.append(torch.where(split, best - chosen, miss)[has])
        bests.append(best[has])
    lost_t, best_t = torch.cat(lost), torch.cat(bests)
    med = _median(best_t[best_t > 0])
    gain_gap = (lost_t / torch.clamp(best_t, min=med if med > 0 else 1e-300)).max()
    G, H = node_sums(node, g, h, N)
    at = H > 0
    w = calc_weight(G, H, p)
    mass = (g.to(F64).abs().sum() + w.abs() * h.to(F64).sum()) / (H + p.reg_lambda)
    leaf_gap = ((tree.value.to(F64) - p.eta * w).abs() / (p.eta * mass))[at].max()
    return {"gain_gap": float(gain_gap), "leaf_gap": float(leaf_gap)}
