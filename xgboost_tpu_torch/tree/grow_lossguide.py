"""Loss-guide (best-first) growth, ``grow_policy="lossguide"``.

The port of the JAX package's ``tree/grow_lossguide.py`` (reference: the
Driver's priority queue, ``src/tree/driver.h:30-88``, over the hist
updater's histogram and split evaluation). Split evaluation, monotone
bounds, interaction sets and the samplers are the depthwise grower's
(``tree/grow.py``).

Nodes are numbered in allocation order (root 0, each split appends its two
children), so a deep chain fits in ``2 * max_leaves - 1`` slots. Every
expansion step pops the best ``K_EXP`` candidates (1 up to 64 leaves, the
reference's one-at-a-time queue; 8 above, with ramp steps so the first
steps' short queue still builds the whole budget), partitions their rows,
histograms all ``2 * K_EXP`` children in one pass and evaluates them.

The children's histograms go through ``hist_kernel.fused_level_int`` at
``d = 0`` and ``Kp = 0`` with the row's child slot as its position (-1:
no child): kernel A on the card, the plain version on the CPU; under a
row group each rank's int64 histograms are all-reduced before they are
read. The JAX
package sums them in float32 with XLA's ``segment_sum``
(``blocked_histogram``); here they are fixed-point integers, the same bits
on every device, and missing is each child's total less its present sum
(``grow_fused.with_missing``). The step count is fixed by ``max_leaves``
and every count stays on the device: a tree grows with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import collective, threefry
from .grow import (GrowParams, _sample_features_exact, apply_row_sampling,
                   child_bounds_and_weights, eval_splits,
                   exact_k_from_uniform, interaction_allowed, n_sampled)
from .grow_fused import _constraint_consts, with_missing
from .hist_kernel import (fused_level_int, leaf_delta, level_lanes,
                          quantize_gradients)
from .param import RT_EPS, calc_weight

__all__ = ["AllocTree", "expansions_per_step", "lossguide_steps",
           "top_candidates", "grow_tree_lossguide", "finalize_alloc"]

_INF = float("inf")


class AllocTree(NamedTuple):
    """Allocation-ordered tree (all ``[M]``, ``M = 2 * max_leaves - 1``;
    ``left``/``right`` -1 at leaves and unallocated slots)."""

    left: torch.Tensor  # int32
    right: torch.Tensor  # int32
    feature: torch.Tensor  # int32
    split_bin: torch.Tensor  # int32
    split_cond: torch.Tensor  # f32
    default_left: torch.Tensor  # bool
    node_g: torch.Tensor  # f32
    node_h: torch.Tensor  # f32
    node_weight: torch.Tensor  # f32 (pre-eta)
    loss_chg: torch.Tensor  # f32
    n_nodes: torch.Tensor  # int64 scalar: slots allocated
    positions: torch.Tensor  # int32 [n]: each row's leaf (original id)
    # [M, B] right-going category set per split node ([1, 1] when no
    # feature is categorical)
    cat_set: torch.Tensor
    depth: torch.Tensor  # int32: node depths (the walk bound)


def expansions_per_step(max_leaves: int) -> int:
    """``K_EXP``: candidates popped per step (1 up to 64 leaves, else 8)."""
    return 1 if max_leaves <= 64 else 8


def lossguide_steps(max_leaves: int) -> int:
    """Expansion steps of one tree: the budget over ``K_EXP`` plus the ramp
    steps in which the queue holds fewer than ``K_EXP`` leaves."""
    k = expansions_per_step(max_leaves)
    return -(-(max_leaves - 1) // k) + max(0, (k - 1).bit_length())


def top_candidates(gain: torch.Tensor, k: int):
    """The ``k`` largest gains and their ids, equal gains lower id first
    (``jax.lax.top_k``'s order, which ``torch.topk`` does not promise on
    the card): the head of a stable descending sort."""
    vals, ids = torch.sort(gain, descending=True, stable=True)
    return vals[:k], ids[:k]


def grow_tree_lossguide(bins: torch.Tensor, grad: torch.Tensor,
                        hess: torch.Tensor, cut_values: torch.Tensor,
                        cfg: GrowParams, max_leaves: int,
                        key: Optional[torch.Tensor] = None,
                        feature_weights: Optional[torch.Tensor] = None,
                        bins_t: Optional[torch.Tensor] = None,
                        group=None) -> AllocTree:
    """Grow one best-first tree of at most ``max_leaves`` leaves on ``bins``
    [n, F] (missing == B) with gradients ``grad``/``hess`` [n]; every
    tensor on one device. ``cfg.max_depth`` 0 leaves the depth unbounded.
    ``key`` (default ``prng_key(0)``) splits into the row, tree-column and
    node keys as in the JAX package; ``feature_weights`` weight the
    per-tree column sample; ``bins_t`` is the bins' ``feature_major`` copy
    that kernel A reads on the card.

    Under a row ``group`` (``parallel.RowGroup``; the JAX package's
    ``distributed_grow_tree_lossguide``) the rows are this rank's, as in
    ``grow_tree_fused(group=)``: the gradient scale (a MAX), the root
    totals and every step's int64 child histograms (SUMs) are all-reduced
    before they are read. The queue reads only reduced numbers, so every
    rank pops the same leaves and grows the tree one process would grow on
    all the ranks' rows, bit for bit, with its own rows' positions."""
    n, F = bins.shape
    B = cut_values.shape[1]
    p = cfg.split
    M = 2 * max_leaves - 1
    dev = bins.device
    max_depth = cfg.max_depth
    k_sub, k_ctree, k_node = threefry.split(
        threefry.prng_key(0) if key is None else key, 3)
    grad, hess = apply_row_sampling(cfg, k_sub, grad, hess)
    tree_fmask = torch.ones(F, dtype=torch.bool, device=dev)
    if cfg.colsample_bytree < 1.0:
        tree_fmask = _sample_features_exact(k_ctree, F, cfg.colsample_bytree,
                                            feature_weights, device=dev)
    mono, gmask = _constraint_consts(cfg, F, dev)
    cat_feats, cat_part = cfg.cat_masks(F, dev)
    cat_any = (torch.as_tensor(cfg.cat_mask_np(F), device=dev)
               if cfg.has_categorical else None)
    gq = quantize_gradients(grad, hess, group)
    no_routing = torch.zeros((1, 4), dtype=torch.float32, device=dev)

    def child_hist(seg, Gtot, Htot):
        """[K, F, B+1, 2] of the rows at child slots ``seg`` (-1: none),
        summed over the group."""
        K = Gtot.shape[0]
        _, hq = fused_level_int(bins, seg[:, None], gq, no_routing, K=K,
                                Kp=0, B=B, d=0, bins_t=bins_t)
        hq = collective.all_reduce(hq, group, site="lossguide_hist")
        return with_missing(gq.dequantize(hq, level_lanes(K, hq.device)),
                            Gtot, Htot)

    k_tree = (n_sampled(cfg.colsample_bytree, F)
              if cfg.colsample_bytree < 1.0 else F)

    def node_masks(ids, depths, used_rows):
        """[K, F] features of a batch of nodes: the nested exact-k column
        samples (per level keyed by depth, per node by id), then the
        interaction sets."""
        fm = tree_fmask[None, :].expand(ids.shape[0], F)
        k_lvl = k_tree
        if cfg.colsample_bylevel < 1.0:
            k_lvl = n_sampled(cfg.colsample_bylevel, k_tree)
            u = threefry.uniform_rows(threefry.fold_in_many(k_node, depths), F)
            fm = exact_k_from_uniform(u, fm, k_lvl)
        if cfg.colsample_bynode < 1.0:
            keys = threefry.fold_in_many(threefry.fold_in_many(k_node, ids), 1)
            fm = exact_k_from_uniform(threefry.uniform_rows(keys, F), fm,
                                      n_sampled(cfg.colsample_bynode, k_lvl))
        if gmask is not None:
            fm = fm & interaction_allowed(used_rows, gmask)
        return fm

    def evaluate(hist, Gtot, Htot, fm, lo, up):
        return eval_splits(hist, Gtot, Htot, p, fm, B, cat_feats, cat_part,
                           mono=mono, node_lo=lo, node_up=up)

    # the state, one slot past M: writes of masked pops land there
    S = M + 1

    def full(v, dt, shape=(S,)):
        return torch.full(shape, v, dtype=dt, device=dev)

    i32, f32 = torch.int32, torch.float32
    left, right = full(-1, i32), full(-1, i32)
    feature, split_bin, depth = full(0, i32), full(0, i32), full(0, i32)
    split_cond, loss_chg = full(0.0, f32), full(0.0, f32)
    node_g, node_h, node_w = full(0.0, f32), full(0.0, f32), full(0.0, f32)
    default_left = full(False, torch.bool)
    cand_gain = full(-_INF, f32)
    cand_dir, cand_f, cand_b = full(0, i32), full(0, i32), full(0, i32)
    cand_gl, cand_hl = full(0.0, f32), full(0.0, f32)
    lo_b = full(-_INF, f32, (S if mono is not None else 1,))
    up_b = full(_INF, f32, (S if mono is not None else 1,))
    used = full(False, torch.bool, (S if gmask is not None else 1, F))
    cs_shape = (S, B) if cfg.has_categorical else (1, 1)
    cand_cat = full(False, torch.bool, cs_shape)  # best candidates' sets
    cat_set = full(False, torch.bool, cs_shape)  # committed splits' sets

    # ---- root ----
    pos = torch.zeros(n, dtype=i32, device=dev)
    tot = gq.totals(group)
    G0, H0 = tot[0:1], tot[1:2]
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    mb = mono is not None
    dec0 = evaluate(child_hist(pos, G0, H0), G0, H0,
                    node_masks(zero, zero, used[:1]),
                    lo_b[:1] if mb else None, up_b[:1] if mb else None)
    node_g[:1], node_h[:1], node_w[:1] = G0, H0, dec0.w_node
    cand_gain[:1], cand_dir[:1] = dec0.loss, dec0.dir
    cand_f[:1], cand_b[:1] = dec0.f, dec0.b
    cand_gl[:1], cand_hl[:1] = dec0.GL, dec0.HL
    if cfg.has_categorical:
        cand_cat[:1] = dec0.cat_set

    # ---- best-first expansion ----
    kk = expansions_per_step(max_leaves)
    ar = torch.arange(kk, device=dev)
    n_alloc = torch.ones((), dtype=torch.int64, device=dev)
    for _ in range(lossguide_steps(max_leaves)):
        vals, picks = top_candidates(cand_gain[:M], kk)
        remaining = (max_leaves - 1) - torch.div(n_alloc - 1, 2,
                                                 rounding_mode="floor")
        do = (vals > RT_EPS) & (ar < remaining)
        inc = 2 * do.long()
        off = torch.cumsum(inc, 0) - inc  # packed child slots
        l_id = torch.where(do, n_alloc + off, M)
        r_id = torch.where(do, n_alloc + off + 1, M)
        f, b = cand_f[picks].long(), cand_b[picks].long()
        dr = cand_dir[picks]
        GLb, HLb = cand_gl[picks], cand_hl[picks]
        GRb, HRb = node_g[picks] - GLb, node_h[picks] - HLb

        wp = torch.where(do, picks, M)
        left[wp], right[wp] = l_id.to(i32), r_id.to(i32)
        feature[wp], split_bin[wp] = f.to(i32), b.to(i32)
        split_cond[wp] = cut_values[f, b]
        default_left[wp] = dr == 1
        loss_chg[wp] = vals
        cand_gain[wp] = -_INF
        if cfg.has_categorical:
            cat_set[wp] = cand_cat[picks]

        if mb:
            l_lo, l_up, r_lo, r_up, wl_c, wr_c = child_bounds_and_weights(
                p, mono[f], GLb, HLb, GRb, HRb, lo_b[picks], up_b[picks])
        else:
            wl_c, wr_c = calc_weight(GLb, HLb, p), calc_weight(GRb, HRb, p)
        node_g[l_id], node_g[r_id] = GLb, GRb
        node_h[l_id], node_h[r_id] = HLb, HRb
        node_w[l_id], node_w[r_id] = wl_c, wr_c
        child_depth = depth[picks] + 1
        depth[l_id], depth[r_id] = child_depth, child_depth
        if mb:
            lo_b[l_id], lo_b[r_id] = l_lo, r_lo
            up_b[l_id], up_b[r_id] = l_up, r_up
        if gmask is not None:
            child_used = used[picks].clone()
            child_used[ar, f] = True
            used[l_id], used[r_id] = child_used, child_used

        # ---- partition the popped leaves' rows (leaves are disjoint: a
        # row belongs to at most one pop) ----
        slot = torch.full((S,), -1, dtype=torch.int64, device=dev)
        slot[wp] = ar
        slot[M] = -1
        j = slot[pos.long()]
        hit = j >= 0
        jc = j.clamp(min=0)
        f_of = f[jc]
        bv = torch.gather(bins, 1, f_of[:, None])[:, 0].long()
        present = bv <= b[jc]
        if cfg.has_categorical:
            # the stored category set goes RIGHT (categorical.h Decision)
            in_set = cand_cat[picks][jc, bv.clamp(max=B - 1)]
            present = torch.where(cat_any[f_of], ~in_set, present)
        goleft = torch.where(bv == B, dr[jc] == 1, present)
        pos = torch.where(hit, torch.where(goleft, l_id[jc], r_id[jc]).to(i32),
                          pos)

        # ---- all 2k children's histograms in one pass, then evaluate ----
        seg = torch.where(hit, 2 * j + (~goleft).long(), -1).to(i32)

        def ilv(a_l, a_r):  # interleave left/right per pop -> [2k]
            return torch.stack([a_l, a_r], dim=1).reshape(-1)

        G2, H2 = ilv(GLb, GRb), ilv(HLb, HRb)
        ids2 = ilv(l_id, r_id)
        depth2 = child_depth.repeat_interleave(2)
        used2 = (child_used.repeat_interleave(2, dim=0) if gmask is not None
                 else used[:1].expand(2 * kk, F))
        dec = evaluate(child_hist(seg, G2, H2), G2, H2,
                       node_masks(ids2, depth2, used2),
                       ilv(l_lo, r_lo) if mb else None,
                       ilv(l_up, r_up) if mb else None)
        bl = dec.loss
        if max_depth > 0:
            bl = torch.where(depth2 >= max_depth, -_INF, bl)
        cand_gain[ids2], cand_dir[ids2] = bl, dec.dir
        cand_f[ids2], cand_b[ids2] = dec.f, dec.b
        cand_gl[ids2], cand_hl[ids2] = dec.GL, dec.HL
        if cfg.has_categorical:
            cand_cat[ids2] = dec.cat_set
        n_alloc = n_alloc + inc.sum()

    return AllocTree(
        left=left[:M], right=right[:M], feature=feature[:M],
        split_bin=split_bin[:M], split_cond=split_cond[:M],
        default_left=default_left[:M], node_g=node_g[:M], node_h=node_h[:M],
        node_weight=node_w[:M], loss_chg=loss_chg[:M], n_nodes=n_alloc,
        positions=pos, cat_set=cat_set[:M] if cfg.has_categorical else cat_set,
        depth=depth[:M])


def finalize_alloc(alloc: AllocTree, eta: float, gamma: float):
    """Gamma pruning, each node's governing leaf value and the training
    rows' cache delta of an allocation-ordered tree, on its device with no
    host sync (the JAX package's ``finalize_alloc``). Returns ``(keep [M],
    leaf_value [M] (eta applied; 0 at kept splits), delta [n])``.

    The JAX package runs two sequential passes over the ``M`` ids. Here
    both are pointer-doubling passes over the parent links, ``log2 M``
    steps of whole-tree operations: a split is kept iff some split in its
    subtree (itself included) has ``loss_chg >= gamma`` (the fixpoint of
    bottom-up pruning, since every ancestor of a split is a split), and a
    node's value is ``eta * weight`` of its topmost ancestor-or-self that
    is not a kept split (0 where there is none, at kept splits)."""
    left, right = alloc.left.long(), alloc.right.long()
    M = left.shape[0]
    dev = left.device
    iota = torch.arange(M, device=dev)
    in_range = iota < alloc.n_nodes
    is_split = (left != -1) & in_range
    parent = torch.full((M + 1,), -1, dtype=torch.int64, device=dev)
    parent[torch.where(is_split, left, M)] = iota
    parent[torch.where(is_split, right, M)] = iota
    parent = parent[:M]
    steps = M.bit_length()  # 2^steps > M > any depth

    def jump(up):  # the ancestor twice as far up, -1 past the root
        return torch.where(up >= 0, up[up.clamp(min=0)], up)

    keep = is_split
    if gamma > 0.0:
        # OR each node's flag into its ancestors 1, 2, 4, ... levels up
        mark = is_split & (alloc.loss_chg >= gamma)
        up = parent
        for _ in range(steps):
            acc = torch.zeros(M + 1, dtype=torch.bool, device=dev)
            acc[torch.where(mark & (up >= 0), up, M)] = True
            mark = mark | acc[:M]
            up = jump(up)
        keep = is_split & mark

    # topmost governing (not kept) ancestor-or-self of every node
    top = torch.where(~keep & in_range, iota, -1)
    up = parent
    for _ in range(steps):
        far = torch.where(up >= 0, top[up.clamp(min=0)], -1)
        top = torch.where(far >= 0, far, top)
        up = jump(up)
    eta32 = torch.tensor(eta, dtype=torch.float32)
    lv = torch.where(top >= 0, alloc.node_weight[top.clamp(min=0)] * eta32,
                     torch.zeros((), dtype=torch.float32, device=dev))
    return keep, lv, leaf_delta(alloc.positions[:, None], lv)
