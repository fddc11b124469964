"""Depthwise ``tpu_hist`` grower: one fused level kernel per level.

The port of the unrolled level loop of the JAX package's
``tree/grow_fused.py`` (reference ``src/tree/updater_gpu_hist.cu``
UpdateTree, :667). Each level runs ``fused_level`` (partition + histogram,
kernel A on the card) and then ``_level_update`` (split evaluation and the
next decision table); after the loop, the final ``partition_apply``,
``_finalize`` (gamma pruning, leaf values) and ``leaf_delta`` (the
prediction-cache increment). The tree comes back as heap-layout arrays
(children of ``i`` at ``2i+1`` / ``2i+2``) on the device; nothing is copied
to the host during a round. Each op of the loop, and each sub-op of
``_level_update``, goes through one step seam, chosen once per tree: a
direct call; with the trace on, a ``step/<op>`` span; on a sampled round
the per-level profiler's bracket (``observability/kernelprof.py``), which
adds only syncs and clock reads.

Rows are not padded: the CUDA kernels mask the ragged edge themselves
(the JAX package pads to a 1024-row tile), so ``delta`` covers exactly the
n training rows. Gradients are quantised once per tree (``quantize_gradients``); the root
totals come from the same integers as every histogram, so a node's total
and the sum of its bins agree exactly.

Sampling and constraints follow the JAX package: the tree's key splits
into the row, tree-column and level keys; row sampling zeroes or rescales
the float gradients before they are quantised; the column masks (per tree,
per level, per node) and the interaction sets act only in split
evaluation; monotone bounds ride along in the heap state. The level
kernels see the same shapes with or without them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import collective, threefry
from ..observability import trace as _trace
from .grow import (GrowParams, _sample_features_exact, apply_row_sampling,
                   child_bounds_and_weights, eval_splits, exact_k_subset,
                   interaction_allowed, n_sampled, seq_cumsum)
from .hist_kernel import (QuantizedGradients, feature_major, fused_level,
                          fused_level_int, leaf_delta, level_lanes,
                          partition_apply, quantize_gradients)
from .param import RT_EPS, calc_weight

__all__ = ["GrownTree", "grow_tree_fused", "grow_tree_fused_paged",
           "with_missing"]


class GrownTree(NamedTuple):
    """Heap-layout tree (all [max_nodes]) + the round's cache delta [n]."""

    keep: torch.Tensor  # bool — is_split after gamma pruning
    feature: torch.Tensor  # int32
    split_bin: torch.Tensor  # int32
    split_cond: torch.Tensor  # f32
    default_left: torch.Tensor  # bool
    node_g: torch.Tensor  # f32
    node_h: torch.Tensor  # f32
    node_weight: torch.Tensor  # f32 (pre-eta)
    loss_chg: torch.Tensor  # f32
    leaf_value: torch.Tensor  # f32 — eta-applied governing leaf value per node
    delta: torch.Tensor  # f32 [n] margin increment of the training rows
    cat_set: torch.Tensor  # bool [max_nodes, B] right-going sets ([1, 1]
    # when no feature is categorical)


class _HeapState(NamedTuple):
    """Per-tree heap arrays threaded through the level loop."""

    is_split: torch.Tensor
    feature: torch.Tensor
    split_bin: torch.Tensor
    split_cond: torch.Tensor
    default_left: torch.Tensor
    node_g: torch.Tensor
    node_h: torch.Tensor
    node_w: torch.Tensor
    loss_chg: torch.Tensor
    lo_b: torch.Tensor  # [max_nodes] monotone weight bounds, [1] without
    up_b: torch.Tensor
    used: torch.Tensor  # [max_nodes, F] path features, [1, F] without
    # [K, 4] decisions of the last evaluated level, [K, 5+B] with
    # categorical features (column 4: categorical node; 5 on: its
    # right-going set)
    ptab: torch.Tensor
    cat_set: torch.Tensor  # [max_nodes, B] right-going sets, or [1, 1]


@functools.lru_cache(maxsize=16)
def _constraint_consts(cfg: GrowParams, F: int, device: torch.device):
    """``(mono [F] int32, groups [G, F] bool)`` on ``device``, each None
    when its constraint is unset; made once per configuration (a copy to
    the card synchronizes its stream) and only read after."""
    mono = gmask = None
    if cfg.has_monotone:
        m = np.zeros(F, np.int32)
        m[:len(cfg.monotone)] = cfg.monotone[:F]
        mono = torch.as_tensor(m, device=device)
    if cfg.has_interaction:
        g = np.zeros((len(cfg.interaction), F), bool)
        for gi, grp in enumerate(cfg.interaction):
            g[gi, [f for f in grp if f < F]] = True
        gmask = torch.as_tensor(g, device=device)
    return mono, gmask


def _init_state(cfg: GrowParams, totals: torch.Tensor, B: int = 0,
                F: int = 0) -> _HeapState:
    max_nodes = cfg.max_nodes
    dev = totals.device
    cat = cfg.has_categorical

    def z(dt):
        return torch.zeros(max_nodes, dtype=dt, device=dev)

    G0, H0 = totals[0], totals[1]
    node_g, node_h, node_w = z(torch.float32), z(torch.float32), z(torch.float32)
    node_g[0] = G0
    node_h[0] = H0
    node_w[0] = calc_weight(G0, H0, cfg.split)
    return _HeapState(
        is_split=z(torch.bool), feature=z(torch.int32),
        split_bin=z(torch.int32), split_cond=z(torch.float32),
        default_left=z(torch.bool), node_g=node_g, node_h=node_h,
        node_w=node_w, loss_chg=z(torch.float32),
        lo_b=torch.full((max_nodes if cfg.has_monotone else 1,),
                        float("-inf"), device=dev),
        up_b=torch.full((max_nodes if cfg.has_monotone else 1,),
                        float("inf"), device=dev),
        used=torch.zeros((max_nodes if cfg.has_interaction else 1, F),
                         dtype=torch.bool, device=dev),
        ptab=torch.zeros((1, 5 + B if cat else 4), dtype=torch.float32,
                         device=dev),
        cat_set=torch.zeros((max_nodes, B) if cat else (1, 1),
                            dtype=torch.bool, device=dev),
    )


def with_missing(histC: torch.Tensor, Gtot: torch.Tensor,
                 Htot: torch.Tensor, scan=seq_cumsum) -> torch.Tensor:
    """``fused_level``'s ``[F, 2K, B]`` histogram (missing excluded) and the
    nodes' totals ``[K]`` -> ``eval_splits``' ``[K, F, B+1, 2]``, bin B the
    missing values: each node's total less its present sum, taken in the
    strict left-to-right association (``seq_cumsum``, or ``scan``: the
    grow profiler's seam around it)."""
    K = Gtot.shape[0]
    hg = histC[:, :K, :].permute(1, 0, 2)  # [K, F, B]
    hh = histC[:, K:, :].permute(1, 0, 2)
    cum = scan(torch.stack([hg, hh]))[..., -1]
    g_miss = Gtot[:, None] - cum[0]
    h_miss = Htot[:, None] - cum[1]
    return torch.stack([
        torch.cat([hg, g_miss[..., None]], dim=-1),
        torch.cat([hh, h_miss[..., None]], dim=-1),
    ], dim=-1)


def _direct(op: str, depth: int, fn, *args, **kwargs):
    """The step seam of an unprofiled, untraced tree: the call itself."""
    return fn(*args, **kwargs)


def _level_update(st: _HeapState, histC: torch.Tensor,
                  cut_values: torch.Tensor, cfg: GrowParams, d: int,
                  tree_mask: Optional[torch.Tensor] = None,
                  k_level: Optional[torch.Tensor] = None,
                  node_rows: Optional[int] = None,
                  sub=_direct) -> _HeapState:
    """Evaluate level ``d``'s splits from its histogram ``histC``
    [F, 2K, B] (missing excluded) and write the heap arrays and the next
    partition table. ``cut_values`` is [F, B], or [K, F, B] with each
    node's own cuts (``grow_local``). ``tree_mask`` ([F] bool, default all)
    is the tree's column sample; the level's and the nodes' samples are
    drawn under ``fold_in(k_level, d)`` and ``fold_in(fold_in(k_level, d),
    1)`` when ``colsample_bylevel`` / ``colsample_bynode`` are below 1, the
    nodes' as ``node_rows`` rows (default K) of which the first K are
    used. Its three sub-ops, ``level_update/with_missing``,
    ``level_update/eval_splits`` and ``level_update/heap_write``, and each
    strict-order scan inside the first two (``level_update/scan``) go
    through the seam ``sub``, as the level loop's ops go through ``step``
    (``observability/kernelprof.py``)."""
    F, B = cut_values.shape[-2:]
    K = 1 << d
    off = K - 1
    Gtot = st.node_g[off:off + K]
    Htot = st.node_h[off:off + K]
    scan = (seq_cumsum if sub is _direct
            else functools.partial(sub, "level_update/scan", d, seq_cumsum))
    hist = sub("level_update/with_missing", d, with_missing, histC, Gtot,
               Htot, scan=scan)
    mono, gmask = _constraint_consts(cfg, F, histC.device)
    dec = sub("level_update/eval_splits", d, _split_decisions, st, hist,
              Gtot, Htot, cfg, d, B, mono, gmask, tree_mask, k_level,
              node_rows, scan)
    return sub("level_update/heap_write", d, _heap_write, st, dec, Gtot,
               Htot, cut_values, cfg, d, mono, gmask)


def _split_decisions(st: _HeapState, hist: torch.Tensor, Gtot, Htot,
                     cfg: GrowParams, d: int, B: int, mono, gmask,
                     tree_mask, k_level, node_rows, scan):
    """The level's column masks, then ``eval_splits``: each node's best
    split."""
    F = hist.shape[1]
    K = 1 << d
    off = K - 1
    dev = hist.device
    node_lo = node_up = None
    if mono is not None:
        node_lo, node_up = st.lo_b[off:off + K], st.up_b[off:off + K]
    fmask = (torch.ones(F, dtype=torch.bool, device=dev) if tree_mask is None
             else tree_mask)
    k_tree = (n_sampled(cfg.colsample_bytree, F)
              if cfg.colsample_bytree < 1.0 else F)
    k_lvl = k_tree
    if cfg.colsample_bylevel < 1.0:
        k_lvl = n_sampled(cfg.colsample_bylevel, k_tree)
        fmask = exact_k_subset(threefry.fold_in(k_level, d), fmask, k_lvl)
    node_fmask = fmask[None, :].expand(K, F)
    if cfg.colsample_bynode < 1.0:
        kn = threefry.fold_in(threefry.fold_in(k_level, d), 1)
        node_fmask = exact_k_subset(
            kn, fmask[None, :].expand(node_rows or K, F),
            n_sampled(cfg.colsample_bynode, k_lvl))[:K]
    if gmask is not None:
        node_fmask = node_fmask & interaction_allowed(st.used[off:off + K],
                                                      gmask)
    cat_feats, cat_part = cfg.cat_masks(F, dev)
    return eval_splits(hist, Gtot, Htot, cfg.split, node_fmask, B, cat_feats,
                       cat_part, mono=mono, node_lo=node_lo, node_up=node_up,
                       scan=scan)


def _heap_write(st: _HeapState, dec, Gtot, Htot,
                cut_values: torch.Tensor, cfg: GrowParams, d: int, mono,
                gmask) -> _HeapState:
    """Write level ``d``'s decisions ``dec`` into the heap arrays (the
    clones, the scatters and the children's slots) and the next partition
    table."""
    F = cut_values.shape[-2]
    p = cfg.split
    max_nodes = cfg.max_nodes
    K = 1 << d
    off = K - 1
    dev = Gtot.device
    can_split = (dec.loss > RT_EPS) & (Htot > 0.0)
    GLb, HLb = dec.GL, dec.HL
    GRb, HRb = Gtot - GLb, Htot - HLb
    fl, bl = dec.f.long(), dec.b.long()
    cond = (cut_values[fl, bl] if cut_values.dim() == 2
            else cut_values[torch.arange(K, device=dev), fl, bl])

    slots = off + torch.arange(K, device=dev)
    is_split = st.is_split.clone()
    is_split[slots] = can_split
    feature = st.feature.clone()
    feature[slots] = dec.f
    split_bin = st.split_bin.clone()
    split_bin[slots] = dec.b
    split_cond = st.split_cond.clone()
    split_cond[slots] = cond
    default_left = st.default_left.clone()
    default_left[slots] = dec.dir == 1
    loss_chg = st.loss_chg.clone()
    loss_chg[slots] = torch.where(can_split, dec.loss, torch.zeros_like(dec.loss))
    node_w = st.node_w.clone()
    node_w[slots] = dec.w_node

    if mono is not None:
        l_lo, l_up, r_lo, r_up, wl_c, wr_c = child_bounds_and_weights(
            p, mono[fl], GLb, HLb, GRb, HRb, st.lo_b[off:off + K],
            st.up_b[off:off + K])
    else:
        wl_c = calc_weight(GLb, HLb, p)
        wr_c = calc_weight(GRb, HRb, p)
    # children of nodes that do not split go to a dropped slot (max_nodes)
    lidx = torch.where(can_split, 2 * slots + 1, torch.full_like(slots, max_nodes))
    ridx = torch.where(can_split, 2 * slots + 2, torch.full_like(slots, max_nodes))

    def set_children(base, left_vals, right_vals):
        ext = torch.cat([base, base.new_zeros((1,) + base.shape[1:])])
        ext[lidx] = left_vals
        ext[ridx] = right_vals
        return ext[:max_nodes]

    ptab = torch.stack([
        can_split.to(torch.float32), dec.f.to(torch.float32),
        dec.b.to(torch.float32), (dec.dir == 1).to(torch.float32),
    ], dim=1)  # [K, 4]
    lo_b, up_b, used = st.lo_b, st.up_b, st.used
    if mono is not None:
        lo_b = set_children(lo_b, l_lo, r_lo)
        up_b = set_children(up_b, l_up, r_up)
    if gmask is not None:
        child_used = used[off:off + K].clone()
        child_used[torch.arange(K, device=dev), fl] = True
        used = set_children(used, child_used, child_used)
    cat_set = st.cat_set
    if cfg.has_categorical:
        any_cat = torch.as_tensor(cfg.cat_mask_np(F), device=dev)
        is_cat = any_cat[fl] & can_split
        win_set = dec.cat_set & is_cat[:, None]  # [K, B]
        cat_set = cat_set.clone()
        cat_set[slots] = win_set
        ptab = torch.cat([ptab, is_cat.to(torch.float32)[:, None],
                          win_set.to(torch.float32)], dim=1)  # [K, 5+B]
    return _HeapState(
        is_split=is_split, feature=feature, split_bin=split_bin,
        split_cond=split_cond, default_left=default_left,
        node_g=set_children(st.node_g, GLb, GRb),
        node_h=set_children(st.node_h, HLb, HRb),
        node_w=set_children(node_w, wl_c, wr_c),
        loss_chg=loss_chg, lo_b=lo_b, up_b=up_b, used=used, ptab=ptab,
        cat_set=cat_set,
    )


def _finalize(st: _HeapState, eta: float, gamma: float, cfg: GrowParams):
    """Gamma pruning (bottom-up, updater_prune.cc) + governing leaf value
    per heap node."""
    max_depth = cfg.max_depth
    dev = st.is_split.device
    keep = st.is_split.clone()
    child_keep = torch.zeros(1 << max_depth, dtype=torch.bool, device=dev)
    for d in range(max_depth - 1, -1, -1):
        w = 1 << d
        off = w - 1
        isl = st.is_split[off:off + w]
        lcl = st.loss_chg[off:off + w]
        child_any = child_keep[0::2] | child_keep[1::2]
        keep_l = isl & ((lcl >= gamma) | child_any)
        keep[off:off + w] = keep_l
        child_keep = keep_l

    leaf_value = torch.zeros(cfg.max_nodes, dtype=torch.float32, device=dev)
    eta_t = torch.tensor(eta, dtype=torch.float32, device=dev)
    root_open = keep[0:1]
    gov = torch.where(root_open, torch.zeros(1, device=dev), eta_t * st.node_w[0:1])
    gov_open = root_open
    leaf_value[0:1] = gov
    for d in range(1, max_depth + 1):
        w = 1 << d
        off = w - 1
        parent_gov = torch.repeat_interleave(gov, 2)
        parent_open = torch.repeat_interleave(gov_open, 2)
        own_w = st.node_w[off:off + w]
        if d < max_depth:
            node_keep = keep[off:off + w]
        else:
            node_keep = torch.zeros(w, dtype=torch.bool, device=dev)
        gov = torch.where(parent_open,
                          torch.where(node_keep, torch.zeros_like(own_w),
                                      eta_t * own_w),
                          parent_gov)
        gov_open = parent_open & node_keep
        leaf_value[off:off + w] = gov
    return keep, leaf_value


def grow_tree_fused(bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, cut_values: torch.Tensor, eta: float,
                    gamma: float, cfg: GrowParams,
                    onehot: Optional[torch.Tensor] = None,
                    bins_t: Optional[torch.Tensor] = None,
                    key: Optional[torch.Tensor] = None,
                    feature_weights: Optional[torch.Tensor] = None,
                    group=None) -> GrownTree:
    """Grow one depthwise tree on ``bins`` [n, F] (missing == B) with
    gradients ``grad``/``hess`` [n]; every tensor on one device. ``onehot``
    (``build_onehot`` of ``bins``) sends every level down the hoisted route;
    the trees are the same either way. Without one, kernel A reads
    ``bins_t``, the bins' ``feature_major`` copy, when given. With
    categorical features in ``cfg`` the decision tables are ``[K, 5+B]``
    and the grown tree carries each node's right-going set. ``key`` (a
    ``threefry`` key, default ``prng_key(0)``) seeds the row and column
    samples; ``feature_weights`` ([F], on the bins' device) weight the
    per-tree column sample.

    Under a row ``group`` (``parallel.RowGroup``; the JAX package's
    ``axis_name``) the rows are this rank's: the gradient scale (a MAX), the
    root totals and every level's int64 histogram (SUMs) are all-reduced
    over the group before they are read, so every rank evaluates the same
    splits from the same numbers and grows the tree one process would grow
    on all the ranks' rows, bit for bit, with its own rows' ``delta``. Row
    samples are drawn per rank under the same key, as the JAX package's
    shards draw them.

    Untraced, every op is the call itself (``_direct``); traced, each op
    of the level loop and of ``_level_update`` also records a ``step/<op>``
    span (``kernelprof._spanned``: two clock reads, no sync)."""
    if not _trace.enabled():
        return _grow_tree_fused(bins, grad, hess, cut_values, eta, gamma, cfg,
                                onehot, bins_t, key, feature_weights, group)
    from ..observability import kernelprof

    step = kernelprof._spanned()
    with _trace.span("grow_tree", fused=True, depth=cfg.max_depth,
                     features=int(bins.shape[1])):
        return _grow_tree_fused(bins, grad, hess, cut_values, eta, gamma, cfg,
                                onehot, bins_t, key, feature_weights, group,
                                step=step, sub=step)


class _Prep(NamedTuple):
    """What a tree's level loop starts from."""

    gq: QuantizedGradients
    tree_mask: Optional[torch.Tensor]  # [F] bool, None: every feature
    k_level: torch.Tensor
    st: _HeapState


def _prep(bins, grad, hess, key, feature_weights, cfg: GrowParams, B: int,
          group) -> _Prep:
    """Split the tree's key, sample rows and the tree's columns, quantise
    the gradients and set up the root."""
    F = bins.shape[1]
    k_sub, k_ctree, k_level = threefry.split(
        threefry.prng_key(0) if key is None else key, 3)
    grad, hess = apply_row_sampling(cfg, k_sub, grad, hess)
    tree_mask = None
    if cfg.colsample_bytree < 1.0:
        tree_mask = _sample_features_exact(k_ctree, F, cfg.colsample_bytree,
                                           feature_weights,
                                           device=bins.device)
    gq = quantize_gradients(grad, hess, group)
    return _Prep(gq, tree_mask, k_level,
                 _init_state(cfg, gq.totals(group), B, F))


def _level_hist(bins, pos, gq: QuantizedGradients, ptab, B: int, d: int,
                onehot, bins_t, group):
    """Level ``d``'s routing and float histogram ``[F, 2K, B]``: kernel D
    or A, the group's SUM of the int64 cells, then the scale."""
    K = 1 << d
    pos, hq = fused_level_int(bins, pos, gq, ptab, K=K, Kp=K >> 1, B=B, d=d,
                              onehot=onehot, bins_t=bins_t)
    hq = collective.all_reduce(hq, group, site="level_hist")
    return pos, gq.dequantize(hq, level_lanes(K, hq.device))


def _grow_tree_fused(bins, grad, hess, cut_values, eta, gamma, cfg, onehot,
                     bins_t, key, feature_weights, group,
                     step=_direct, sub=_direct) -> GrownTree:
    """The level loop. Each op goes through ``step(op, depth, fn, *args)``,
    the seam where a sampled round's profiler brackets it
    (``observability/kernelprof.py``), and ``_level_update``'s sub-ops
    through ``sub``; unprofiled and untraced, both are the call."""
    B = cut_values.shape[1]
    max_depth = cfg.max_depth
    gq, tree_mask, k_level, st = step("prep", -1, _prep, bins, grad, hess,
                                      key, feature_weights, cfg, B, group)
    pos = torch.zeros((bins.shape[0], 1), dtype=torch.int32, device=bins.device)
    for d in range(max_depth):
        pos, histC = step("level_hist", d, _level_hist, bins, pos, gq,
                          st.ptab, B, d, onehot, bins_t, group)
        st = step("level_update", d, _level_update, st, histC, cut_values,
                  cfg, d, tree_mask, k_level, sub=sub)
    # route rows through the last level's splits to their leaves
    if max_depth > 0:
        pos = step("level_partition", max_depth, partition_apply, bins, pos,
                   st.ptab, Kp=1 << (max_depth - 1), B=B, d=max_depth)
    keep, leaf_value = step("finalize", max_depth, _finalize, st, eta, gamma,
                            cfg)
    delta = step("leaf_delta", max_depth, leaf_delta, pos, leaf_value)
    return GrownTree(
        keep=keep, feature=st.feature, split_bin=st.split_bin,
        split_cond=st.split_cond, default_left=st.default_left,
        node_g=st.node_g, node_h=st.node_h, node_weight=st.node_w,
        loss_chg=st.loss_chg, leaf_value=leaf_value, delta=delta,
        cat_set=st.cat_set,
    )


def grow_tree_fused_paged(paged, grad: torch.Tensor, hess: torch.Tensor,
                          cut_values: torch.Tensor, eta: float, gamma: float,
                          cfg: GrowParams, key: Optional[torch.Tensor] = None,
                          feature_weights: Optional[torch.Tensor] = None
                          ) -> GrownTree:
    """``grow_tree_fused`` over a disk-paged matrix (``data/external.py``
    ``PagedBins``; the JAX package's ``grow_tree_fused_paged``,
    ``tree/grow_fused.py:602``): every level reads every page, runs
    ``fused_level`` on it (kernel A on the card: a page has no resident
    one-hot) with the page's own positions, and sums the pages' int64
    histograms before one ``_level_update``; after the loop each page is
    routed to its leaves and the pages' deltas are concatenated.
    ``grad``/``hess`` ([n]) and ``cut_values`` are on the device the pages
    are read to. Each page samples its rows under ``fold_in(k_sub, k)``,
    as in the JAX package; the gradients of all n rows are then quantised
    once, so every page's cells share one scale and, without row sampling,
    the tree is the in-memory tree of the same bins, bit for bit. The
    next page is read in the background while a page is on the device.
    Categorical features raise NotImplementedError."""
    with _trace.span("grow_tree_paged", depth=cfg.max_depth,
                     pages=paged.n_pages):
        return _grow_tree_fused_paged(paged, grad, hess, cut_values, eta,
                                      gamma, cfg, key, feature_weights)


def _grow_tree_fused_paged(paged, grad, hess, cut_values, eta, gamma, cfg,
                           key, feature_weights) -> GrownTree:
    if cfg.has_categorical:
        raise NotImplementedError(
            "external-memory matrices support numerical training only "
            "(reference external memory has the same restriction)")
    dev = grad.device
    B = cut_values.shape[1]
    F, P = paged.n_features, paged.n_pages
    max_depth = cfg.max_depth
    k_sub, k_ctree, k_level = threefry.split(
        threefry.prng_key(0) if key is None else key, 3)
    lo = [k * paged.page_rows for k in range(P)]
    rows = [paged.rows_of(k) for k in range(P)]
    if cfg.subsample < 1.0:
        parts = [apply_row_sampling(cfg, threefry.fold_in(k_sub, k),
                                    grad[lo[k]:lo[k] + rows[k]],
                                    hess[lo[k]:lo[k] + rows[k]])
                 for k in range(P)]
        grad = torch.cat([g for g, _ in parts])
        hess = torch.cat([h for _, h in parts])
    tree_mask = None
    if cfg.colsample_bytree < 1.0:
        tree_mask = _sample_features_exact(k_ctree, F, cfg.colsample_bytree,
                                           feature_weights, device=dev)
    gq = quantize_gradients(grad, hess)
    gq_pages = [QuantizedGradients(q=gq.q[lo[k]:lo[k] + rows[k]], exp=gq.exp)
                for k in range(P)]
    st = _init_state(cfg, gq.totals(), B, F)
    pos = [torch.zeros((rows[k], 1), dtype=torch.int32, device=dev)
           for k in range(P)]

    def page(k):
        bins = paged.device_page(k, dev)
        # the next reader is page k + 1, or page 0 of the next level, of
        # the final pass or of the next tree
        paged.start_prefetch(k + 1 if k + 1 < P else 0)
        return bins

    for d in range(max_depth):
        K = 1 << d
        hist = None
        for k in range(P):
            bins = page(k)
            pos[k], hq = fused_level_int(
                bins, pos[k], gq_pages[k], st.ptab, K=K, Kp=K >> 1, B=B, d=d,
                bins_t=None if dev.type == "cpu" else feature_major(bins))
            hist = hq if hist is None else hist + hq
        histC = gq.dequantize(hist, level_lanes(K, dev))
        st = _level_update(st, histC, cut_values, cfg, d, tree_mask, k_level)
    keep, leaf_value = _finalize(st, eta, gamma, cfg)
    deltas = []
    for k in range(P):
        if max_depth > 0:
            pos[k] = partition_apply(page(k), pos[k], st.ptab,
                                     Kp=1 << (max_depth - 1), B=B,
                                     d=max_depth)
        deltas.append(leaf_delta(pos[k], leaf_value))
    return GrownTree(
        keep=keep, feature=st.feature, split_bin=st.split_bin,
        split_cond=st.split_cond, default_left=st.default_left,
        node_g=st.node_g, node_h=st.node_h, node_weight=st.node_w,
        loss_chg=st.loss_chg, leaf_value=leaf_value,
        delta=torch.cat(deltas), cat_set=st.cat_set,
    )
