"""Depthwise ``tpu_hist`` grower: one fused level kernel per level.

The port of the unrolled level loop of the JAX package's
``tree/grow_fused.py`` (reference ``src/tree/updater_gpu_hist.cu``
UpdateTree, :667). Each level runs ``fused_level`` (partition + histogram,
kernel A on the card) and then ``_level_update`` (split evaluation and the
next decision table); after the loop, the final ``partition_apply``,
``_finalize`` (gamma pruning, leaf values) and ``leaf_delta`` (the
prediction-cache increment). The tree comes back as heap-layout arrays
(children of ``i`` at ``2i+1`` / ``2i+2``) on the device; nothing is copied
to the host during a round.

Rows are not padded: the CUDA kernels mask the ragged edge themselves
(the JAX package pads to a 1024-row tile), so ``delta`` covers exactly the
n training rows. Gradients are quantised once per tree (``quantize_gradients``); the root
totals come from the same integers as every histogram, so a node's total
and the sum of its bins agree exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .grow import GrowParams, eval_splits, seq_cumsum
from .hist_kernel import (QuantizedGradients, fused_level, leaf_delta,
                          partition_apply, quantize_gradients)
from .param import RT_EPS, calc_weight

__all__ = ["GrownTree", "grow_tree_fused"]


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
    ptab: torch.Tensor  # [K, 4] decisions of the last evaluated level


def _init_state(cfg: GrowParams, totals: torch.Tensor) -> _HeapState:
    max_nodes = cfg.max_nodes
    dev = totals.device

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
        ptab=torch.zeros((1, 4), dtype=torch.float32, device=dev),
    )


def _level_update(st: _HeapState, histC: torch.Tensor,
                  cut_values: torch.Tensor, cfg: GrowParams, d: int
                  ) -> _HeapState:
    """Evaluate level ``d``'s splits from its histogram ``histC``
    [F, 2K, B] (missing excluded) and write the heap arrays and the next
    partition table."""
    F, B = cut_values.shape
    p = cfg.split
    max_nodes = cfg.max_nodes
    K = 1 << d
    off = K - 1
    dev = histC.device
    Gtot = st.node_g[off:off + K]
    Htot = st.node_h[off:off + K]
    hg = histC[:, :K, :].permute(1, 0, 2)  # [K, F, B]
    hh = histC[:, K:, :].permute(1, 0, 2)
    # present-value totals in the strict left-to-right association
    cum = seq_cumsum(torch.stack([hg, hh]))[..., -1]
    g_miss = Gtot[:, None] - cum[0]
    h_miss = Htot[:, None] - cum[1]
    hist = torch.stack([
        torch.cat([hg, g_miss[..., None]], dim=-1),
        torch.cat([hh, h_miss[..., None]], dim=-1),
    ], dim=-1)  # [K, F, B+1, 2]
    node_fmask = torch.ones((K, F), dtype=torch.bool, device=dev)
    dec = eval_splits(hist, Gtot, Htot, p, node_fmask, B)
    can_split = (dec.loss > RT_EPS) & (Htot > 0.0)
    GLb, HLb = dec.GL, dec.HL
    GRb, HRb = Gtot - GLb, Htot - HLb
    fl, bl = dec.f.long(), dec.b.long()
    cond = cut_values[fl, bl]

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

    wl_c = calc_weight(GLb, HLb, p)
    wr_c = calc_weight(GRb, HRb, p)
    # children of nodes that do not split go to a dropped slot (max_nodes)
    lidx = torch.where(can_split, 2 * slots + 1, torch.full_like(slots, max_nodes))
    ridx = torch.where(can_split, 2 * slots + 2, torch.full_like(slots, max_nodes))

    def set_children(base, left_vals, right_vals):
        ext = torch.cat([base, base.new_zeros(1)])
        ext[lidx] = left_vals
        ext[ridx] = right_vals
        return ext[:max_nodes]

    ptab = torch.stack([
        can_split.to(torch.float32), dec.f.to(torch.float32),
        dec.b.to(torch.float32), (dec.dir == 1).to(torch.float32),
    ], dim=1)  # [K, 4]
    return _HeapState(
        is_split=is_split, feature=feature, split_bin=split_bin,
        split_cond=split_cond, default_left=default_left,
        node_g=set_children(st.node_g, GLb, GRb),
        node_h=set_children(st.node_h, HLb, HRb),
        node_w=set_children(node_w, wl_c, wr_c),
        loss_chg=loss_chg, ptab=ptab,
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
                    gamma: float, cfg: GrowParams) -> GrownTree:
    """Grow one depthwise tree on ``bins`` [n, F] (missing == B) with
    gradients ``grad``/``hess`` [n]; every tensor on one device."""
    B = cut_values.shape[1]
    max_depth = cfg.max_depth
    gq: QuantizedGradients = quantize_gradients(grad, hess)
    st = _init_state(cfg, gq.totals())
    pos = torch.zeros((bins.shape[0], 1), dtype=torch.int32, device=bins.device)
    for d in range(max_depth):
        K = 1 << d
        pos, histC = fused_level(bins, pos, gq, st.ptab, K=K, Kp=K >> 1, B=B,
                                 d=d)
        st = _level_update(st, histC, cut_values, cfg, d)
    # route rows through the last level's splits to their leaves
    if max_depth > 0:
        pos = partition_apply(bins, pos, st.ptab, Kp=1 << (max_depth - 1),
                              B=B, d=max_depth)
    keep, leaf_value = _finalize(st, eta, gamma, cfg)
    return GrownTree(
        keep=keep, feature=st.feature, split_bin=st.split_bin,
        split_cond=st.split_cond, default_left=st.default_left,
        node_g=st.node_g, node_h=st.node_h, node_weight=st.node_w,
        loss_chg=st.loss_chg, leaf_value=leaf_value,
        delta=leaf_delta(pos, leaf_value),
    )
