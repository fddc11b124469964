"""``updater="grow_local_histmaker"``: cuts sketched per node at every level.

The port of the JAX package's ``tree/grow_local.py`` (reference
``src/tree/updater_histmaker.cc:753`` CQHistMaker under
``grow_local_histmaker``). At every level each node's candidate cuts are
sketched anew from the hessian-weighted raw values of the rows in that node,
and the node is histogrammed and split against its own cuts: deep nodes keep
``max_bin`` candidates inside their narrowing value ranges.

Each level, for all features at once:

1. ``segmented_weighted_cuts``: one stable sort by (node, value), one prefix
   sum of the weights, one batched ``searchsorted`` at the per-node quantile
   targets, giving ``[F, K, B]`` cuts with the global sketch's conventions
   (B-1 interior weighted quantiles and a strict-upper sentinel);
2. ``_level_cuts_and_bins``: every row binned against its own node's cuts
   (searchsorted-right, missing to bin B), as one ``searchsorted`` over
   (node, value) keys: each node's cuts are non-decreasing, so the count
   equals the JAX package's ``#{cut <= x}`` over the row's gathered cut row,
   without its ``[n, B]`` gather per feature.

The sums round as the JAX package's do on XLA:CPU, so the cuts are its
bits with any hessians, on the card as on the CPU: the prefix sum is the
float32 ``jnp.cumsum`` association (``data/sketch.py:_cdf``); each node's
total is the float32 sum of its rows in row order (``segment_sum``'s
scatter-add), each (feature, node) added left to right by one thread of
``torch.segment_reduce`` on the device (``_segment_totals``: an
unordered atomic scatter would round otherwise); the node's
start is the ``_cdf`` of those totals, and its targets are
``start + (k * f32(1/B)) * total``, the division folded into a product
with the reciprocal and the product and sum fused into one rounding
(``_fma``), as XLA:CPU compiles them.

The level histogram is the JAX package's float ``blocked_histogram`` (XLA);
here it goes through ``hist_kernel.fused_level`` at ``d = 0``, ``Kp = 0``,
``K = 2^d`` with each row's node within the level as its position (-1: the
row sits at a leaf of an earlier level): kernel A on the card, over that
level's bins in their storage type and their feature-major copy. Its sums
are the fixed-point integers of ``quantize_gradients``, the same bits on
every device; each node's total is the integer sum of its rows, and the
missing bin is the total less the present bins (``grow_fused.with_missing``).
Split evaluation, the samplers and the constraints are the depthwise
grower's (``grow_fused._level_update``), with each node's own cut as its
split condition. Rows are routed on their per-node bins.

Numerical features only, on one device (the JAX package's scope).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import threefry
from ..data.quantile import storage_dtype
from ..data.sketch import _cdf
from .grow import GrowParams, _sample_features_exact, apply_row_sampling
from .grow_fused import GrownTree, _finalize, _init_state, _level_update
from .hist_kernel import (feature_major, fused_level, leaf_delta,
                          quantize_gradients)

__all__ = ["segmented_weighted_cuts", "grow_tree_local"]

_BIG = float(np.finfo(np.float32).max)
_HALF = 1 << 31


def _order_keys(v: torch.Tensor) -> torch.Tensor:
    """int64 keys in ``[0, 2^32)`` ordered as the float32 values ``v``
    (-0.0 as 0.0, as the JAX package's sorts take it)."""
    v = torch.where(v == 0.0, torch.zeros_like(v), v)
    bits = v.view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits.long() + _HALF


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: XLA:CPU
    contracts the JAX package's ``cstart + levels * Wseg`` into one. The
    product is exact in float64; TwoSum gives the float64 sum's rounding
    error, and rounding the sum to odd (stepping an even result one ulp
    toward the exact value) makes the float32 cast round the exact value,
    on every device."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), bits + 1, bits - 1)
    bits = torch.where((err != 0) & (bits & 1 == 0), toward, bits)
    return bits.view(torch.float64).float()


def _segment_totals(w_s: torch.Tensor, istart: torch.Tensor,
                    iend: torch.Tensor) -> torch.Tensor:
    """``[F, K]`` float32 totals of the sorted weights ``w_s`` [F, n] over
    each segment's rows ``[istart, iend)``, each added left to right in
    row order, as XLA:CPU's scatter-add computes the JAX package's
    ``segment_sum``.

    The segments tile each feature's sorted rows, and the rows after the
    last one (missing values, rows outside the level) form one more. With
    lengths per feature (``axis=1``), ``torch.segment_reduce`` gives each
    (feature, segment) to one thread that adds its rows in order from 0,
    in float32, on the card as on the CPU (only a 1-D input goes to a
    tree reduction). ``unsafe`` skips its checks of the lengths, which
    would read them back to the host."""
    F, n = w_s.shape
    lengths = torch.cat([iend - istart, n - iend[:, -1:]], dim=1)
    tot = torch.segment_reduce(w_s, "sum", lengths=lengths, axis=1,
                               unsafe=True)
    return tot[:, :-1] + 0.0  # -0.0 as 0.0, as segment_sum's totals


def segmented_weighted_cuts(col: torch.Tensor, weight: torch.Tensor,
                            seg: torch.Tensor, K: int, B: int
                            ) -> torch.Tensor:
    """Weighted quantile cuts per segment: ``col`` [n] -> ``[K, B]``, or
    ``[F, n]`` columns -> ``[F, K, B]``: for each of K segments, B-1 interior
    weighted quantiles and the strict-upper sentinel (the JAX package's
    ``segmented_weighted_cuts``). Row ``i`` belongs to segment ``seg[i]``;
    rows with ``seg`` outside ``[0, K)`` and missing values are left out. A
    segment with no rows gets zeros and the sentinel 1."""
    one = col.dim() == 1
    cols = (col[None] if one else col).contiguous()
    F, n = cols.shape
    dev = cols.device
    nan = torch.isnan(cols)
    outside = ((seg < 0) | (seg >= K))[None]
    s = torch.where(nan | outside, K, seg.long()[None])  # K: left out
    v = torch.where(nan, torch.full_like(cols, _BIG), cols)
    w = torch.where(s == K, torch.zeros_like(cols),
                    weight.to(torch.float32)[None])
    # by (segment, value), ties in row order (jnp.lexsort is stable)
    s_key, order = torch.sort((s << 32) + _order_keys(v), dim=1, stable=True)
    s_s = s_key >> 32
    v_s = torch.gather(v, 1, order)
    w_s = torch.gather(w, 1, order)
    c = _cdf(w_s).contiguous()
    ks = torch.arange(K, device=dev)[None].expand(F, K).contiguous()
    istart = torch.searchsorted(s_s, ks)
    iend = torch.searchsorted(s_s, ks, right=True)
    has = iend > istart
    w_seg = _segment_totals(w_s, istart, iend)
    c_lo = torch.cat([w_seg.new_zeros((F, 1)), _cdf(w_seg)[:, :-1]], dim=1)
    levels = torch.arange(1, B, dtype=torch.float32, device=dev) * \
        torch.tensor(1.0 / B, dtype=torch.float32, device=dev)
    tgt = _fma(levels, w_seg[..., None], c_lo[..., None])  # [F, K, B-1]
    idx = torch.searchsorted(c, tgt.reshape(F, -1)).reshape(F, K, B - 1)
    lo = istart[..., None]
    idx = torch.minimum(torch.maximum(idx, lo),
                        torch.maximum(iend - 1, istart)[..., None])
    interior = torch.gather(v_s, 1, idx.clamp(0, n - 1).reshape(F, -1)
                            ).reshape(F, K, B - 1)
    vmax = torch.gather(v_s, 1, (iend - 1).clamp(0, n - 1))
    vmax = torch.where(has, vmax, torch.zeros_like(vmax))
    sentinel = vmax + torch.clamp(vmax.abs(), min=1.0)
    interior = torch.where(has[..., None], interior,
                           torch.zeros_like(interior))
    cuts = torch.cat([interior, sentinel[..., None]], dim=-1)
    return cuts[0] if one else cuts


def _level_cuts_and_bins(X: torch.Tensor, hess: torch.Tensor,
                         seg: torch.Tensor, K: int, B: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every feature's per-node cuts ``[K, F, B]`` and every row's bins
    ``[n, F]`` int32 against its own node's cuts (rows outside the level
    against node 0's; missing to bin B)."""
    n, F = X.shape
    Xt = X.t().contiguous()
    cuts = segmented_weighted_cuts(Xt, hess, seg, K, B)  # [F, K, B]
    segc = seg.long().clamp(0, K - 1)
    node_keys = (torch.arange(K, device=X.device)[None, :, None] << 32) \
        + _order_keys(cuts)
    row_keys = (segc[None] << 32) + _order_keys(Xt)
    b = torch.searchsorted(node_keys.reshape(F, K * B), row_keys, right=True)
    b = (b - segc[None] * B).clamp(0, B - 1)
    b = torch.where(torch.isnan(Xt), torch.full_like(b, B), b)
    return cuts.permute(1, 0, 2), b.t().to(torch.int32)


def grow_tree_local(X: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                    cfg: GrowParams, max_bin: int, eta: float, gamma: float,
                    key: Optional[torch.Tensor] = None,
                    feature_weights: Optional[torch.Tensor] = None
                    ) -> GrownTree:
    """Grow one depthwise tree on the raw values ``X`` [n, F] float32 (NaN
    missing) with gradients ``grad``/``hess`` [n], every tensor on one
    device, cutting each node at ``max_bin`` quantiles of its own rows.
    ``key`` (default ``prng_key(0)``) splits into the row, tree-column and
    level keys; ``feature_weights`` weight the per-tree column sample. The
    tree comes back as heap arrays with gamma pruning, leaf values and the
    rows' cache delta, as ``grow_fused.grow_tree_fused`` gives them."""
    if cfg.has_categorical:
        raise NotImplementedError(
            "grow_local_histmaker supports numerical features only "
            "(the reference's local maker predates categorical support)")
    n, F = X.shape
    B = max_bin
    dev = X.device
    k_sub, k_ctree, k_level = threefry.split(
        threefry.prng_key(0) if key is None else key, 3)
    grad, hess = apply_row_sampling(cfg, k_sub, grad, hess)
    tree_mask = None
    if cfg.colsample_bytree < 1.0:
        tree_mask = _sample_features_exact(k_ctree, F, cfg.colsample_bytree,
                                           feature_weights, device=dev)
    gq = quantize_gradients(grad, hess)
    q = gq.q.long()
    st = _init_state(cfg, gq.totals(), 0, F)
    pos = torch.zeros(n, dtype=torch.long, device=dev)
    no_routing = torch.zeros((1, 4), dtype=torch.float32, device=dev)
    lanes = torch.arange(2, device=dev)[None, :]
    # the JAX package draws the node column samples at the widest level
    width = 1 << max(cfg.max_depth - 1, 0)
    for d in range(cfg.max_depth):
        K = 1 << d
        off = K - 1
        local = pos - off
        at_level = (local >= 0) & (local < K)
        seg = torch.where(at_level, local, torch.full_like(local, -1))
        cuts, bins = _level_cuts_and_bins(X, hess, seg, K, B)
        bins_s = bins.to(storage_dtype(B))
        _, histC = fused_level(
            bins_s, seg[:, None].to(torch.int32), gq, no_routing, K=K, Kp=0,
            B=B, d=0,
            bins_t=None if dev.type == "cpu" else feature_major(bins_s))
        totals = torch.zeros((K + 1, 2), dtype=torch.int64, device=dev)
        totals.index_add_(0, torch.where(at_level, seg, K), q)
        totals = gq.dequantize(totals[:K], lanes)
        st.node_g[off:off + K] = totals[:, 0]
        st.node_h[off:off + K] = totals[:, 1]
        st = _level_update(st, histC, cuts, cfg, d, tree_mask, k_level,
                           node_rows=width)
        # route on the per-node bins: bin <= split bin goes left
        bv = torch.gather(bins, 1, st.feature[pos].long()[:, None])[:, 0]
        goleft = torch.where(bv == B, st.default_left[pos],
                             bv <= st.split_bin[pos])
        pos = torch.where(st.is_split[pos],
                          torch.where(goleft, 2 * pos + 1, 2 * pos + 2), pos)
    keep, leaf_value = _finalize(st, eta, gamma, cfg)
    return GrownTree(
        keep=keep, feature=st.feature, split_bin=st.split_bin,
        split_cond=st.split_cond, default_left=st.default_left,
        node_g=st.node_g, node_h=st.node_h, node_weight=st.node_w,
        loss_chg=st.loss_chg, leaf_value=leaf_value,
        delta=leaf_delta(pos[:, None], leaf_value), cat_set=st.cat_set)
