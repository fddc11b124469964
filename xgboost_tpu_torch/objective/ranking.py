"""LambdaMART ranking objectives: ``rank:pairwise``, ``rank:ndcg`` and
``rank:map`` (the port of the JAX package's ``objective/ranking.py``;
reference ``src/objective/rank_obj.cu``).

Two regimes, as in the JAX package. While ``G * S^2`` (groups times the
square of the largest group) stays within ``_ALL_PAIRS_BUDGET``, every group
is padded to ``S`` rows and all pairs are weighed at once in batched
``[G, S, S]`` tensors (``_lambda_grad``). Above it every row draws
``lambdarank_num_pair_per_sample`` opponents uniformly from its own group
with the JAX package's key and draw (``threefry``, bitwise ``jax.random``),
and ranks and ideal DCGs come from global sorts (``_lambda_grad_sampled``).

The card and the CPU must compute the same gradient bits, so that they grow
the same trees. Every term is formed in float64 and the gradients are
rounded to float32 once. Sorts are stable, so tied margins (every margin is
the base score in round 0) keep row order, as ``jnp.argsort`` and
``jnp.lexsort`` do. No reduction is left to a library's order: sums run as
pairwise trees (``_tree_sum``) and segmented prefix sums as Hillis-Steele
steps (``base.seg_scan``), each step one elementwise add whose order the code
fixes; the sampled path's scatter of the opponent ends sorts the terms by
destination row and sums each row's run the same way. Against the JAX
package's float32 the gradients differ by float32 rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import threefry
from ..data.dmatrix import QueryGroups
from .base import ObjFunction, div, param, register, seg_scan, segment_sum

__all__ = ["RankPairwise", "RankNDCG", "RankMAP"]

#: all pairs only while G * S^2 stays within this many elements; above it
#: the sampled pairs keep memory O(n * num_pair) (the JAX package's bound)
_ALL_PAIRS_BUDGET = 1 << 25

F64 = torch.float64


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a pairwise tree: zero-padded to a power of
    two, then halved by elementwise adds (the same bits on every device)."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _inverse(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return inv


def _map_pair_delta(at, hits, acc1, acc2, acc3, a, b, lab_a, lab_b, total):
    """|delta AP| of swapping the docs at sorted positions ``a <= b``
    (rank_obj.cu:436 GetLambdaMAP), shared by both paths; ``at(arr, idx)``
    gathers a position of the caller's layout, 0 for ``idx == -1``."""
    original = at(acc1, b) - at(acc1, a - 1)
    up = at(acc3, b - 1) - at(acc3, a) + (at(hits, a) + 1.0) / (a + 1.0)
    down = at(acc2, b - 1) - at(acc2, a) + at(hits, b) / (b + 1.0)
    changed = torch.where(lab_a < lab_b, up, down)
    delta = torch.abs(changed - original) / torch.clamp(total, min=1.0)
    keep = (lab_a != lab_b) & (a != b) & (total > 0)
    return torch.where(keep, delta, torch.zeros_like(delta))


def _map_stats(rel_sorted: torch.Tensor, local: torch.Tensor,
               seg_start: torch.Tensor, max_len: int):
    """MAPStats prefix scans over a prediction-sorted layout (rank_obj.cu:474
    GetMAPStats): hits and the three AP accumulators, inclusive, per
    segment; ``local`` is each position's 0-based rank in its segment."""
    hits = seg_scan(rel_sorted, seg_start, max_len)  # exact integers
    p1 = local.to(F64) + 1.0
    terms = torch.stack([rel_sorted * hits / p1,
                         rel_sorted * (hits - 1.0) / p1,
                         rel_sorted * (hits + 1.0) / p1])
    acc1, acc2, acc3 = seg_scan(terms, seg_start, max_len)
    return hits, acc1, acc2, acc3


def _lambda_grad(margin: torch.Tensor, label: torch.Tensor,
                 groups: QueryGroups, scheme: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs lambdas in float64 over the padded ``[G, S, S]`` layout
    (the JAX package's ``_lambda_grad``): each unordered pair of different
    labels weighed by the reference sampler's expectation
    ``1/n_opp(i) + 1/n_opp(j)``."""
    dev = margin.device
    G, S = groups.n_groups, groups.max_size
    group_of, start, _ = groups.rows()
    flat = group_of * S + torch.arange(margin.shape[0], device=dev) - start

    def pad(x, fill):
        out = torch.full((G * S,), fill, dtype=x.dtype, device=dev)
        out[flat] = x
        return out.reshape(G, S)

    m = pad(margin.to(F64), 0.0)
    y = pad(label.to(F64), 0.0)
    v = pad(torch.ones_like(margin, dtype=torch.bool), False)
    vv = v[:, :, None] & v[:, None, :]
    pair = (y[:, :, None] - y[:, None, :] > 0) & vv
    rho = torch.sigmoid(-(m[:, :, None] - m[:, None, :]))
    same = ((y[:, :, None] == y[:, None, :]) & vv).to(F64)
    opp = torch.clamp(v.to(F64).sum(1, keepdim=True) - same.sum(2), min=1.0)
    end_w = torch.where(v, 1.0 / opp, torch.zeros_like(opp))
    samp_w = end_w[:, :, None] + end_w[:, None, :]
    zero = torch.zeros((), dtype=F64, device=dev)
    if scheme in ("ndcg", "map"):
        key = torch.where(v, m, torch.full_like(m, -float("inf")))
        order = torch.argsort(-key, dim=1, stable=True)
        ranks = torch.empty_like(order).scatter_(
            1, order, torch.arange(S, device=dev).expand(G, S).contiguous())
    if scheme == "ndcg":
        gains = torch.pow(2.0, y) - 1.0
        disc = 1.0 / torch.log2(ranks.to(F64) + 2.0)
        ideal = torch.sort(torch.where(v, gains, zero), dim=1,
                           descending=True).values
        idcg = _tree_sum(ideal / torch.log2(
            torch.arange(S, dtype=F64, device=dev) + 2.0))
        idcg = torch.clamp(idcg, min=1e-10)[:, None, None]
        delta = (torch.abs(gains[:, :, None] - gains[:, None, :])
                 * torch.abs(disc[:, :, None] - disc[:, None, :]) / idcg)
        w_pair = torch.where(pair, delta, zero)
    elif scheme == "map":
        rel = ((y > 0) & v).to(F64)
        rel_sorted = torch.zeros_like(rel).scatter_(1, ranks, rel)
        local = torch.arange(S, device=dev).expand(G, S)
        hits, acc1, acc2, acc3 = _map_stats(
            rel_sorted, local, torch.zeros(S, dtype=torch.long, device=dev),
            S)
        total = hits[:, -1][:, None, None]

        def at(arr, idx):  # per-group gather; idx == -1 -> 0
            got = arr.gather(1, idx.clamp(0, S - 1).reshape(G, -1))
            got = got.reshape(idx.shape)
            return torch.where(idx >= 0, got, torch.zeros_like(got))

        ri, rj = ranks[:, :, None], ranks[:, None, :]
        a, b = torch.minimum(ri, rj), torch.maximum(ri, rj)
        rel_i, rel_j = rel[:, :, None], rel[:, None, :]
        lab_a = torch.where(ri <= rj, rel_i, rel_j)
        lab_b = torch.where(ri <= rj, rel_j, rel_i)
        delta = _map_pair_delta(at, hits, acc1, acc2, acc3, a, b, lab_a,
                                lab_b, total)
        w_pair = torch.where(pair, delta, zero)
    else:
        w_pair = pair.to(F64)
    w_pair = w_pair * samp_w
    lam = rho * w_pair  # pushes i above j
    # per pair end 2 * w * p * (1 - p) (rank_obj.cu:142)
    hessian = 2.0 * rho * (1.0 - rho) * w_pair
    grad = -_tree_sum(lam) + _tree_sum(lam.transpose(1, 2))
    hess = _tree_sum(hessian) + _tree_sum(hessian.transpose(1, 2))
    hess = torch.clamp(hess, min=1e-16)
    return grad.reshape(-1)[flat], hess.reshape(-1)[flat]


def _lambda_grad_sampled(margin: torch.Tensor, label: torch.Tensor,
                         groups: QueryGroups, key: torch.Tensor, n_pair: int,
                         scheme: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampled-pair lambdas in float64 without padding (the JAX package's
    ``_lambda_grad_sampled``): ranks and ideal DCGs from sorts keyed
    (group, -margin) and (group, -label); ``n_pair`` opponents per row,
    uniform in its group; both ends of every pair take its lambda."""
    n = margin.shape[0]
    dev = margin.device
    group_of, start, size = groups.rows()
    S = groups.max_size
    m, y = margin.to(F64), label.to(F64)
    order = groups.argsort(-m)
    rank = _inverse(order) - start  # 0-based rank inside the own group
    gains = torch.pow(2.0, y) - 1.0
    disc = 1.0 / torch.log2(rank.to(F64) + 2.0)
    last = start + size - 1  # each row's group's last row
    if scheme == "ndcg":
        lrank = _inverse(groups.argsort(-y)) - start
        ideal = seg_scan(gains / torch.log2(lrank.to(F64) + 2.0), start, S)
        idcg = torch.clamp(ideal[last], min=1e-10)

    # opponents: uniform in the own group, n_pair draws per row; the index
    # is formed in float32, as jnp computes it
    u = threefry.uniform(key, (n, n_pair), device=dev)
    j_local = torch.minimum((u * size[:, None].to(torch.float32)).long(),
                            size[:, None] - 1)
    j = start[:, None] + j_local
    m_j, y_j = m[j], y[j]
    valid = y[:, None] != y_j

    # per row, the different-label rows of its group (the reference
    # sampler's expectation weights 1/n_opp(i) + 1/n_opp(j)): run lengths
    # of equal (group, label)
    lorder = groups.argsort(y)
    gs, ys = group_of[lorder], y[lorder]
    new_run = torch.ones(n, dtype=torch.bool, device=dev)
    new_run[1:] = (gs[1:] != gs[:-1]) | (ys[1:] != ys[:-1])
    run_id = torch.cumsum(new_run.long(), 0) - 1
    run_cnt = torch.bincount(run_id, minlength=n)
    same_cnt = torch.empty(n, dtype=torch.long, device=dev)
    same_cnt[lorder] = run_cnt[run_id]
    opp = torch.clamp((size - same_cnt).to(F64), min=1.0)
    end_w = 1.0 / opp
    # each unordered pair is hit from both ends about n_pair/size times
    samp_w = div(size.to(F64)[:, None] * (end_w[:, None] + end_w[j]),
                 2.0 * n_pair)

    i_is_hi = y[:, None] > y_j
    s_hi = torch.where(i_is_hi, m[:, None], m_j)
    s_lo = torch.where(i_is_hi, m_j, m[:, None])
    rho = torch.sigmoid(-(s_hi - s_lo))
    zero = torch.zeros((), dtype=F64, device=dev)
    if scheme == "ndcg":
        delta = (torch.abs(gains[:, None] - gains[j])
                 * torch.abs(disc[:, None] - disc[j]) / idcg[:, None])
        w_pair = torch.where(valid, delta, zero)
    elif scheme == "map":
        # the same MAPStats scans over the one prediction sort: groups are
        # contiguous blocks at the same positions in sorted order
        rel = (y > 0).to(F64)
        local = torch.arange(n, device=dev) - start
        hits, acc1, acc2, acc3 = _map_stats(rel[order], local, start, S)
        total = hits[last]
        st = start[:, None]

        def at(arr, idx):  # sorted-layout gather of a group-local index
            got = arr[torch.clamp(st + torch.clamp(idx, min=0), 0, n - 1)]
            return torch.where(idx >= 0, got, torch.zeros_like(got))

        r_i, r_j = rank[:, None], rank[j]
        a, b = torch.minimum(r_i, r_j), torch.maximum(r_i, r_j)
        rel_i, rel_j = rel[:, None], rel[j]
        lab_a = torch.where(r_i <= r_j, rel_i, rel_j)
        lab_b = torch.where(r_i <= r_j, rel_j, rel_i)
        delta = _map_pair_delta(at, hits, acc1, acc2, acc3, a, b, lab_a,
                                lab_b, total[:, None])
        w_pair = torch.where(valid, delta, zero)
    else:
        w_pair = valid.to(F64)
    w_pair = w_pair * samp_w
    lam = rho * w_pair  # pushes hi up, lo down
    hes = torch.clamp(2.0 * rho * (1.0 - rho), min=1e-16) * w_pair
    sign = torch.where(i_is_hi, -1.0, 1.0).to(F64)  # hi gets -lambda

    # both ends of every pair, summed per destination row in a fixed
    # order: the row's own pairs, then the pairs that drew it, by row
    own = torch.arange(n, device=dev).repeat_interleave(n_pair)
    dest = torch.cat([own, j.reshape(-1)])
    vals = torch.stack([torch.cat([(sign * lam).reshape(-1),
                                   (-sign * lam).reshape(-1)]),
                        torch.cat([hes.reshape(-1), hes.reshape(-1)])])
    grad, hess = segment_sum(vals, dest, n)
    return grad, torch.clamp(hess, min=1e-16)


class _LambdaRankBase(ObjFunction):
    scheme = "pairwise"

    def get_gradient(self, margin, label, weight, iteration=0, *,
                     groups: Optional[QueryGroups] = None, **kw):
        """LambdaMART gradients of ``margin`` [n] within ``groups`` (one
        group of every row when None). Weights are one per group, scaled
        by ``n_groups / sum(w)`` (reference
        ComputeWeightNormalizationFactor), or one per row."""
        n = margin.shape[0]
        if groups is None:
            groups = QueryGroups(np.array([0, n]), margin.device)
        groups.check_rows(n)
        G, S = groups.n_groups, groups.max_size
        if G * S * S > _ALL_PAIRS_BUDGET:
            n_pair = max(1, int(param(
                self.params, "lambdarank_num_pair_per_sample", 1)))
            key = threefry.prng_key(iteration * 2654435761 & 0x7FFFFFFF)
            grad, hess = _lambda_grad_sampled(margin, label, groups, key,
                                              n_pair, self.scheme)
        else:
            grad, hess = _lambda_grad(margin, label, groups, self.scheme)
        grad, hess = grad.to(torch.float32), hess.to(torch.float32)
        if weight is not None and weight.numel() == G:
            w = weight.cpu().numpy().astype(np.float64)
            norm = G / max(float(w.sum()), 1e-30)
            w_group = torch.as_tensor((w * norm).astype(np.float32),
                                      device=margin.device)
            w_row = w_group[groups.rows()[0]]
            grad, hess = grad * w_row, hess * w_row
        elif weight is not None and weight.numel() == n:
            grad, hess = grad * weight, hess * weight
        return grad, hess

    def default_metric(self) -> str:
        return "ndcg" if self.scheme == "ndcg" else "map"


@register("rank:pairwise")
class RankPairwise(_LambdaRankBase):
    scheme = "pairwise"


@register("rank:ndcg")
class RankNDCG(_LambdaRankBase):
    scheme = "ndcg"


@register("rank:map")
class RankMAP(_LambdaRankBase):
    scheme = "map"
