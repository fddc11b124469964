"""Split evaluation for the depthwise grower.

The port of the JAX package's ``tree/grow.py`` split evaluation
(reference ``hist/evaluate_splits.h:61``, ``gpu_hist/evaluate_splits.cu``):
cumulative G/H over bins for both missing-direction hypotheses, the
min_child_weight and feature masks, and a first-maximum argmax of loss_chg
per node over the flattened ``[2, F, B]`` scores (missing-right first).
Categorical features (one bin per category) are scored as one category
right against the rest (one-hot) or as the best prefix of the categories
sorted by gradient ratio going right (partition); the winner's right-going
set comes back in ``SplitDecision.cat_set``. Every prefix sum of split
evaluation is ``seq_cumsum``'s strict-order scan: kernel S
(``csrc/seq_scan.cu``, one launch a scan) on a CUDA tensor, the plain loop
on a CPU tensor.

Also the grower's samplers and constraints (the JAX package's
``tree/grow.py``): row sampling (uniform Bernoulli or minimal-variance),
exact-k column sampling per tree (a permutation, or Gumbel top-k with
feature weights), per level and per node (nested exact-k), monotone bound
propagation and interaction sets. Each sampler is a draw from
``threefry`` (the JAX package's ``jax.random`` stream) followed by a
deterministic transform, a function of its own (``select_features``,
``exact_k_from_uniform``, ``bernoulli_rows``, ``mvs_from_uniform``), so the
port draws the JAX package's samples on any device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build, threefry
from .param import SplitParams, calc_gain, calc_gain_given_weight, calc_weight

__all__ = ["GrowParams", "SplitDecision", "seq_cumsum", "eval_splits",
           "select_features", "exact_k_from_uniform", "exact_k_subset",
           "bernoulli_rows", "mvs_from_uniform", "mvs_sample",
           "apply_row_sampling", "child_bounds_and_weights",
           "interaction_allowed"]


@dataclasses.dataclass(frozen=True)
class GrowParams:
    """Static hyper-parameters of the depthwise grower."""

    max_depth: int = 6
    subsample: float = 1.0
    # "uniform" | "gradient_based" (MVS, gradient_based_sampler.cu)
    sampling_method: str = "uniform"
    colsample_bytree: float = 1.0
    colsample_bylevel: float = 1.0
    colsample_bynode: float = 1.0
    split: SplitParams = SplitParams()
    # per-feature -1/0/+1 monotone directions (empty: unconstrained)
    monotone: Tuple[int, ...] = ()
    # interaction groups of feature ids (empty: unconstrained)
    interaction: Tuple[Tuple[int, ...], ...] = ()
    # categorical feature ids with ONE-HOT splits (one category right vs
    # the rest; fewer categories than max_cat_to_onehot)
    categorical: Tuple[int, ...] = ()
    # categorical feature ids with OPTIMAL-PARTITION splits (a prefix of the
    # categories sorted by gradient ratio goes right)
    cat_partition: Tuple[int, ...] = ()

    @property
    def max_nodes(self) -> int:
        return (1 << (self.max_depth + 1)) - 1

    @property
    def has_monotone(self) -> bool:
        return any(c != 0 for c in self.monotone)

    @property
    def has_interaction(self) -> bool:
        return len(self.interaction) > 0

    @property
    def has_categorical(self) -> bool:
        return len(self.categorical) > 0 or len(self.cat_partition) > 0

    def cat_mask_np(self, n_features: int) -> np.ndarray:
        """[F] bool: categorical, one-hot or partition."""
        return self._mask(self.categorical + self.cat_partition, n_features)

    def cat_masks(self, n_features: int, device):
        """``(one-hot mask, partition mask)``, [F] bool tensors on
        ``device``, each None when it marks no feature."""
        return tuple(
            torch.as_tensor(self._mask(ids, n_features), device=device)
            if ids else None
            for ids in (self.categorical, self.cat_partition))

    @staticmethod
    def _mask(ids, n_features: int) -> np.ndarray:
        m = np.zeros(n_features, bool)
        m[[f for f in ids if f < n_features]] = True
        return m


def _seq_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: one add and one strided write a bin."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for b in range(x.shape[-1]):
        acc = acc + x[..., b]
        out[..., b] = acc
    return out


def _seq_cumsum_cuda(x: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch kernel S (``csrc/seq_scan.cu``) into ``out`` (allocated when
    None). Checks what the kernel takes and raises otherwise."""
    what = "seq_cumsum"
    _build.require_kernel_device(x, what)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() == 0:
        raise ValueError(f"{what}: the input must be a contiguous float32 "
                         f"tensor of at least one axis, not {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"{what}: the output must be a contiguous "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if x.numel() == 0:
        return out
    B = x.shape[-1]
    status = _build.library("seq_scan").xgbt_seq_scan(
        x.data_ptr(), out.data_ptr(), x.numel() // B, B,
        _build.stream_of(x.device))
    _build.check_status(status, what)
    seq_cumsum.launches += 1
    return out


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis with STRICT left-to-right f32
    association (((0+x0)+x1)+...), the order of the JAX package's
    ``seq_cumsum``. ``torch.cumsum`` accumulates f32 in double on the CPU
    and as a parallel scan on CUDA, so neither may stand in for it. Kernel
    S, one launch, on a CUDA tensor (``seq_cumsum.launches`` counts it),
    the plain loop on a CPU tensor: the same bits."""
    run = _seq_cumsum_plain if x.device.type == "cpu" else _seq_cumsum_cuda
    return run(x)


seq_cumsum.launches = 0


class SplitDecision(NamedTuple):
    """Best split per node row (all [K])."""

    loss: torch.Tensor  # loss_chg of the winner (-inf if none valid)
    dir: torch.Tensor  # 1 = missing goes left
    f: torch.Tensor
    b: torch.Tensor
    GL: torch.Tensor  # left-child stats of the winner (missing per dir)
    HL: torch.Tensor
    w_node: torch.Tensor
    # [K, B] right-going category set of the winner (all False for a
    # numerical winner); None when no feature is categorical
    cat_set: Optional[torch.Tensor] = None


def _left_stats(Gp, g_right, g_miss):
    """Left-child sums when ``g_right`` of the present total ``Gp`` goes
    right: ``[K, 2, F, B]``, missing right (dir 0) then left (dir 1)."""
    left = Gp - g_right
    return torch.stack([left, left + g_miss[..., None]], dim=1)


def eval_splits(hist: torch.Tensor, Gtot: torch.Tensor, Htot: torch.Tensor,
                p: SplitParams, node_fmask: torch.Tensor, B: int,
                cat_feats: Optional[torch.Tensor] = None,
                cat_part: Optional[torch.Tensor] = None,
                mono: Optional[torch.Tensor] = None,
                node_lo: Optional[torch.Tensor] = None,
                node_up: Optional[torch.Tensor] = None,
                scan=seq_cumsum) -> SplitDecision:
    """``hist`` [K, F, B+1, 2] (bin B = missing) -> the best split per node.
    ``cat_feats`` / ``cat_part`` ([F] bool) mark the one-hot and the
    partition categorical features (the JAX package's ``eval_splits``
    categorical branches). A partition feature sorts its categories by
    ``g / (h + lambda)`` (stably; absent categories last) and scores every
    sorted prefix as the right-going set. Its prefix sums run in the strict
    order of ``seq_cumsum``, where the JAX package uses ``jnp.cumsum``
    (whose association depends on the backend): the card and the CPU then
    give the same bits. With ``mono`` ([F] -1/0/+1) the child weights are
    clamped into the node's bounds ``node_lo`` / ``node_up`` ([K]), the
    gains taken at the clamped weights, and a split whose clamped weights
    break its feature's direction is invalid (split_evaluator.h). ``scan``
    takes the prefix sums (``seq_cumsum``, or the grow profiler's seam
    around it)."""
    K, F = hist.shape[0], hist.shape[1]
    g_b, h_b = hist[:, :, :B, 0], hist[:, :, :B, 1]
    g_miss, h_miss = hist[:, :, B, 0], hist[:, :, B, 1]
    lanes = [g_b, h_b]
    if cat_part is not None:
        present = (h_b > 0.0) | (g_b != 0.0)
        ratio = torch.where(present, g_b / (h_b + p.reg_lambda),
                            torch.full_like(g_b, float("inf")))
        order = torch.argsort(ratio, dim=-1, stable=True)  # [K, F, B]
        rank = torch.argsort(order, dim=-1)  # rank of each bin
        lanes += [torch.gather(g_b, -1, order), torch.gather(h_b, -1, order)]
    # one strict-order scan for the bins and the sorted categories
    sums = scan(torch.stack(lanes))
    GL, HL = sums[0], sums[1]
    # dir 0: missing goes right (default_left=False); dir 1: missing left
    GLd = torch.stack([GL, GL + g_miss[..., None]], dim=1)  # [K, 2, F, B]
    HLd = torch.stack([HL, HL + h_miss[..., None]], dim=1)
    Gp, Hp = GL[..., -1:], HL[..., -1:]  # present-value totals
    right_sides = []  # (features, g going right, h going right)
    if cat_feats is not None:  # one-hot: category b goes right
        right_sides.append((cat_feats, g_b, h_b))
    if cat_part is not None:  # partition: the sorted prefix goes right
        right_sides.append((cat_part, sums[2], sums[3]))
    for mask, g_right, h_right in right_sides:
        sel = mask[None, None, :, None]
        GLd = torch.where(sel, _left_stats(Gp, g_right, g_miss), GLd)
        HLd = torch.where(sel, _left_stats(Hp, h_right, h_miss), HLd)
    GRd = Gtot[:, None, None, None] - GLd
    HRd = Htot[:, None, None, None] - HLd
    if mono is not None:
        blo = node_lo[:, None, None, None]
        bup = node_up[:, None, None, None]
        wl = torch.clamp(calc_weight(GLd, HLd, p), blo, bup)
        wr = torch.clamp(calc_weight(GRd, HRd, p), blo, bup)
        gain = (calc_gain_given_weight(GLd, HLd, wl, p)
                + calc_gain_given_weight(GRd, HRd, wr, p))
        w_node = torch.clamp(calc_weight(Gtot, Htot, p), node_lo, node_up)
        parent_gain = calc_gain_given_weight(Gtot, Htot, w_node, p)
        c = mono[None, None, :, None]
        mono_ok = ~(((c > 0) & (wl > wr)) | ((c < 0) & (wl < wr)))
    else:
        gain = calc_gain(GLd, HLd, p) + calc_gain(GRd, HRd, p)
        w_node = calc_weight(Gtot, Htot, p)
        parent_gain = calc_gain(Gtot, Htot, p)
    chg = gain - parent_gain[:, None, None, None]
    valid = (HLd >= p.min_child_weight) & (HRd >= p.min_child_weight)
    if mono is not None:
        valid = valid & mono_ok
    valid = valid & node_fmask[:, None, :, None]
    score = torch.where(valid, chg, torch.full_like(chg, float("-inf")))
    flat = score.reshape(K, -1)
    best_idx = torch.argmax(flat, dim=1)  # first maximum, as jnp.argmax

    def pick(a):
        return torch.gather(a.reshape(K, -1), 1, best_idx[:, None])[:, 0]

    FB = F * B
    best_f = ((best_idx % FB) // B).to(torch.int32)
    best_b = ((best_idx % FB) % B).to(torch.int32)
    cat_set = None
    if cat_feats is not None or cat_part is not None:
        fl = best_f.long()
        cat_set = torch.zeros((K, B), dtype=torch.bool, device=hist.device)
        if cat_feats is not None:  # one-hot winner: its category
            one = torch.arange(B, device=hist.device)[None, :] == best_b[:, None]
            cat_set = torch.where(cat_feats[fl][:, None], one, cat_set)
        if cat_part is not None:  # partition winner: its sorted prefix
            rank_f = rank[torch.arange(K, device=hist.device), fl]  # [K, B]
            prefix = rank_f <= best_b[:, None]
            cat_set = torch.where(cat_part[fl][:, None], prefix, cat_set)
    return SplitDecision(
        loss=pick(score),
        dir=(best_idx // FB).to(torch.int32),
        f=best_f,
        b=best_b,
        GL=pick(GLd),
        HL=pick(HLd),
        w_node=w_node,
        cat_set=cat_set,
    )


def child_bounds_and_weights(p: SplitParams, mono_f: torch.Tensor, GLb, HLb,
                             GRb, HRb, node_lo, node_up):
    """Monotone bound propagation to the two children (split_evaluator.h):
    the clamped child weights, and the bounds tightened around their
    midpoint on the constrained side. ``mono_f`` [K] is the winning
    feature's direction. Returns ``(l_lo, l_up, r_lo, r_up, wl, wr)``."""
    wl_b = torch.clamp(calc_weight(GLb, HLb, p), node_lo, node_up)
    wr_b = torch.clamp(calc_weight(GRb, HRb, p), node_lo, node_up)
    mid = 0.5 * (wl_b + wr_b)
    l_lo = torch.where(mono_f < 0, torch.maximum(node_lo, mid), node_lo)
    l_up = torch.where(mono_f > 0, torch.minimum(node_up, mid), node_up)
    r_lo = torch.where(mono_f > 0, torch.maximum(node_lo, mid), node_lo)
    r_up = torch.where(mono_f < 0, torch.minimum(node_up, mid), node_up)
    return (l_lo, l_up, r_lo, r_up, torch.clamp(wl_b, l_lo, l_up),
            torch.clamp(wr_b, r_lo, r_up))


def interaction_allowed(used: torch.Tensor, gmask: torch.Tensor
                        ) -> torch.Tensor:
    """[K, F] allowed features from the nodes' used-feature sets ``used``
    [K, F] and the groups ``gmask`` [G, F] (constraints.cc:58 SplitImpl):
    the path's features and every group holding the whole path; all
    features at a node whose path is empty."""
    any_used = used.any(dim=1, keepdim=True)
    relevant = ~torch.any(used[:, None, :] & ~gmask[None, :, :], dim=-1)
    from_groups = torch.any(relevant[:, :, None] & gmask[None, :, :], dim=1)
    return torch.where(any_used, used | from_groups, torch.ones_like(used))


# ---- samplers: a threefry draw, then a deterministic transform ----

def n_sampled(frac: float, n: int) -> int:
    """Features kept by an exact-k sampler at fraction ``frac`` of ``n``."""
    return max(1, int(round(frac * n)))


def select_features(draw: torch.Tensor, k: int,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[F] bool: the first ``k`` of the permutation ``draw``, or with
    ``weights`` the top ``k`` of ``log(max(w, 1e-30)) + draw`` for Gumbel
    noise ``draw`` (probability-proportional without replacement; ties go
    to the lower feature id, as a stable sort)."""
    F = draw.shape[0]
    if weights is not None:
        score = torch.log(torch.clamp(weights, min=1e-30)) + draw
        top = torch.argsort(-score, stable=True)[:k]
    else:
        top = draw[:k]
    mask = torch.zeros(F, dtype=torch.bool, device=draw.device)
    mask[top] = True
    return mask


def _sample_features_exact(key: torch.Tensor, n_features: int, frac: float,
                           weights: Optional[torch.Tensor] = None,
                           device=None) -> torch.Tensor:
    """Exact-k feature subset without replacement (reference ColumnSampler,
    ``src/common/random.h:120``): a permutation, or Gumbel top-k with
    ``weights`` (MetaInfo.feature_weights), drawn on ``device`` (the
    weights' device when given)."""
    k = n_sampled(frac, n_features)
    if weights is not None:
        draw = threefry.gumbel(key, (n_features,), device=weights.device)
    else:
        draw = threefry.permutation(key, n_features, device=device)
    return select_features(draw, k, weights)


def exact_k_from_uniform(u: torch.Tensor, parent: torch.Tensor, k: int
                         ) -> torch.Tensor:
    """Exactly ``k`` features nested inside ``parent`` (last axis F): those
    whose uniform ``u`` is at least the k-th largest among ``parent``'s
    (uniforms that tie keep more than k, as in the JAX package)."""
    score = torch.where(parent, u, torch.full_like(u, float("-inf")))
    kth = torch.sort(score, dim=-1)[0][..., -k]
    return score >= kth[..., None]


def exact_k_subset(key: torch.Tensor, parent: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """The nested exact-k subset of ``parent`` under ``key`` (the
    per-level and per-node column samplers), drawn on ``parent``'s
    device."""
    u = threefry.uniform(key, tuple(parent.shape), device=parent.device)
    return exact_k_from_uniform(u, parent, k)


def bernoulli_rows(u: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                   subsample: float):
    """Uniform row sampling: rows with ``u < subsample`` (float32) keep
    their gradients, the others get zeros."""
    keep = u < float(np.float32(subsample))
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    return torch.where(keep, grad, zero), torch.where(keep, hess, zero)


def mvs_from_uniform(u_draw: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, subsample: float, reg_lambda: float):
    """Minimal-variance sampling (``gradient_based_sampler.cu``): row ``i``
    is kept with probability ``p_i = min(1, u_i / tau)``, ``u_i =
    sqrt(g_i^2 + lambda h_i^2)``, where ``tau`` makes the expected kept
    count ``subsample`` times the live rows (``u > 0``); kept rows' g and
    h are scaled by ``1 / p_i``. ``tau`` comes from the sorted suffix
    sums, taken in float64 and rounded once (the JAX package sums in
    float32, in its backend's association), so the card and the CPU find
    the same ``tau`` but for a rare last-ulp case."""
    f32 = torch.float32
    dev = grad.device
    n = grad.shape[0]
    u = torch.sqrt(grad * grad + reg_lambda * hess * hess)
    target = (u > 0.0).sum().to(f32) * float(np.float32(subsample))
    us = torch.sort(u, descending=True)[0]
    suffix = torch.flip(torch.cumsum(torch.flip(us, [0]).double(), 0),
                        [0]).to(f32)  # suffix[k] = sum us[k:]
    k_idx = torch.arange(n, dtype=f32, device=dev)
    tau_k = suffix / torch.clamp(target - k_idx, min=1e-10)
    # valid k: the first k rows (p = 1) really exceed tau
    ok = (us <= tau_k) & (k_idx < target)
    first = torch.argmax(ok.to(torch.uint8)).view(1)  # a tensor: no sync
    tau = torch.where(ok.any(), torch.gather(tau_k, 0, first)[0], us[0] + 1.0)
    p = torch.clamp(u / torch.clamp(tau, min=1e-30), 0.0, 1.0)
    keep = u_draw < p
    scale = torch.where(keep, 1.0 / torch.clamp(p, min=1e-30),
                        torch.zeros((), dtype=f32, device=dev))
    return grad * scale, hess * scale


def mvs_sample(key: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
               subsample: float, reg_lambda: float):
    """``mvs_from_uniform`` on the row uniforms of ``key``."""
    u = threefry.uniform(key, (grad.shape[0],), device=grad.device)
    return mvs_from_uniform(u, grad, hess, subsample, reg_lambda)


def apply_row_sampling(cfg: GrowParams, key: torch.Tensor,
                       grad: torch.Tensor, hess: torch.Tensor):
    """Row subsampling, uniform or gradient-based: dropped rows get zero
    gradients and keep flowing through the partition (the reference's hist
    semantics), so the level kernels see the same shapes."""
    if cfg.subsample >= 1.0:
        return grad, hess
    if cfg.sampling_method == "gradient_based":
        return mvs_sample(key, grad, hess, cfg.subsample,
                          cfg.split.reg_lambda)
    u = threefry.uniform(key, (grad.shape[0],), device=grad.device)
    return bernoulli_rows(u, grad, hess, cfg.subsample)
