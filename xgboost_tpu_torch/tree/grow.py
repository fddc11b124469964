"""Split evaluation for the depthwise grower.

The port of the JAX package's ``tree/grow.py`` split evaluation
(reference ``hist/evaluate_splits.h:61``, ``gpu_hist/evaluate_splits.cu``):
cumulative G/H over bins for both missing-direction hypotheses, the
min_child_weight and feature masks, and a first-maximum argmax of loss_chg
per node over the flattened ``[2, F, B]`` scores (missing-right first).
Categorical features (one bin per category) are scored as one category
right against the rest (one-hot) or as the best prefix of the categories
sorted by gradient ratio going right (partition); the winner's right-going
set comes back in ``SplitDecision.cat_set``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .param import SplitParams, calc_gain, calc_weight

__all__ = ["GrowParams", "SplitDecision", "seq_cumsum", "eval_splits"]


@dataclasses.dataclass(frozen=True)
class GrowParams:
    """Static hyper-parameters of the depthwise grower (no constraints, no
    sampling: those raise earlier, in the booster)."""

    max_depth: int = 6
    split: SplitParams = SplitParams()
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


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis with STRICT left-to-right f32
    association (((0+x0)+x1)+...), the order of the JAX package's
    ``seq_cumsum``. ``torch.cumsum`` accumulates f32 in double on the CPU
    and as a parallel scan on CUDA, so neither may stand in for it."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for b in range(x.shape[-1]):
        acc = acc + x[..., b]
        out[..., b] = acc
    return out


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
                cat_part: Optional[torch.Tensor] = None) -> SplitDecision:
    """``hist`` [K, F, B+1, 2] (bin B = missing) -> the best split per node.
    ``cat_feats`` / ``cat_part`` ([F] bool) mark the one-hot and the
    partition categorical features (the JAX package's ``eval_splits``
    categorical branches). A partition feature sorts its categories by
    ``g / (h + lambda)`` (stably; absent categories last) and scores every
    sorted prefix as the right-going set. Its prefix sums run in the strict
    order of ``seq_cumsum``, where the JAX package uses ``jnp.cumsum``
    (whose association depends on the backend): the card and the CPU then
    give the same bits."""
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
    sums = seq_cumsum(torch.stack(lanes))
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
    gain = calc_gain(GLd, HLd, p) + calc_gain(GRd, HRd, p)
    w_node = calc_weight(Gtot, Htot, p)
    parent_gain = calc_gain(Gtot, Htot, p)
    chg = gain - parent_gain[:, None, None, None]
    valid = (HLd >= p.min_child_weight) & (HRd >= p.min_child_weight)
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
