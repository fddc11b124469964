"""Distributed tree growth: each rank grows on its own rows.

The port of the JAX package's ``parallel/grow.py`` (reference: the
inter-node data-parallel strategy, ``SyncHistogramDistributed``
``hist/histogram.h:201``). Each rank holds a row shard and the model is
replicated; the only synchronisation in the hot loop is the per-level
histogram all-reduce inside ``grow_tree_fused`` (with the gradient scale
and the root totals). Every reduction is an exact integer sum or a
maximum, so the trees come back identical on every rank, bit for bit the
tree one process grows on all the rows, with no tree broadcast; each
rank's ``delta`` covers its own rows. Histogram size does not depend on
the rows, so the collective's cost stays fixed as the data grows.

The JAX package's ``distributed_grow_tree`` serves only its heap grower,
which the port never had; ``distributed_grow_tree_lossguide`` is not
ported yet. The JAX package's ``distributed_boost_rounds_scan`` runs
rounds as one ``lax.scan`` program; ``distributed_boost_rounds`` is its
per-round loop.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import threefry
from ..tree.grow import GrowParams
from ..tree.grow_fused import GrownTree, grow_tree_fused

__all__ = ["distributed_grow_tree_fused", "distributed_boost_rounds"]


def distributed_grow_tree_fused(mesh, bins: torch.Tensor, grad: torch.Tensor,
                                hess: torch.Tensor, cut_values: torch.Tensor,
                                eta: float, gamma: float, cfg: GrowParams,
                                key: Optional[torch.Tensor] = None,
                                feature_weights: Optional[torch.Tensor] = None,
                                onehot: Optional[torch.Tensor] = None,
                                bins_t: Optional[torch.Tensor] = None
                                ) -> GrownTree:
    """``grow_tree_fused`` over this rank's rows ``bins`` [n_rank, F] with
    their gradients, the histograms reduced over ``mesh`` (a
    ``parallel.RowGroup``). ``cut_values``, ``key`` and
    ``feature_weights`` must be the same on every rank; ``onehot`` is this
    rank's resident one-hot, built to the plan agreed over the group
    (``BinnedMatrix.fused_onehot(group)``), or None for the construct
    route over ``bins_t``."""
    if cfg.has_categorical:
        raise NotImplementedError(
            "categorical training under a mesh is not supported yet (the "
            "distributed sketch's categorical identity-cut path is "
            "untested); train single-device or drop feature_types")
    return grow_tree_fused(bins, grad, hess, cut_values, eta, gamma, cfg,
                           onehot=onehot, bins_t=bins_t, key=key,
                           feature_weights=feature_weights, group=mesh)


def distributed_boost_rounds(mesh, obj, binned, label: torch.Tensor,
                             weight: Optional[torch.Tensor],
                             margin: torch.Tensor, start_iteration: int,
                             num_rounds: int, eta: float, gamma: float,
                             cfg: GrowParams, seed: int = 0,
                             feature_weights: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, List[GrownTree]]:
    """``num_rounds`` rounds from ``start_iteration`` over this rank's rows
    (``binned``, ``label``, ``weight`` and ``margin`` [n_rank, K]): each
    round the objective's gradients, one tree per output group (tree ``k``
    of round ``i`` under ``prng_key(round_seed_py(seed, i, k))``, the
    Booster's key) and the margin update. Returns the new margin and the
    trees, round-major."""
    from ..gbm.gbtree import round_seed_py

    onehot = binned.fused_onehot(mesh)
    bins_t = (binned.feature_major() if onehot is None
              and binned.bins.device.type != "cpu" else None)
    margin = margin.clone()
    K = margin.shape[1]
    trees: List[GrownTree] = []
    for i in range(start_iteration, start_iteration + num_rounds):
        grad, hess = obj.get_gradient(margin[:, 0] if K == 1 else margin,
                                      label, weight, i)
        for k in range(K):
            t = distributed_grow_tree_fused(
                mesh, binned.bins, grad[:, k] if grad.dim() == 2 else grad,
                hess[:, k] if hess.dim() == 2 else hess, binned.cut_values,
                eta, gamma, cfg, key=threefry.prng_key(round_seed_py(seed, i, k)),
                feature_weights=feature_weights, onehot=onehot, bins_t=bins_t)
            margin[:, k] += t.delta
            trees.append(t)
    return margin, trees
