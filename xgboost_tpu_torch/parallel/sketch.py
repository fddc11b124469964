"""Distributed quantile sketch: per-rank summaries, gathered and merged.

The port of the JAX package's ``parallel/sketch.py`` (reference
``HostSketchContainer::AllReduce``, quantile.cc:270). Each rank compresses
its rows into ``S = OVERSAMPLE * max_bin`` weighted points per feature
(``data/sketch.py:local_summary``); the ``[F, S]`` values and weights and
the ``[F]`` maxima and minima are gathered in rank order into ``[W, F,
S]`` over the row group's gloo group, and every rank merges the same stack
(``merge_summaries``). Rank 0's cuts then go to every rank, so the
replication does not rest on the merge alone (the JAX package's rank-0
psum-broadcast). The JAX package summarises per device: a world of W
ranks matches its mesh of W devices holding the same shards.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import collective
from ..data.quantile import HistogramCuts
from ..data.sketch import local_summary, merge_summaries

__all__ = ["distributed_compute_cuts"]


def distributed_compute_cuts(mesh, X: torch.Tensor, max_bin: int = 256,
                             weights: Optional[torch.Tensor] = None
                             ) -> HistogramCuts:
    """This rank's rows ``X`` [n_rank, F] float32 (NaN missing) and their
    weights (None: unit) -> the cuts of every rank's rows, the same on
    every rank of ``mesh``."""
    parts = local_summary(X, weights, max_bin)
    stacked = [torch.as_tensor(collective.process_allgather(
        p.cpu().numpy(), site="sketch", mesh=mesh), device=X.device)
        for p in parts]
    cuts, mins = merge_summaries(*stacked, max_bin)
    both = np.concatenate([cuts.cpu().numpy(), mins.cpu().numpy()[:, None]],
                          axis=1)
    both = collective.process_allgather(both, site="sketch_cuts",
                                        mesh=mesh)[0]
    return HistogramCuts(values=both[:, :-1], min_vals=both[:, -1])
