"""Graded rows in queries: the label is a row's grade by its rank inside
its query.

Per row, ``features`` standard normal values and a score
``score_weight * (x . w) + noise * e`` with ``w`` and ``e`` standard
normal (``w`` one draw a seed); for grouped data, a per-query offset of
each feature (standard normal times ``query_offset``). The label is the
grade of the row's rank inside its query by score against the cumulative
shares ``grades``. Then a ``missing`` share of the values is set to NaN.

Query sizes do not depend on the seed: ``queries`` sizes spread evenly
over ``query_size`` = [lo, hi] and nudged by one to sum to ``rows``
(``traffic.query_sizes``), shuffled by the seed. So every seed does the
same work in another order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from portbench.traffic import Data, Split, query_sizes


def _split(gen, device, w, data: dict, rows: int,
           sizes: Optional[np.ndarray]) -> Split:
    F = int(data["features"])
    X = torch.randn((rows, F), generator=gen, device=device)
    score = (float(data.get("score_weight", 1.0)) * (X * w).sum(dim=1)
             + float(data.get("noise", 0.0))
             * torch.randn(rows, generator=gen, device=device))
    sz = torch.as_tensor(sizes, device=device)
    sz = sz[torch.randperm(len(sizes), generator=gen, device=device)]
    G = sz.shape[0]
    group_of = torch.repeat_interleave(torch.arange(G, device=device), sz)
    off = float(data.get("query_offset", 0.0))
    if off:
        X += off * torch.randn((G, F), generator=gen, device=device)[group_of]
    miss = float(data.get("missing", 0.0))
    if miss > 0:
        X[torch.rand((rows, F), generator=gen, device=device) < miss] = float("nan")
    start = (torch.cumsum(sz, 0) - sz)[group_of]
    o = torch.argsort(score, stable=True)
    o = o[torch.argsort(group_of[o], stable=True)]
    local = torch.empty_like(o)
    local[o] = torch.arange(rows, device=device) - start[o]
    share = local.to(torch.float64) / sz[group_of].to(torch.float64)
    grades = torch.tensor(data["grades"], dtype=torch.float64, device=device)
    y = torch.searchsorted(grades, share, right=True).to(torch.float32)
    return Split(X.cpu().numpy(), y.cpu().numpy(), sz.cpu().numpy())


def make(config: dict, workload: dict, seed: int, device) -> Data:
    data = config["data"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    w = torch.randn(int(data["features"]), generator=gen, device=device)
    parts = []
    for rows_key, q_key in (("rows", "queries"), ("eval_rows", "eval_queries")):
        rows = int(workload[rows_key])
        lo, hi = workload["query_size"]
        sizes = query_sizes(int(workload[q_key]), rows, int(lo), int(hi))
        parts.append(_split(gen, device, w, data, rows, sizes))
    return Data(*parts)
