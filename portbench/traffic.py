"""The one generator of the benchmark's data, driven by a configuration's
``data`` block and a workload's sizes.

Rows are drawn on the device from ``--seed`` with a ``torch.Generator``,
in a few large calls, then handed to the program as host numpy arrays,
as users pass them. Two rules:

- ``"label": "make_classification"``: scikit-learn's ``make_classification``
  with two classes and only informative features (the reference's
  ``tests/benchmark/benchmark_tree.py``): ``2 * clusters_per_class``
  clusters, each at a vertex of the hypercube of side ``2 * class_sep``
  (its bits drawn at random; distinct but with probability 2**-47), its
  rows standard normal times a matrix of its own (uniform in [-1, 1])
  plus the vertex, its label the cluster's index mod 2; then a
  ``flip_y`` share of the labels drawn anew, and the rows shuffled. The
  clusters are one draw a seed, shared by the training and held-out rows;
  each split gives every cluster the same number of rows (the remainder
  to the first), as the source does.
- otherwise, per row, ``features`` standard normal values and a score
  ``score_weight * (x . w) + noise * e`` with ``w`` and ``e`` standard
  normal (``w`` one draw a seed); for grouped data, a per-query offset of
  each feature (standard normal times ``query_offset``). The label is the
  grade of the row's rank inside its query by score against the
  cumulative shares ``grades`` (``"label": "grades"``).

Then a ``missing`` share of the values is set to NaN.

Query sizes do not depend on the seed: ``queries`` sizes spread evenly
over ``query_size`` = [lo, hi] and nudged by one to sum to ``rows``,
shuffled by the seed. So every seed does the same work in another order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Split:
    X: np.ndarray  # [n, F] float32, NaN missing
    y: np.ndarray  # [n] float32
    sizes: Optional[np.ndarray]  # [G] int64 query sizes, or None


@dataclasses.dataclass
class Data:
    train: Split
    valid: Split


def query_sizes(queries: int, rows: int, lo: int, hi: int) -> np.ndarray:
    """``queries`` sizes in [lo, hi] summing to ``rows``, evenly spread."""
    s = lo + (np.arange(queries, dtype=np.int64) * (hi - lo + 1)) // queries
    diff = rows - int(s.sum())
    step = 1 if diff > 0 else -1
    i = 0
    while diff:
        j = i % queries
        if lo <= s[j] + step <= hi:
            s[j] += step
            diff -= step
        i += 1
        if i > 4 * queries * (hi - lo + 1):
            raise ValueError(f"{queries} queries of {lo}-{hi} rows cannot "
                             f"hold {rows} rows")
    return s


def _clusters(gen, device, data: dict):
    """``make_classification``'s clusters: ``(vertices [C, F], mixing
    matrices [C, F, F])``."""
    F = int(data["features"])
    if int(data["informative"]) != F:
        raise ValueError("only informative features are drawn")
    C = 2 * int(data["clusters_per_class"])
    sep = float(data["class_sep"])
    bits = torch.randint(0, 2, (C, F), generator=gen, device=device)
    vertex = bits.to(torch.float32) * (2 * sep) - sep
    mix = 2 * torch.rand((C, F, F), generator=gen, device=device) - 1
    return vertex, mix


def _classification(gen, device, clusters, data: dict, rows: int) -> Split:
    vertex, mix = clusters
    C, F = vertex.shape
    X = torch.randn((rows, F), generator=gen, device=device)
    y = torch.empty(rows, dtype=torch.float32, device=device)
    start = 0
    for k in range(C):
        n_k = rows // C + (rows % C if k == 0 else 0)
        X[start:start + n_k] = X[start:start + n_k] @ mix[k] + vertex[k]
        y[start:start + n_k] = float(k % 2)
        start += n_k
    flip = torch.rand(rows, generator=gen, device=device) < float(data["flip_y"])
    anew = torch.randint(0, 2, (rows,), generator=gen, device=device)
    y = torch.where(flip, anew.to(torch.float32), y)
    order = torch.randperm(rows, generator=gen, device=device)
    X, y = X[order], y[order]
    miss = float(data.get("missing", 0.0))
    if miss > 0:
        X[torch.rand((rows, F), generator=gen, device=device) < miss] = float("nan")
    return Split(X.cpu().numpy(), y.cpu().numpy(), None)


def _split(gen, device, w, data: dict, rows: int,
           sizes: Optional[np.ndarray]) -> Split:
    F = int(data["features"])
    X = torch.randn((rows, F), generator=gen, device=device)
    score = (float(data.get("score_weight", 1.0)) * (X * w).sum(dim=1)
             + float(data.get("noise", 0.0))
             * torch.randn(rows, generator=gen, device=device))
    sz = None
    if sizes is not None:
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
    if data["label"] == "grades":
        start = (torch.cumsum(sz, 0) - sz)[group_of]
        o = torch.argsort(score, stable=True)
        o = o[torch.argsort(group_of[o], stable=True)]
        local = torch.empty_like(o)
        local[o] = torch.arange(rows, device=device) - start[o]
        share = local.to(torch.float64) / sz[group_of].to(torch.float64)
        grades = torch.tensor(data["grades"], dtype=torch.float64, device=device)
        y = torch.searchsorted(grades, share, right=True).to(torch.float32)
    else:
        raise ValueError(f"unknown label rule {data['label']!r}")
    return Split(X.cpu().numpy(), y.cpu().numpy(),
                 None if sz is None else sz.cpu().numpy())


def make(config: dict, workload: dict, seed: int, device) -> Data:
    """The training and held-out rows of ``workload`` under ``config``'s
    data rule, drawn from ``seed`` on ``device``."""
    data = config["data"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    if data["label"] == "make_classification":
        clusters = _clusters(gen, device, data)
        return Data(*(_classification(gen, device, clusters, data, int(workload[k]))
                      for k in ("rows", "eval_rows")))
    w = torch.randn(int(data["features"]), generator=gen, device=device)
    parts = []
    for rows_key, q_key in (("rows", "queries"), ("eval_rows", "eval_queries")):
        rows = int(workload[rows_key])
        sizes = None
        if q_key in workload:
            lo, hi = workload["query_size"]
            sizes = query_sizes(int(workload[q_key]), rows, int(lo), int(hi))
        parts.append(_split(gen, device, w, data, rows, sizes))
    return Data(*parts)
