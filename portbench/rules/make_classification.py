"""scikit-learn's ``make_classification`` with only informative features
(the reference's ``tests/benchmark/benchmark_tree.py``), on the device.

``n_classes`` (default 2) times ``clusters_per_class`` clusters, each at a
vertex of the hypercube of side ``2 * class_sep`` (its bits drawn at
random; distinct but with probability 2**-47 at 50 features), its rows
standard normal times a matrix of its own (uniform in [-1, 1]) plus the
vertex, its label the cluster's index mod ``n_classes``, as in
scikit-learn; then a ``flip_y`` share of the labels drawn anew from the
classes, and the rows shuffled. The clusters are one draw a seed, shared
by the training and held-out rows; each split gives every cluster the
same number of rows (the remainder to the first), as the source does.
Then a ``missing`` share of the values is set to NaN.
"""

from __future__ import annotations

import torch

from portbench.traffic import Data, Split


def _clusters(gen, device, data: dict):
    """The clusters: ``(vertices [C, F], mixing matrices [C, F, F])``."""
    F = int(data["features"])
    if int(data["informative"]) != F:
        raise ValueError("only informative features are drawn")
    C = int(data.get("n_classes", 2)) * int(data["clusters_per_class"])
    sep = float(data["class_sep"])
    bits = torch.randint(0, 2, (C, F), generator=gen, device=device)
    vertex = bits.to(torch.float32) * (2 * sep) - sep
    mix = 2 * torch.rand((C, F, F), generator=gen, device=device) - 1
    return vertex, mix


def _split(gen, device, clusters, data: dict, rows: int) -> Split:
    vertex, mix = clusters
    C, F = vertex.shape
    classes = int(data.get("n_classes", 2))
    X = torch.randn((rows, F), generator=gen, device=device)
    y = torch.empty(rows, dtype=torch.float32, device=device)
    start = 0
    for k in range(C):
        n_k = rows // C + (rows % C if k == 0 else 0)
        X[start:start + n_k] = X[start:start + n_k] @ mix[k] + vertex[k]
        y[start:start + n_k] = float(k % classes)
        start += n_k
    flip = torch.rand(rows, generator=gen, device=device) < float(data["flip_y"])
    anew = torch.randint(0, classes, (rows,), generator=gen, device=device)
    y = torch.where(flip, anew.to(torch.float32), y)
    order = torch.randperm(rows, generator=gen, device=device)
    X, y = X[order], y[order]
    miss = float(data.get("missing", 0.0))
    if miss > 0:
        X[torch.rand((rows, F), generator=gen, device=device) < miss] = float("nan")
    return Split(X.cpu().numpy(), y.cpu().numpy(), None)


def make(config: dict, workload: dict, seed: int, device) -> Data:
    data = config["data"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    clusters = _clusters(gen, device, data)
    return Data(*(_split(gen, device, clusters, data, int(workload[k]))
                  for k in ("rows", "eval_rows")))
