"""The control of the check: the reference put in the program's place, one
precision below the configuration's float32 (bfloat16).

It cuts and bins the rows rounded to bfloat16; each round it takes the
objective's gradients once and grows one tree for each of its ``G``
outputs, tree ``k`` on column ``k`` rounded to bfloat16 (histograms summed
in float32), rounds the leaves to bfloat16 and keeps both prediction
caches ``[rows, G]`` in bfloat16; the evaluation history is taken from
those margins. The judge then reads its outputs as it reads a run's, and
the check has to come out false.
"""

from __future__ import annotations

import torch

from . import judge, lookup
from .reference import quantile
from .reference import tree as rtree

BF16 = torch.bfloat16
F32 = torch.float32


def outputs(data, params: dict, rounds: int, device) -> judge.Outputs:
    dev = torch.device(device)
    obj = lookup.objective(params["objective"])
    G = obj.outputs(params)
    B = int(params["max_bin"])
    p = judge.split_params(params)
    X = torch.as_tensor(data.train.X, device=dev).to(BF16).to(F32)
    y = torch.as_tensor(data.train.y, device=dev)
    sizes = (None if data.train.sizes is None
             else torch.as_tensor(data.train.sizes, device=dev, dtype=torch.long))
    Xv = torch.as_tensor(data.valid.X, device=dev).to(BF16).to(F32)
    yv = torch.as_tensor(data.valid.y, device=dev)
    sv = (None if data.valid.sizes is None
          else torch.as_tensor(data.valid.sizes, device=dev, dtype=torch.long))
    cuts, _ = quantile.cuts(X, B)
    bins = judge.ref_bins(X, cuts)
    base = obj.base_margin(params)
    m = torch.full((X.shape[0], G), base, device=dev).to(BF16)
    mv = torch.full((Xv.shape[0], G), base, device=dev).to(BF16)
    names = params["eval_metric"]
    names = [names] if isinstance(names, str) else list(names)
    metrics = {k: lookup.metric(k) for k in names}
    history = {k: [] for k in names}
    trees = []
    for t in range(rounds):
        g, h = obj.gradient(m.to(F32), y, sizes, t)
        grown = []
        for k in range(G):
            tr = rtree.grow(bins, cuts, g[:, k].to(BF16).to(F32),
                            h[:, k].to(BF16).to(F32), p, dtype=F32)
            tr.value = tr.value.to(BF16).to(F32)
            grown.append(tr)
        trees += grown
        m = judge.add_round(m.to(F32), grown, X, p.max_depth).to(BF16)
        mv = judge.add_round(mv.to(F32), grown, Xv, p.max_depth).to(BF16)
        for k, (mod, arg) in metrics.items():
            history[k].append(round(mod.evaluate(mv.to(F32), yv, sv, arg), 6))
    return judge.Outputs(trees=[t.to("cpu") for t in trees],
                         tree_groups=[t % G for t in range(len(trees))],
                         cuts=cuts.cpu().numpy(), bins=bins, train_margin=m,
                         valid_margin=mv, history=history, rounds=rounds)
