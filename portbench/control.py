"""The control of the check: the reference put in the program's place, one
precision below the configuration's float32 (bfloat16).

It cuts and bins the rows rounded to bfloat16, grows each round's tree on
gradients rounded to bfloat16 (histograms summed in float32), rounds the
leaves to bfloat16 and keeps both prediction caches in bfloat16; the
evaluation history is taken from those margins. The judge then reads its
outputs as it reads a run's, and the check has to come out false.
"""

from __future__ import annotations

import torch

from . import judge
from .reference import metric, objective, quantile
from .reference import tree as rtree

BF16 = torch.bfloat16


def outputs(data, params: dict, rounds: int, device) -> judge.Outputs:
    dev = torch.device(device)
    obj = params["objective"]
    B = int(params["max_bin"])
    p = judge.split_params(params)
    X = torch.as_tensor(data.train.X, device=dev).to(BF16).to(torch.float32)
    y = torch.as_tensor(data.train.y, device=dev)
    sizes = (None if data.train.sizes is None
             else torch.as_tensor(data.train.sizes, device=dev, dtype=torch.long))
    Xv = torch.as_tensor(data.valid.X, device=dev).to(BF16).to(torch.float32)
    yv = torch.as_tensor(data.valid.y, device=dev)
    sv = (None if data.valid.sizes is None
          else torch.as_tensor(data.valid.sizes, device=dev, dtype=torch.long))
    cuts, _ = quantile.cuts(X, B)
    bins = judge.ref_bins(X, cuts)
    base = objective.base_margin(obj)
    m = torch.full((X.shape[0],), base, device=dev).to(BF16)
    mv = torch.full((Xv.shape[0],), base, device=dev).to(BF16)
    names = params["eval_metric"]
    names = [names] if isinstance(names, str) else list(names)
    history = {k: [] for k in names}
    trees = []
    for t in range(rounds):
        g, h = objective.gradient(obj, m.to(torch.float32), y, sizes, t)
        tr = rtree.grow(bins, cuts, g.to(BF16).to(torch.float32),
                        h.to(BF16).to(torch.float32), p, dtype=torch.float32)
        tr.value = tr.value.to(BF16).to(torch.float32)
        trees.append(tr)
        m = (m.to(torch.float32) + tr.value[rtree.leaf_of(tr, X, p.max_depth)]).to(BF16)
        mv = (mv.to(torch.float32) + tr.value[rtree.leaf_of(tr, Xv, p.max_depth)]).to(BF16)
        for k in names:
            history[k].append(round(metric.evaluate(k, mv.to(torch.float32), yv, sv), 6))
    return judge.Outputs(trees=[t.to("cpu") for t in trees], cuts=cuts.cpu().numpy(),
                         bins=bins, train_margin=m, valid_margin=mv,
                         history=history, rounds=rounds)
