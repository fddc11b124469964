"""The comparison that decides a run's ``correct``.

After the window has closed the run hands over what the timed path made:
the model (its trees, read from the program's JSON dump), the training
matrix's cuts and bins, the two prediction caches (the margins of the
training and held-out rows after the last round) and the evaluation
history the run reported. The reference (``reference/``) works each of
them out again from the raw rows and labels:

- ``cut_mismatch``, ``bin_mismatch``: cut values and bins that differ
  from the reference's (exact: limit 0);
- ``tree_count_gap``: rounds that did not add exactly one tree (limit 0);
- ``gain_gap``, ``leaf_gap``: ``reference.tree.judge`` of the trees of
  the warm rounds, of three window rounds drawn from the seed and of the
  last round, each on the reference's own gradients at the margins the
  model's earlier trees give (the reference walks the model's trees in
  float32, round by round, as the prediction cache adds them);
- ``train_margin_gap``, ``valid_margin_gap``: the widest distance of a
  cached margin from that walk, over the larger of 1 and the walk's
  largest margin;
- ``metric_gap``: the widest distance of a reported evaluation metric,
  any round, from the reference's metric of the walked held-out margins.

The reference follows the model step by step: each judged tree is judged
on gradients of the margins of the model's own earlier trees. Round 0
starts from the base margin alone, and the stage this skips, the margin
update, is judged by itself by the two margin gaps.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import metric, objective, quantile
from .reference import tree as rtree

#: the numbers compared, in the order they are printed
CHECKS = ("cut_mismatch", "bin_mismatch", "tree_count_gap", "gain_gap",
          "leaf_gap", "train_margin_gap", "valid_margin_gap", "metric_gap")
#: window rounds judged besides the warm rounds and the last one
SAMPLED_ROUNDS = 3
ROW_BLOCK = 1 << 20


@dataclasses.dataclass
class Outputs:
    trees: List[rtree.HeapTree]
    cuts: np.ndarray  # [F, B] float32
    bins: Optional[torch.Tensor]  # [n, F], freed once compared
    train_margin: torch.Tensor  # [n]
    valid_margin: torch.Tensor  # [m]
    history: Dict[str, List[float]]  # metric -> value a round
    rounds: int


def collect(bst, dtrain, dvalid, history: dict, depth: int, rounds: int) -> Outputs:
    """What the program made, read through its public model dump, its
    matrix's cuts and bins and its prediction caches."""
    model = json.loads(bst.save_raw("json"))
    bm = next(iter(dtrain._binned.values()))
    return Outputs(
        trees=rtree.trees_from_model(model, depth),
        cuts=np.asarray(bm.cuts.values, np.float32),
        bins=bm.bins,
        train_margin=bst._caches[id(dtrain)].margin.reshape(-1).clone(),
        valid_margin=bst._caches[id(dvalid)].margin.reshape(-1).clone(),
        history={k: list(v) for k, v in history.get("valid", {}).items()},
        rounds=rounds)


def judged_rounds(rounds: int, warm: int, seed: int) -> List[int]:
    window = list(range(warm, rounds - 1))
    pick = random.Random(int(seed)).sample(window, min(SAMPLED_ROUNDS, len(window)))
    return sorted(set(range(min(warm, rounds))) | set(pick) | {rounds - 1})


def split_params(params: dict) -> rtree.Params:
    return rtree.Params(max_depth=int(params["max_depth"]), eta=float(params["eta"]),
                        reg_lambda=float(params.get("lambda", 1.0)),
                        min_child_weight=float(params.get("min_child_weight", 1.0)))


def _tensor(a, dev, dtype=None):
    return torch.as_tensor(a, device=dev, dtype=dtype)


def ref_bins(X: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    return torch.cat([quantile.bins(X[r:r + ROW_BLOCK], cuts)
                      for r in range(0, X.shape[0], ROW_BLOCK)])


def compare(out: Outputs, data, params: dict, warm: int, seed: int,
            device) -> Dict[str, float]:
    """The numbers of ``CHECKS`` for the outputs ``out`` of a run on
    ``data`` (``traffic.Data``) under ``params``."""
    dev = torch.device(device)
    obj = params["objective"]
    B = int(params["max_bin"])
    p = split_params(params)
    D = p.max_depth
    X = _tensor(data.train.X, dev)
    y = _tensor(data.train.y, dev)
    sizes = (None if data.train.sizes is None
             else _tensor(data.train.sizes, dev, torch.long))
    cuts, _ = quantile.cuts(X, B)
    checks: Dict[str, float] = {}
    checks["cut_mismatch"] = float((_tensor(out.cuts, dev) != cuts).sum())
    bins = ref_bins(X, cuts)
    if out.bins is not None:
        checks["bin_mismatch"] = float(sum(
            int((out.bins[r:r + ROW_BLOCK].to(torch.int32)
                 != bins[r:r + ROW_BLOCK].to(torch.int32)).sum())
            for r in range(0, X.shape[0], ROW_BLOCK)))
        out.bins = None
    checks["tree_count_gap"] = float(abs(len(out.trees) - out.rounds))

    base = objective.base_margin(obj)
    judged = set(judged_rounds(out.rounds, warm, seed))
    margin = torch.full((X.shape[0],), base, dtype=torch.float32, device=dev)
    gain_gap = leaf_gap = 0.0
    trees = [t.to(dev) for t in out.trees]
    for t, tr in enumerate(trees):
        if t in judged:
            g, h = objective.gradient(obj, margin, y, sizes, t)
            r = rtree.judge(tr, X, bins, B, g, h, p)
            gain_gap, leaf_gap = max(gain_gap, r["gain_gap"]), max(leaf_gap, r["leaf_gap"])
            del g, h
        margin = margin + tr.value[rtree.leaf_of(tr, X, D)]
    checks["gain_gap"], checks["leaf_gap"] = gain_gap, leaf_gap
    checks["train_margin_gap"] = _margin_gap(out.train_margin, margin)
    del X, bins, margin

    Xv = _tensor(data.valid.X, dev)
    yv = _tensor(data.valid.y, dev)
    sv = (None if data.valid.sizes is None
          else _tensor(data.valid.sizes, dev, torch.long))
    mv = torch.full((Xv.shape[0],), base, dtype=torch.float32, device=dev)
    gap = 0.0
    for t, tr in enumerate(trees):
        mv = mv + tr.value[rtree.leaf_of(tr, Xv, D)]
        for name, values in out.history.items():
            if t < len(values):
                gap = max(gap, abs(values[t] - metric.evaluate(name, mv, yv, sv)))
    checks["valid_margin_gap"] = _margin_gap(out.valid_margin, mv)
    checks["metric_gap"] = gap
    return checks


def _margin_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    if got.shape != ref.shape:
        return float("inf")
    diff = (got.to(ref.device, torch.float64) - ref.to(torch.float64)).abs().max()
    return float(diff) / max(1.0, float(ref.abs().max()))


def verdict(checks: Dict[str, float], limits: Dict[str, float]):
    """``(correct, failed names)``: a number passes at or under its limit."""
    failed = [k for k in CHECKS if not checks.get(k, float("inf")) <= limits[k]]
    return not failed, failed
