"""The comparison that decides a run's ``correct``.

After the window has closed the run hands over what the timed path made:
the model (its trees and each tree's output group, read from the
program's JSON dump), the training matrix's cuts and bins, the two
prediction caches (the margins ``[rows, G]`` of the training and held-out
rows after the last round) and the evaluation history the run reported.
The reference (``reference/``) works each of them out again from the raw
rows and labels. The configuration's objective and metrics are found by
name (``lookup``); the objective's file gives ``G``, its outputs, and a
round adds ``G`` trees, tree ``k`` of a round for output ``k``:

- ``cut_mismatch``, ``bin_mismatch``: cut values and bins that differ
  from the reference's (exact: limit 0);
- ``tree_count_gap``: ``|trees - rounds * G|``, plus the trees whose group
  in the dump is not their place in the round (limit 0);
- ``gain_gap``, ``leaf_gap``: ``reference.tree.judge`` of the ``G`` trees
  of each warm round, of three window rounds drawn from the seed and of
  the last round, tree ``k`` on column ``k`` of the reference's own
  gradients at the margins the model's earlier rounds give (the gradients
  of a round are taken once, before its trees, as the program takes them;
  the reference walks the model's trees in float32, round by round, as the
  prediction cache adds them);
- ``train_margin_gap``, ``valid_margin_gap``: the widest distance of a
  cached margin from that walk, over the larger of 1 and the walk's
  largest margin;
- ``metric_gap``: the widest distance of a reported evaluation metric,
  any round, from the reference's metric of the walked held-out margins.

The reference follows the model step by step: each judged tree is judged
on gradients of the margins of the model's own earlier rounds. Round 0
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

from . import lookup
from .reference import quantile
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
    tree_groups: List[int]  # each tree's output group, as the dump has it
    cuts: np.ndarray  # [F, B] float32
    bins: Optional[torch.Tensor]  # [n, F], freed once compared
    train_margin: torch.Tensor  # [n, G]
    valid_margin: torch.Tensor  # [m, G]
    history: Dict[str, List[float]]  # metric -> value a round
    rounds: int


def collect(bst, dtrain, dvalid, history: dict, depth: int, rounds: int,
            groups: int) -> Outputs:
    """What the program made, read through its public model dump, its
    matrix's cuts and bins and its prediction caches. ``groups`` is the
    objective's outputs by its reference; a dump with another
    ``num_class`` raises."""
    model = json.loads(bst.save_raw("json"))
    num_class = int(model["learner"]["learner_model_param"]["num_class"])
    if max(1, num_class) != groups:
        raise ValueError(f"the model has num_class {num_class}; the objective's "
                         f"reference has {groups} outputs")
    bm = next(iter(dtrain._binned.values()))
    return Outputs(
        trees=rtree.trees_from_model(model, depth),
        tree_groups=[int(k) for k in
                     model["learner"]["gradient_booster"]["model"]["tree_info"]],
        cuts=np.asarray(bm.cuts.values, np.float32),
        bins=bm.bins,
        train_margin=bst._caches[id(dtrain)].margin.clone(),
        valid_margin=bst._caches[id(dvalid)].margin.clone(),
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


def add_round(margin: torch.Tensor, trees: List[rtree.HeapTree], X: torch.Tensor,
              depth: int) -> torch.Tensor:
    """``margin`` [rows, G] plus one round's trees, tree ``k`` into column
    ``k``, each leaf value added once in float32."""
    delta = torch.zeros_like(margin)
    for k, tr in enumerate(trees):
        delta[:, k] = tr.value[rtree.leaf_of(tr, X, depth)]
    return margin + delta


def compare(out: Outputs, data, params: dict, warm: int, seed: int,
            device) -> Dict[str, float]:
    """The numbers of ``CHECKS`` for the outputs ``out`` of a run on
    ``data`` (``traffic.Data``) under ``params``."""
    dev = torch.device(device)
    obj = lookup.objective(params["objective"])
    G = obj.outputs(params)
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
    misplaced = sum(k != t % G for t, k in enumerate(out.tree_groups))
    checks["tree_count_gap"] = float(abs(len(out.trees) - out.rounds * G) + misplaced)

    base = obj.base_margin(params)
    judged = set(judged_rounds(out.rounds, warm, seed))
    trees = [t.to(dev) for t in out.trees]
    rounds = [trees[i:i + G] for i in range(0, len(trees), G)]
    margin = torch.full((X.shape[0], G), base, dtype=torch.float32, device=dev)
    gain_gap = leaf_gap = 0.0
    for r, round_trees in enumerate(rounds):
        if r in judged:
            g, h = obj.gradient(margin, y, sizes, r)
            for k, tr in enumerate(round_trees):
                res = rtree.judge(tr, X, bins, B, g[:, k], h[:, k], p)
                gain_gap = max(gain_gap, res["gain_gap"])
                leaf_gap = max(leaf_gap, res["leaf_gap"])
            del g, h
        margin = add_round(margin, round_trees, X, D)
    checks["gain_gap"], checks["leaf_gap"] = gain_gap, leaf_gap
    checks["train_margin_gap"] = _margin_gap(out.train_margin, margin)
    del X, bins, margin

    Xv = _tensor(data.valid.X, dev)
    yv = _tensor(data.valid.y, dev)
    sv = (None if data.valid.sizes is None
          else _tensor(data.valid.sizes, dev, torch.long))
    metrics = [(values, *lookup.metric(name)) for name, values in out.history.items()]
    mv = torch.full((Xv.shape[0], G), base, dtype=torch.float32, device=dev)
    gap = 0.0
    for r, round_trees in enumerate(rounds):
        mv = add_round(mv, round_trees, Xv, D)
        for values, mod, arg in metrics:
            if r < len(values):
                gap = max(gap, abs(values[r] - mod.evaluate(mv, yv, sv, arg)))
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
