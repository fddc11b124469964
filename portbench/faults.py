"""Faults planted in the program under test, to show that the check sees
them (``tests/test_portbench_faults.py`` on the CPU, ``calibrate.py
--fault`` on the card). Each is a context manager that patches the
program for its duration.

- ``unchanged_step``: every round's tree has all-zero leaves, so a round
  leaves the model's predictions as they were;
- ``half_batch``: the gradients of every other row are dropped and the
  rest doubled, the mean taken over half the rows, whatever the objective
  (the round's gradients as the learner hands them to the grower);
- ``altered_leaf``: one leaf value of every tree is altered by 0.1% where
  the grower produces it;
- ``altered_walk``: the walk's answer for one row is altered by 1e-3
  where the walk produces it (in training, the walks fill the held-out
  rows' cache).

The exchange between cards is not among them: every cell runs on one card.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patch(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _finalize_patch(change):
    from xgboost_tpu_torch.tree import grow_fused

    orig = grow_fused._finalize

    def finalize(*a, **k):
        keep, leaf_value = orig(*a, **k)
        return keep, change(leaf_value)

    return _patch(grow_fused, "_finalize", finalize)


def unchanged_step():
    return _finalize_patch(lambda v: v * 0.0)


def altered_leaf():
    def change(v):
        v = v.clone()
        v[-1] = v[-1] * 1.001 + 1e-3 * v.abs().max()
        return v
    return _finalize_patch(change)


def half_batch():
    import torch

    from xgboost_tpu_torch import learner

    orig = learner.Booster._gradient

    def halved(self, *a, **k):
        margin, g, h = orig(self, *a, **k)
        keep = (torch.arange(g.shape[0], device=g.device) % 2 == 0) * 2.0
        keep = keep if g.dim() == 1 else keep[:, None]
        return margin, g * keep, h * keep

    return _patch(learner.Booster, "_gradient", halved)


def altered_walk():
    from xgboost_tpu_torch import learner

    orig = learner.predict_margin

    def walk(forest, X, base, *a, **k):
        out = orig(forest, X, base, *a, **k).clone()
        out.view(-1)[0] += 1e-3
        return out

    return _patch(learner, "predict_margin", walk)


FAULTS = {"unchanged_step": unchanged_step, "half_batch": half_batch,
          "altered_leaf": altered_leaf, "altered_walk": altered_walk}
