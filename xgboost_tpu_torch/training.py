"""``train()``: the round loop with per-round evaluation (the port of the
JAX package's ``training.py:train`` without callbacks, early stopping,
checkpoints or elastic mode)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from .data.dmatrix import DMatrix
from .learner import Booster

__all__ = ["train"]


def train(params: Dict[str, Any], dtrain: DMatrix, num_boost_round: int = 10,
          evals: Optional[Sequence[Tuple[DMatrix, str]]] = None,
          evals_result: Optional[dict] = None, verbose_eval: bool = True
          ) -> Booster:
    """Train ``num_boost_round`` rounds on ``dtrain``'s device. Each round
    evaluates every ``(DMatrix, name)`` of ``evals``; ``evals_result``
    receives ``{name: {metric: [value per round]}}``."""
    evals = list(evals) if evals else []
    bst = Booster(params, cache=[dtrain] + [d for d, _ in evals],
                  device=dtrain.device)
    history: Dict[str, Dict[str, list]] = {}
    for i in range(num_boost_round):
        bst.update(dtrain, i)
        if not evals:
            continue
        vals = bst.eval_values(evals, i)
        for name, metrics in vals.items():
            for m, v in metrics.items():
                history.setdefault(name, {}).setdefault(m, []).append(v)
        if verbose_eval:
            print("\t".join([f"[{i}]"] + [f"{name}-{m}:{v:.6f}"
                  for name, ms in vals.items() for m, v in ms.items()]))
    if evals_result is not None:
        evals_result.update(history)
    return bst
