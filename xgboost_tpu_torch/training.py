"""``train()`` and ``cv()`` (the port of the JAX package's ``training.py``:
``train`` :72-335 and ``cv`` with ``_make_folds`` :736-872; reference
``python-package/xgboost/training.py`` :49 and :189-459). Crash-safe
checkpoints (``resume_from``, ``checkpoint_*``, ``resume_mode``) and elastic
training are not ported: ``train`` raises NotImplementedError when one is
asked for."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .callback import (CallbackContainer, EarlyStopping, EvaluationMonitor,
                       TrainingCallback, is_maximize)
from .data.dmatrix import DMatrix
from .learner import Booster
from .observability import flight as _flight
from .observability import trace as _trace

__all__ = ["train", "cv"]


def train(params: Dict[str, Any], dtrain: DMatrix, num_boost_round: int = 10,
          evals: Optional[Sequence[Tuple[DMatrix, str]]] = None, obj=None,
          feval=None, maximize: Optional[bool] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None, verbose_eval: Any = True,
          xgb_model=None, callbacks: Optional[Sequence[TrainingCallback]] = None,
          custom_metric=None, resume_from: Optional[str] = None,
          checkpoint_interval: int = 1, checkpoint_shared: bool = False,
          resume_mode: str = "total") -> Booster:
    """Train ``num_boost_round`` rounds on ``dtrain``'s device.

    Each round evaluates every ``(DMatrix, name)`` of ``evals`` (with
    ``feval``, or ``custom_metric``, appended: ``(name, value) =
    feval(margin, dmat)``); ``evals_result`` receives the history
    ``{name: {metric: [value per round]}}``, each value rounded to 6
    decimals. ``obj(margin, dtrain) -> (grad, hess)`` replaces the
    objective's gradients. ``early_stopping_rounds`` stops when the last
    metric of the last eval set has not improved for that many rounds
    (``maximize`` overrides the metric's direction) and sets the
    ``best_iteration`` / ``best_score`` attributes. ``verbose_eval`` prints
    every round (True) or every ``verbose_eval`` rounds. ``xgb_model`` (a
    Booster, a model path or its bytes) continues that model: a copy, with
    ``params`` set, fresh prediction caches, from its
    ``num_boosted_rounds()``.

    The loop is traced as the JAX package's: a ``train`` span holding one
    ``round`` span a round, and the flight recorder keeps one record a
    round (its ``grow`` and ``eval`` stages); an exception dumps the
    recorder's black box before it propagates (``abort_dump``), and
    ``XGBTPU_PROFILE`` opens the profiling window at the first round."""
    if resume_mode not in ("total", "append"):
        raise ValueError(
            f"resume_mode must be 'total' or 'append', got {resume_mode!r}")
    if (resume_from is not None or checkpoint_interval != 1
            or checkpoint_shared or resume_mode != "total"):
        raise NotImplementedError(
            "crash-safe checkpoints (resume_from, checkpoint_interval, "
            "checkpoint_shared, resume_mode) are not ported yet")
    callbacks = list(callbacks) if callbacks else []
    evals = list(evals) if evals else []
    feval = custom_metric if custom_metric is not None else feval
    if verbose_eval:
        period = (verbose_eval if isinstance(verbose_eval, int)
                  and not isinstance(verbose_eval, bool) else 1)
        callbacks.append(EvaluationMonitor(period=period))
    if early_stopping_rounds is not None:
        callbacks.append(EarlyStopping(rounds=early_stopping_rounds,
                                       maximize=maximize))

    if xgb_model is not None:
        bst = (xgb_model.copy() if isinstance(xgb_model, Booster)
               else Booster(params, model_file=xgb_model,
                            device=dtrain.device))
        bst.set_param(params)
        for d in [dtrain] + [d for d, _ in evals]:
            bst._add_cache(d)
        start_round = bst.num_boosted_rounds()
    else:
        bst = Booster(params, cache=[dtrain] + [d for d, _ in evals],
                      device=dtrain.device)
        start_round = 0

    container = CallbackContainer(callbacks)
    bst = container.before_training(bst)
    try:
        with _trace.span("train", rounds=num_boost_round, path="per_round"):
            for i in range(start_round, start_round + num_boost_round):
                if container.before_iteration(bst, i, dtrain, evals):
                    break
                _flight.profile_tick(i)
                _flight.RECORDER.begin_round(i)
                try:
                    with _trace.span("round", iteration=i):
                        t0 = time.perf_counter()
                        bst.update(dtrain, i, fobj=obj)
                        _flight.note("grow", time.perf_counter() - t0)
                        stop = container.after_iteration(
                            bst, i, dtrain, evals, feval=feval)
                finally:
                    _flight.RECORDER.end_round()
                if stop:
                    break
    except BaseException as e:
        _flight.RECORDER.abort_dump(e)  # the black box: ring + metrics
        raise
    finally:
        _flight.profile_stop()
    bst = container.after_training(bst)

    if evals_result is not None:
        for k, v in container.history.items():
            evals_result[k] = {mk: list(mv) for mk, mv in v.items()}
    return bst


def _make_folds(dtrain: DMatrix, nfold: int, seed: int, stratified: bool,
                folds, shuffle: bool = True) -> List[Tuple[DMatrix, DMatrix]]:
    """``(train, test)`` DMatrix pairs, each a ``DMatrix.slice`` on
    ``dtrain``'s device: the given ``folds`` (index pairs, or an object with
    ``split``), else the JAX package's assignment, shuffled by
    ``np.random.RandomState(seed)`` (stratified: rows sorted by label after
    the shuffle and dealt round robin; otherwise contiguous blocks of
    ``ceil(n / nfold)``)."""
    n = dtrain.num_row()
    rng = np.random.RandomState(seed)
    if folds is not None:
        splits = folds if not hasattr(folds, "split") else list(
            folds.split(X=np.zeros(n), y=dtrain.get_label()))
    else:
        idx = np.arange(n)
        if shuffle:
            rng.shuffle(idx)
        if stratified and dtrain.label is not None:
            order = np.argsort(dtrain.get_label()[idx], kind="stable")
            idx = idx[order]  # interleave classes across folds
            fold_of = np.arange(n) % nfold
        else:
            fold_of = np.repeat(np.arange(nfold), int(np.ceil(n / nfold)))[:n]
        splits = [(idx[fold_of != k], idx[fold_of == k])
                  for k in range(nfold)]
    return [(dtrain.slice(np.asarray(tr)), dtrain.slice(np.asarray(te)))
            for tr, te in splits]


def cv(params: Dict[str, Any], dtrain: DMatrix, num_boost_round: int = 10,
       nfold: int = 3, stratified: bool = False, folds=None,
       metrics: Sequence[str] = (), obj=None, feval=None,
       maximize: Optional[bool] = None,
       early_stopping_rounds: Optional[int] = None, fpreproc=None,
       as_pandas: bool = True, verbose_eval: Any = None,
       show_stdv: bool = True, seed: int = 0,
       callbacks: Optional[Sequence[TrainingCallback]] = None,
       shuffle: bool = True, custom_metric=None):
    """K-fold cross-validation (the JAX package's ``cv``): one Booster per
    fold on ``dtrain``'s device, trained round by round, each round's
    ``train-`` and ``test-`` values (6 decimals) averaged over the folds
    into ``{"<set>-<metric>-mean": [...], "<set>-<metric>-std": [...]}``.
    With ``early_stopping_rounds`` the last test metric decides the stop
    and the history is cut after the best round. A pandas DataFrame when
    ``as_pandas`` and pandas is present, else the dict. ``callbacks`` are
    accepted and none is run, as in the JAX package."""
    params = dict(params)
    if isinstance(metrics, str):
        metrics = [metrics]
    if metrics:
        params["eval_metric"] = list(metrics)
    cvpacks = []
    for dtr, dte in _make_folds(dtrain, nfold, seed, stratified, folds,
                                shuffle):
        p = params
        if fpreproc is not None:
            dtr, dte, p = fpreproc(dtr, dte, dict(params))
        cvpacks.append((Booster(p, cache=[dtr, dte], device=dtrain.device),
                        dtr, dte))

    feval = custom_metric if custom_metric is not None else feval
    history: Dict[str, List[float]] = {}
    best_iteration = None
    best, stale = None, 0
    for i in range(num_boost_round):
        round_scores: Dict[str, List[float]] = {}
        for bst, dtr, dte in cvpacks:
            bst.update(dtr, i, fobj=obj)
            msg = bst.eval_set([(dtr, "train"), (dte, "test")], i,
                               feval=feval)
            for tok in msg.split("\t")[1:]:
                nm, _, val = tok.rpartition(":")
                round_scores.setdefault(nm, []).append(float(val))
        agg = {k: (float(np.mean(v)), float(np.std(v)))
               for k, v in round_scores.items()}
        for k, (m, s) in agg.items():
            history.setdefault(f"{k}-mean", []).append(m)
            history.setdefault(f"{k}-std", []).append(s)
        if verbose_eval:
            print(f"[{i}]\t" + "\t".join(
                f"{k}:{m:.5f}" + (f"+{s:.5f}" if show_stdv else "")
                for k, (m, s) in agg.items()), flush=True)
        if early_stopping_rounds is not None:
            test_keys = [k for k in agg if k.startswith("test-")]
            if test_keys:
                key = test_keys[-1]
                score = agg[key][0]
                is_max = is_maximize(key[len("test-"):], cvpacks[0][0],
                                     maximize)
                if (best is None or (is_max and score > best)
                        or (not is_max and score < best)):
                    best, stale, best_iteration = score, 0, i
                else:
                    stale += 1
                    if stale >= early_stopping_rounds:
                        break
    if early_stopping_rounds is not None and best_iteration is not None:
        for k in history:
            history[k] = history[k][: best_iteration + 1]
    if as_pandas:
        try:
            import pandas as pd
        except ImportError:
            return history
        return pd.DataFrame(history)
    return history
