"""``train()`` and ``cv()`` (the port of the JAX package's ``training.py``:
``_AtomicCheckpoint`` :26-66, ``train`` :72-335 and ``cv`` with
``_make_folds`` :736-872; reference ``python-package/xgboost/training.py``
:49 and :189-459). Elastic training (``elastic_train``) is not ported."""

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
from .resilience import checkpoint as _ckpt
from .resilience.watchdog import watchdog as _watchdog

__all__ = ["train", "cv"]


class _AtomicCheckpoint(TrainingCallback):
    """Crash-safe checkpoints for ``train(resume_from=...)`` every
    ``interval`` rounds (``resilience/checkpoint.py``: atomic, checksummed,
    the 2 newest kept), written on this thread; ``after_training`` writes
    the final round. A round already on disk (a resumed run's first) is
    not written again."""

    def __init__(self, directory: str, interval: int = 1):
        self.directory = directory
        self.interval = max(1, int(interval))

    def _save(self, model) -> None:
        rounds = model.num_boosted_rounds()
        if rounds and _ckpt.read_checkpoint(
                _ckpt.checkpoint_path(self.directory, rounds)) is None:
            _ckpt.save_checkpoint(self.directory, model, rounds)

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if (epoch + 1) % self.interval == 0:
            self._save(model)
        return False

    def after_training(self, model):
        self._save(model)  # the final round is always durable
        return model


#: verified checkpoints of each rank compared when a row group resumes
_RESUME_CANDIDATES = 8


def _agreed_checkpoint(ckpt_dir: str) -> Optional[Tuple[bytes, int]]:
    """The newest verified checkpoint of ``ckpt_dir``; under an active row
    group of several ranks, the newest round that every rank still holds
    verified (a kill can land while one rank's write is in flight or after
    its file was damaged, and ranks resuming from different rounds would
    desync), or None when they share none. The JAX package resumes each
    rank from its own newest."""
    from .parallel.mesh import collective_active

    if not collective_active():
        return _ckpt.load_latest(ckpt_dir)
    from .collective import process_allgather

    verified: Dict[int, Tuple[bytes, int]] = {}
    for path in reversed(_ckpt.list_checkpoints(ckpt_dir)):
        got = _ckpt.read_checkpoint(path)
        if got is not None:
            verified.setdefault(got[1], got)
            if len(verified) == _RESUME_CANDIDATES:
                break
    mine = np.full(_RESUME_CANDIDATES, -1, np.int64)
    mine[:len(verified)] = sorted(verified, reverse=True)
    every = process_allgather(mine, site="resume_rounds")
    common = set.intersection(*(set(r) for r in every.tolist())) - {-1}
    if not common:
        if (every >= 0).any():
            from .utils import console_logger

            console_logger.warning(
                f"resume_from: the ranks hold no verified round in common "
                f"({ckpt_dir}); training from the start")
        return None
    return verified[max(common)]


def _commit_on_abort(bst: Booster, ckpt_dir: Optional[str]) -> None:
    """An abort mid-loop (a watchdog expiry, a failed collective, a fault
    at a kernel's launch site) keeps the finished rounds: write the
    model's whole rounds. Best effort: the abort itself must still
    surface."""
    if ckpt_dir is None:
        return
    try:
        rounds = bst.num_boosted_rounds()  # 0 for gblinear: nothing to keep
        # never a round cut between its trees
        if rounds and bst._gbm.model.num_trees == rounds * bst._per_round:
            _ckpt.save_checkpoint(ckpt_dir, bst, rounds)
    except Exception:
        pass


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
    ``XGBTPU_PROFILE`` opens the profiling window at the first round.

    ``resume_from`` is a directory of crash-safe checkpoints
    (``resilience/checkpoint.py``; ``rank<r>`` subdirectories in a world of
    several ranks unless ``checkpoint_shared``). Training resumes from the
    newest verified checkpoint there (when no ``xgb_model`` is given) and
    commits one every ``checkpoint_interval`` rounds, and on any abort the
    finished rounds. With ``resume_mode="total"`` ``num_boost_round`` is
    the total: a run resumed at round r trains the remaining
    ``num_boost_round - r``, so rerunning a killed command finishes it;
    ``"append"`` trains ``num_boost_round`` more. A resumed booster fills
    its caches round by round (``Booster._fill_caches_by_round``), so the
    resumed model's bytes are an uninterrupted run's. Each round's
    ``update`` runs under the ``round_dispatch`` watchdog
    (``XGBTPU_WATCHDOG``; none by default). No counterpart here: the JAX
    package's scan path and its ``train_dispatch`` deadline (TPU only),
    the ``native_dispatch`` retry (the CPU native kernels have no
    counterpart by design), ``RoundPipeline`` and ``kernelprof``."""
    if resume_mode not in ("total", "append"):
        raise ValueError(
            f"resume_mode must be 'total' or 'append', got {resume_mode!r}")
    callbacks = list(callbacks) if callbacks else []
    evals = list(evals) if evals else []
    feval = custom_metric if custom_metric is not None else feval
    ckpt_dir: Optional[str] = None
    resumed = False
    if resume_from is not None:
        ckpt_dir = _ckpt.process_dir(resume_from, shared=checkpoint_shared)
        loaded = _agreed_checkpoint(ckpt_dir)
        if loaded is not None and xgb_model is None:
            xgb_model, done_rounds = bytes(loaded[0]), loaded[1]
            resumed = True
            if resume_mode == "total":
                num_boost_round = max(0, num_boost_round - done_rounds)
        callbacks.append(_AtomicCheckpoint(ckpt_dir, checkpoint_interval))
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
        if resumed:
            bst._fill_caches_by_round(dtrain, [d for d, _ in evals])
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
                        with _watchdog("round_dispatch"):
                            bst.update(dtrain, i, fobj=obj)
                        _flight.note("grow", time.perf_counter() - t0)
                        stop = container.after_iteration(
                            bst, i, dtrain, evals, feval=feval)
                finally:
                    _flight.RECORDER.end_round()
                if stop:
                    break
    except BaseException as e:
        _commit_on_abort(bst, ckpt_dir)
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
