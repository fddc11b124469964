"""Training callbacks (the port of the JAX package's ``callback.py``;
reference ``python-package/xgboost/callback.py``: ``TrainingCallback`` :23,
``CallbackContainer`` :102, ``LearningRateScheduler`` :239,
``EarlyStopping`` :275, ``EvaluationMonitor`` :434, ``TrainingCheckPoint``
:501).

The evaluation history is parsed from ``Booster.eval_set``'s
``"%.6f"`` string, as in the JAX package, so every recorded value is
rounded to 6 decimals and early stopping compares the rounded values.
"""

from __future__ import annotations

import collections
import os
import pickle
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "TrainingCallback",
    "CallbackContainer",
    "LearningRateScheduler",
    "EarlyStopping",
    "EvaluationMonitor",
    "TrainingCheckPoint",
    "TrainingTelemetry",
    "FlightRecorderMonitor",
    "is_maximize",
]

_EvalsLog = Dict[str, Dict[str, List[float]]]


class TrainingCallback:
    def before_training(self, model):
        return model

    def after_training(self, model):
        return model

    def before_iteration(self, model, epoch: int, evals_log: _EvalsLog) -> bool:
        return False

    def after_iteration(self, model, epoch: int, evals_log: _EvalsLog) -> bool:
        """Return True to stop training."""
        return False


class CallbackContainer:
    """Runs the callbacks around the round loop and owns the history
    ``{data name: {metric name: [value per round]}}``."""

    def __init__(self, callbacks: Sequence[TrainingCallback]):
        self.callbacks = list(callbacks)
        self.history: _EvalsLog = collections.OrderedDict()

    def before_training(self, model):
        for cb in self.callbacks:
            model = cb.before_training(model)
        return model

    def after_training(self, model):
        for cb in self.callbacks:
            model = cb.after_training(model)
        return model

    def before_iteration(self, model, epoch, dtrain, evals) -> bool:
        return any(cb.before_iteration(model, epoch, self.history)
                   for cb in self.callbacks)

    def _update_history(self, score_strs: str) -> None:
        """Parse ``"[i]\\tname-metric:val\\t..."`` into the history."""
        for tok in score_strs.split("\t")[1:]:
            name_metric, _, val = tok.rpartition(":")
            dname, _, mname = name_metric.partition("-")
            self.history.setdefault(
                dname, collections.OrderedDict()).setdefault(
                mname, []).append(float(val))

    def after_iteration(self, model, epoch, dtrain, evals, feval=None) -> bool:
        if evals:
            from .observability import flight

            t0 = time.perf_counter()
            msg = model.eval_set(evals, epoch, feval)
            flight.note("eval", time.perf_counter() - t0)
            self._update_history(msg)
        return any(cb.after_iteration(model, epoch, self.history)
                   for cb in self.callbacks)


class LearningRateScheduler(TrainingCallback):
    """Sets ``learning_rate`` before each round: ``learning_rates(epoch)``,
    or ``learning_rates[epoch]`` for a sequence."""

    def __init__(self, learning_rates: Union[Callable[[int], float],
                                             Sequence[float]]):
        if callable(learning_rates):
            self.fn = learning_rates
        else:
            rates = list(learning_rates)
            self.fn = lambda epoch: rates[epoch]

    def before_iteration(self, model, epoch, evals_log) -> bool:
        model.set_param("learning_rate", self.fn(epoch))
        return False


#: metrics better when larger, for a metric no Booster object names (a
#: custom metric's name)
_MAXIMIZE_METRICS = ("auc", "aucpr", "map", "ndcg", "pre", "ams",
                     "interval-regression-accuracy")


def is_maximize(metric: str, model=None,
                maximize: Optional[bool] = None) -> bool:
    """Early stopping's direction for ``metric``: ``maximize`` if given,
    else the ``maximize`` of ``model``'s metric object of that name, else
    (a custom metric) whether its base name is in ``_MAXIMIZE_METRICS``."""
    if maximize is not None:
        return maximize
    found = (model.metric_maximize(metric)
             if hasattr(model, "metric_maximize") else None)
    if found is not None:
        return found
    return metric.split("@")[0] in _MAXIMIZE_METRICS


class EarlyStopping(TrainingCallback):
    """Stop when the watched metric (by default the last metric of the last
    data set) has not improved by more than ``min_delta`` for ``rounds``
    rounds; ``save_best`` returns the model cut after the best round."""

    def __init__(self, rounds: int, metric_name: Optional[str] = None,
                 data_name: Optional[str] = None,
                 maximize: Optional[bool] = None, save_best: bool = False,
                 min_delta: float = 0.0):
        self.rounds = rounds
        self.metric_name = metric_name
        self.data_name = data_name
        self.maximize = maximize
        self.save_best = save_best
        self.min_delta = min_delta
        self.current_rounds = 0
        self.best_scores: List[float] = []

    def before_training(self, model):
        self.current_rounds = 0
        self.best_scores = []
        return model

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if not evals_log:
            return False
        data_name = self.data_name or list(evals_log.keys())[-1]
        metrics = evals_log[data_name]
        metric_name = self.metric_name or list(metrics.keys())[-1]
        score = metrics[metric_name][-1]
        if not self.best_scores:
            improved = True
        elif is_maximize(metric_name, model, self.maximize):
            improved = score > self.best_scores[-1] + self.min_delta
        else:
            improved = score < self.best_scores[-1] - self.min_delta
        if improved:
            self.best_scores.append(score)
            self.current_rounds = 0
            model.set_attr(best_iteration=str(epoch),
                           best_score=f"{score:.9g}")
        else:
            self.current_rounds += 1
        return self.current_rounds >= self.rounds

    def after_training(self, model):
        if self.save_best and model.best_iteration is not None:
            model = model[: model.best_iteration + 1]
        return model


class EvaluationMonitor(TrainingCallback):
    """Print the latest history line every ``period`` rounds (and the last
    one at the end), each value with 5 decimals."""

    def __init__(self, rank: int = 0, period: int = 1,
                 show_stdv: bool = False):
        self.period = period
        self.rank = rank
        self.show_stdv = show_stdv
        self._latest: Optional[str] = None

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if not evals_log:
            return False
        msg = f"[{epoch}]"
        for dname, metrics in evals_log.items():
            for mname, vals in metrics.items():
                if isinstance(vals[-1], tuple):
                    mean, std = vals[-1]
                    msg += f"\t{dname}-{mname}:{mean:.5f}" + (
                        f"+{std:.5f}" if self.show_stdv else "")
                else:
                    msg += f"\t{dname}-{mname}:{vals[-1]:.5f}"
        if epoch % self.period == 0:
            print(msg, flush=True)
            self._latest = None
        else:
            self._latest = msg
        return False

    def after_training(self, model):
        if self._latest is not None:
            print(self._latest, flush=True)
        return model


class TrainingTelemetry(TrainingCallback):
    """Record per-round training telemetry into the metrics registry
    (``observability.REGISTRY`` unless one is passed; the JAX package's
    ``TrainingTelemetry``). Per round:

    - ``round_seconds`` (histogram): wall time of update and eval;
    - ``trees_total`` (gauge): trees in the model so far;
    - ``tree_depth`` / ``tree_leaves`` (gauges): the shape of the round's
      last tree, and ``split_gain`` (histogram): the loss change of each of
      its splits. This copies the last tree to the host (a device
      synchronization): that is this callback's cost, and why it is opt-in
      rather than built into ``train``;
    - ``eval_score{data=,metric=}`` (gauges): the latest eval values;

    plus a ``round`` instant on the active trace. Telemetry never breaks
    training: a failed introspection (a linear model has no trees) is
    swallowed."""

    def __init__(self, registry=None):
        from .observability import REGISTRY

        self.registry = registry if registry is not None else REGISTRY
        self._t0: Optional[float] = None

    def before_iteration(self, model, epoch: int, evals_log) -> bool:
        self._t0 = time.perf_counter()
        return False

    def _record_tree_stats(self, model) -> None:
        gbm = getattr(model, "_gbm", None)
        last = gbm.model.last_tree()
        if last is None:
            return
        reg = self.registry
        reg.gauge("trees_total", "Trees committed to the model").set(
            gbm.model.num_trees)
        reg.gauge("tree_depth", "Depth of the last committed tree").set(
            last.max_depth())
        reg.gauge("tree_leaves", "Leaves of the last committed tree").set(
            int(np.count_nonzero(last.left_children == -1)))
        gain = reg.histogram(
            "split_gain", "Loss change of committed splits",
            buckets=(0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0,
                     10000.0))
        internal = last.left_children != -1
        for g in last.loss_changes[internal]:
            gain.observe(float(g))

    def after_iteration(self, model, epoch: int, evals_log) -> bool:
        from .observability import trace

        reg = self.registry
        if self._t0 is not None:
            reg.histogram(
                "round_seconds", "Wall time per boosting round",
            ).observe(time.perf_counter() - self._t0)
            self._t0 = None
        try:
            self._record_tree_stats(model)
        except Exception:  # introspection must never fail training
            pass
        for dname, metrics in (evals_log or {}).items():
            for mname, vals in metrics.items():
                if vals:
                    v = vals[-1]
                    if isinstance(v, tuple):  # cv: (mean, std)
                        v = v[0]
                    reg.gauge(
                        "eval_score", "Latest eval metric value",
                    ).labels(data=dname, metric=mname).set(float(v))
        trace.instant("round", epoch=epoch)
        return False


class FlightRecorderMonitor(TrainingCallback):
    """A live window onto the flight recorder (the JAX package's
    ``FlightRecorderMonitor``): after every round the latest completed
    record (wall time, ``grow`` / ``eval`` stage seconds, collective
    deltas, memory peaks; ``observability/flight.py``) lands in
    ``self.latest`` and goes to ``on_record`` if given. The recorder is
    always on; this callback only reads it::

        mon = FlightRecorderMonitor(
            on_record=lambda r: print(r["round"], r["wall_s"]))
        train(params, dtrain, 100, callbacks=[mon])
        mon.records()   # every record still in the ring
    """

    def __init__(self, on_record: Optional[Callable[[dict], None]] = None):
        self.on_record = on_record
        self.latest: Optional[dict] = None

    def after_iteration(self, model, epoch: int, evals_log) -> bool:
        from .observability import flight

        # the loop's end_round() runs after the callbacks: the freshest
        # complete record is the previous round's; after_training picks
        # up the last one
        rec = flight.RECORDER.last()
        if rec is not None and rec is not self.latest:
            self.latest = rec
            if self.on_record is not None:
                self.on_record(rec)
        return False

    def after_training(self, model):
        self.after_iteration(model, -1, None)
        return model

    def records(self) -> List[dict]:
        from .observability import flight

        return flight.RECORDER.records()


class TrainingCheckPoint(TrainingCallback):
    """Save the model every ``interval`` rounds as
    ``{directory}/{name}_{epoch}.json`` (or ``.pkl`` with ``as_pickle``)."""

    def __init__(self, directory: str, name: str = "model",
                 as_pickle: bool = False, interval: int = 100):
        self.directory = directory
        self.name = name
        self.as_pickle = as_pickle
        self.interval = max(1, interval)
        self._epoch = 0

    def after_iteration(self, model, epoch, evals_log) -> bool:
        self._epoch += 1
        if self._epoch % self.interval == 0:
            ext = "pkl" if self.as_pickle else "json"
            path = os.path.join(self.directory, f"{self.name}_{epoch}.{ext}")
            if self.as_pickle:
                with open(path, "wb") as f:
                    pickle.dump(model, f)
            else:
                model.save_model(path)
        return False
