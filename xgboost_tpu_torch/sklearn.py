"""scikit-learn style estimators (the port of the JAX package's
``sklearn.py``; reference ``python-package/xgboost/sklearn.py``: ``XGBModel``
:451, ``XGBClassifier`` / ``XGBRegressor`` / ``XGBRanker`` / ``XGBRF*``
:1231-1621).

Every estimator takes ``device``, as every entry point of the port does:
the CUDA card by default (raising at ``fit`` where there is none), ``"cpu"``
for the plain versions. It goes to the DMatrix the estimator builds and to
a loaded Booster, never into the booster parameters. ``random_state``
becomes ``seed``, which stays at the learner as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .data.dmatrix import DMatrix
from .learner import Booster
from .training import train as _train

__all__ = ["XGBModel", "XGBRegressor", "XGBClassifier", "XGBRanker",
           "XGBRFRegressor", "XGBRFClassifier"]


class XGBModel:
    """Base estimator: ``get_params`` / ``set_params`` / ``fit`` /
    ``predict`` over ``train`` and a Booster."""

    _estimator_type = "regressor"

    def __init__(
        self,
        max_depth: Optional[int] = None,
        learning_rate: Optional[float] = None,
        n_estimators: int = 100,
        objective: Optional[str] = None,
        booster: Optional[str] = None,
        tree_method: Optional[str] = None,
        gamma: Optional[float] = None,
        min_child_weight: Optional[float] = None,
        max_delta_step: Optional[float] = None,
        subsample: Optional[float] = None,
        colsample_bytree: Optional[float] = None,
        colsample_bylevel: Optional[float] = None,
        colsample_bynode: Optional[float] = None,
        reg_alpha: Optional[float] = None,
        reg_lambda: Optional[float] = None,
        scale_pos_weight: Optional[float] = None,
        base_score: Optional[float] = None,
        random_state: Optional[int] = None,
        missing: float = np.nan,
        num_parallel_tree: Optional[int] = None,
        monotone_constraints: Optional[Union[str, Sequence[int]]] = None,
        interaction_constraints: Optional[
            Union[str, Sequence[Sequence[int]]]] = None,
        importance_type: Optional[str] = None,
        eval_metric: Optional[Union[str, List[str], Callable]] = None,
        early_stopping_rounds: Optional[int] = None,
        max_bin: Optional[int] = None,
        verbosity: Optional[int] = None,
        n_jobs: Optional[int] = None,
        device: Optional[str] = None,
        **kwargs: Any,
    ):
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.objective = objective
        self.booster = booster
        self.tree_method = tree_method
        self.gamma = gamma
        self.min_child_weight = min_child_weight
        self.max_delta_step = max_delta_step
        self.subsample = subsample
        self.colsample_bytree = colsample_bytree
        self.colsample_bylevel = colsample_bylevel
        self.colsample_bynode = colsample_bynode
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.scale_pos_weight = scale_pos_weight
        self.base_score = base_score
        self.random_state = random_state
        self.missing = missing
        self.num_parallel_tree = num_parallel_tree
        self.monotone_constraints = monotone_constraints
        self.interaction_constraints = interaction_constraints
        self.importance_type = importance_type
        self.eval_metric = eval_metric
        self.early_stopping_rounds = early_stopping_rounds
        self.max_bin = max_bin
        self.verbosity = verbosity
        self.n_jobs = n_jobs
        self.device = device
        self.kwargs = kwargs
        self._Booster: Optional[Booster] = None

    # -- sklearn protocol --
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        out = {k: v for k, v in self.__dict__.items()
               if not k.startswith("_") and k != "kwargs"}
        out.update(self.kwargs)
        return out

    def set_params(self, **params: Any) -> "XGBModel":
        for k, v in params.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self.kwargs[k] = v
        return self

    def get_xgb_params(self) -> Dict[str, Any]:
        """The booster parameters: every parameter set, without the
        estimator's own (``n_estimators``, ``missing``, ``device``, ...);
        ``random_state`` as ``seed``."""
        skip = {"n_estimators", "missing", "importance_type", "kwargs",
                "early_stopping_rounds", "eval_metric", "random_state",
                "device"}
        params = {k: v for k, v in self.get_params().items()
                  if k not in skip and v is not None}
        if self.random_state is not None:
            params["seed"] = self.random_state
        if self.eval_metric is not None and not callable(self.eval_metric):
            params["eval_metric"] = self.eval_metric
        return params

    def _make_dmatrix(self, X, y=None, sample_weight=None, base_margin=None,
                      group=None, qid=None) -> DMatrix:
        return DMatrix(X, label=y, weight=sample_weight,
                       base_margin=base_margin, missing=self.missing,
                       group=group, qid=qid, device=self.device)

    def fit(self, X, y, sample_weight=None, base_margin=None,
            eval_set: Optional[Sequence[Tuple]] = None, verbose: bool = False,
            xgb_model: Optional[Booster] = None, sample_weight_eval_set=None,
            base_margin_eval_set=None, callbacks=None) -> "XGBModel":
        dtrain = self._make_dmatrix(X, y, sample_weight, base_margin)
        evals = []
        for i, (ex, ey) in enumerate(eval_set or ()):
            w = sample_weight_eval_set[i] if sample_weight_eval_set else None
            bm = base_margin_eval_set[i] if base_margin_eval_set else None
            evals.append((self._make_dmatrix(ex, ey, w, bm),
                          f"validation_{i}"))
        self.evals_result_: Dict = {}
        feval = self.eval_metric if callable(self.eval_metric) else None
        self._Booster = _train(
            self.get_xgb_params(), dtrain, num_boost_round=self.n_estimators,
            evals=evals, early_stopping_rounds=self.early_stopping_rounds,
            evals_result=self.evals_result_, verbose_eval=verbose,
            xgb_model=xgb_model, callbacks=callbacks, custom_metric=feval)
        return self

    def predict(self, X, output_margin: bool = False,
                validate_features: bool = True, base_margin=None,
                iteration_range: Optional[Tuple[int, int]] = None
                ) -> np.ndarray:
        """Tree boosters predict a numpy array through ``inplace_predict``
        (no DMatrix); anything else through a DMatrix on the estimator's
        device."""
        b = self.get_booster()
        if b._gbm.name in ("gbtree", "dart") and isinstance(X, np.ndarray):
            return b.inplace_predict(
                X, iteration_range=iteration_range,
                predict_type="margin" if output_margin else "value",
                missing=self.missing, base_margin=base_margin)
        d = self._make_dmatrix(X, base_margin=base_margin)
        return b.predict(d, output_margin=output_margin,
                         validate_features=validate_features,
                         iteration_range=iteration_range)

    def apply(self, X, iteration_range=None) -> np.ndarray:
        """[n, T] leaf ids of every tree (``pred_leaf``)."""
        return self.get_booster().predict(self._make_dmatrix(X),
                                          pred_leaf=True)

    def get_booster(self) -> Booster:
        if self._Booster is None:
            raise ValueError("need to call fit first")
        return self._Booster

    def evals_result(self) -> Dict:
        """The evaluation history recorded by ``fit``."""
        return getattr(self, "evals_result_", {})

    def get_num_boosting_rounds(self) -> int:
        return self.n_estimators

    def _linear_weights(self) -> np.ndarray:
        gbm = self.get_booster()._gbm
        if gbm.name != "gblinear" or gbm.weights is None:
            raise AttributeError(
                "coef_/intercept_ are only defined for booster='gblinear'")
        return gbm.host_weights()  # [F+1, K], bias last

    @property
    def coef_(self) -> np.ndarray:
        """[F] (or [K, F]) linear coefficients."""
        w = self._linear_weights()[:-1]
        return w[:, 0] if w.shape[1] == 1 else w.T

    @property
    def intercept_(self) -> np.ndarray:
        """[K] linear biases."""
        return self._linear_weights()[-1]

    def save_model(self, fname: str) -> None:
        self.get_booster().save_model(fname)

    def load_model(self, fname: str) -> None:
        self._Booster = Booster(model_file=fname, device=self.device)

    @property
    def feature_importances_(self) -> np.ndarray:
        """[F] float32 importances summing to 1 (where any is positive):
        ``importance_type``, by default ``"weight"`` for gblinear (its only
        one) and ``"gain"`` for trees (reference sklearn.py:1142)."""
        b = self.get_booster()
        itype = self.importance_type or (
            "weight" if self.booster == "gblinear" else "gain")
        score = b.get_score(importance_type=itype)
        names = [f"f{i}" for i in range(b.num_features())]
        for d in b._cache_refs.values():
            names = d.feature_names or names
            break
        arr = np.array([score.get(nm, 0.0) for nm in names], np.float32)
        total = arr.sum()
        return arr / total if total > 0 else arr

    @property
    def best_iteration(self) -> Optional[int]:
        return self.get_booster().best_iteration

    @property
    def best_score(self) -> Optional[float]:
        return self.get_booster().best_score

    def score(self, X, y, sample_weight=None) -> float:
        """The coefficient of determination R^2 of ``predict(X)``."""
        pred = self.predict(X)
        y = np.asarray(y, dtype=np.float64)
        sw = sample_weight if sample_weight is not None else 1
        u = ((y - pred) ** 2 * sw).sum()
        v = ((y - np.average(y, weights=sample_weight)) ** 2 * sw).sum()
        return 1.0 - u / v if v > 0 else 0.0


class XGBRegressor(XGBModel):
    def __init__(self, *, objective: str = "reg:squarederror",
                 **kwargs: Any):
        super().__init__(objective=objective, **kwargs)


class XGBClassifier(XGBModel):
    """Labels of any sortable kind, encoded as their rank in ``classes_``;
    more than two classes train ``multi:softprob`` (unless another
    ``multi:`` objective is set) with ``num_class``."""

    _estimator_type = "classifier"

    def __init__(self, *, objective: str = "binary:logistic", **kwargs: Any):
        super().__init__(objective=objective, **kwargs)

    def fit(self, X, y, **kwargs) -> "XGBClassifier":
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        self.n_classes_ = len(self.classes_)
        y_enc = np.searchsorted(self.classes_, y).astype(np.float32)
        if self.n_classes_ > 2:
            if not str(self.objective).startswith("multi:"):
                self.objective = "multi:softprob"
            self.kwargs["num_class"] = self.n_classes_
        super().fit(X, y_enc, **kwargs)
        return self

    def predict(self, X, output_margin=False, **kwargs) -> np.ndarray:
        raw = super().predict(X, output_margin=output_margin, **kwargs)
        if output_margin:
            return raw
        if raw.ndim == 2:  # softprob
            return self.classes_[np.argmax(raw, axis=1)]
        if self.objective == "multi:softmax":
            return self.classes_[raw.astype(int)]
        return self.classes_[(raw > 0.5).astype(int)]

    def predict_proba(self, X, **kwargs) -> np.ndarray:
        """[n, n_classes] probabilities."""
        raw = super().predict(X, **kwargs)
        if raw.ndim == 2:
            return raw
        return np.stack([1.0 - raw, raw], axis=1)

    def score(self, X, y, sample_weight=None) -> float:
        """Accuracy (weighted by ``sample_weight``)."""
        ok = (self.predict(X) == np.asarray(y)).astype(np.float64)
        if sample_weight is not None:
            return float((ok * sample_weight).sum() / np.sum(sample_weight))
        return float(ok.mean())


class XGBRanker(XGBModel):
    """Learning to rank: ``fit`` needs the query groups, as ``group``
    sizes or a ``qid`` per row."""

    _estimator_type = "ranker"

    def __init__(self, *, objective: str = "rank:ndcg", **kwargs: Any):
        super().__init__(objective=objective, **kwargs)

    def fit(self, X, y, *, group=None, qid=None, sample_weight=None,
            eval_set=None, eval_group=None, eval_qid=None, verbose=False,
            **kwargs) -> "XGBRanker":
        if group is None and qid is None:
            raise ValueError("XGBRanker requires group or qid")
        dtrain = self._make_dmatrix(X, y, sample_weight, group=group,
                                    qid=qid)
        evals = []
        for i, (ex, ey) in enumerate(eval_set or ()):
            g = eval_group[i] if eval_group else None
            q = eval_qid[i] if eval_qid else None
            evals.append((self._make_dmatrix(ex, ey, group=g, qid=q),
                          f"validation_{i}"))
        self.evals_result_: Dict = {}
        self._Booster = _train(
            self.get_xgb_params(), dtrain, num_boost_round=self.n_estimators,
            evals=evals, early_stopping_rounds=self.early_stopping_rounds,
            evals_result=self.evals_result_, verbose_eval=verbose)
        return self


def _fit_one_round(est, base, X, y, **kwargs):
    """``base.fit`` as one round of ``n_estimators`` parallel trees."""
    n = est.n_estimators
    est.n_estimators = 1
    try:
        est.kwargs["num_parallel_tree"] = n
        base.fit(est, X, y, **kwargs)
    finally:
        est.n_estimators = n
    return est


class XGBRFRegressor(XGBRegressor):
    """A random forest at the reference's defaults, in one round. As in
    the JAX package, ``fit`` grows one tree: ``get_xgb_params`` sets
    ``num_parallel_tree`` from ``n_estimators``, which ``fit`` has set to 1
    for the round."""

    def __init__(self, *, learning_rate: float = 1.0, subsample: float = 0.8,
                 colsample_bynode: float = 0.8, reg_lambda: float = 1e-5,
                 **kwargs: Any):
        super().__init__(learning_rate=learning_rate, subsample=subsample,
                         colsample_bynode=colsample_bynode,
                         reg_lambda=reg_lambda, **kwargs)

    def get_xgb_params(self) -> Dict[str, Any]:
        p = super().get_xgb_params()
        p["num_parallel_tree"] = self.n_estimators
        return p

    def fit(self, X, y, **kwargs):
        return _fit_one_round(self, XGBRegressor, X, y, **kwargs)


class XGBRFClassifier(XGBClassifier):
    """A random forest classifier: one round of ``n_estimators`` parallel
    trees at the reference's defaults."""

    def __init__(self, *, learning_rate: float = 1.0, subsample: float = 0.8,
                 colsample_bynode: float = 0.8, reg_lambda: float = 1e-5,
                 **kwargs: Any):
        super().__init__(learning_rate=learning_rate, subsample=subsample,
                         colsample_bynode=colsample_bynode,
                         reg_lambda=reg_lambda, **kwargs)

    def fit(self, X, y, **kwargs):
        return _fit_one_round(self, XGBClassifier, X, y, **kwargs)
