"""Booster: the API core (train one round, evaluate, predict, model IO).

The port of the JAX package's ``learner.py`` (reference ``src/learner.cc``:
``UpdateOneIter`` :1060, ``EvalOneIter`` :1105, JSON model IO :659-994).
A Booster lives on one device (the CUDA card unless ``device="cpu"``);
every DMatrix it trains on or predicts must be on the same device. The
model JSON is the XGBoost schema the JAX package writes, so models carry
across in both directions.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ._device import resolve_device
from .data.dmatrix import DMatrix
from .gbm import GBTree
from .metric import create_metric
from .objective import create_objective
from .params import LearnerParam
from .predictor import predict_margin

__all__ = ["Booster"]

_VERSION = [2, 0, 0]


class _PredCache:
    """Margin of one DMatrix and how many trees it already holds
    (reference PredictionContainer, include/xgboost/predictor.h:242)."""

    def __init__(self) -> None:
        self.margin: Optional[torch.Tensor] = None  # [n, K]
        self.num_trees: int = 0


class Booster:
    """A trained (or training) gradient-boosted model."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 cache: Sequence[DMatrix] = (),
                 model_file: Optional[Union[str, bytes, os.PathLike]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.lparam = LearnerParam()
        self._extra_params: Dict[str, Any] = {}
        self._gbm: Optional[GBTree] = None
        self._obj = None
        self._metrics: List = []
        self._base_margin_val = 0.0
        self._caches: Dict[int, _PredCache] = {}
        self._cache_refs: Dict[int, DMatrix] = {}
        self._loaded_num_feature = 0
        if params:
            params = dict(params)
            params.pop("device", None)  # the device is the constructor's
            self._extra_params.update(self.lparam.update(params))
        for d in cache:
            self._caches[id(d)] = _PredCache()
            self._cache_refs[id(d)] = d
        if model_file is not None:
            self.load_model(model_file)

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def _configure(self) -> None:
        if self.lparam.booster != "gbtree":
            raise NotImplementedError(
                f"booster={self.lparam.booster!r} is not ported yet")
        if self.lparam.num_class > 1:
            raise NotImplementedError("multiclass is not ported yet")
        if self._obj is None:
            self._obj = create_objective(self.lparam.objective, self.lparam)
        if self._gbm is None:
            self._gbm = GBTree(self._obj.n_targets(), self._extra_params,
                               self.device)
        base = self.lparam.base_score
        if base is None:
            base = self._obj.default_base_score()
        self._base_margin_val = float(self._obj.prob_to_margin(float(base)))

    @property
    def n_groups(self) -> int:
        self._configure()
        return self._gbm.n_groups

    def _check_device(self, dmat: DMatrix) -> None:
        if dmat.device != self.device:
            raise ValueError(f"DMatrix is on {dmat.device}, Booster on "
                             f"{self.device}; build both on one device")

    # ------------------------------------------------------------------
    # margins & caches
    # ------------------------------------------------------------------
    def _base_margin_for(self, dmat: DMatrix) -> torch.Tensor:
        n, K = dmat.num_row(), self.n_groups
        if dmat.base_margin is not None and dmat.base_margin.numel():
            return dmat.base_margin.reshape(n, K)
        return torch.full((n, K), self._base_margin_val, dtype=torch.float32,
                          device=self.device)

    def _predict_margin(self, dmat: DMatrix) -> torch.Tensor:
        """[n, K] margin with the prediction cache: only trees not yet
        folded into a cached margin are walked (gbtree.cc:519)."""
        self._configure()
        self._check_device(dmat)
        model = self._gbm.model
        cur = model.num_trees
        entry = self._caches.get(id(dmat))
        if entry is not None and entry.margin is not None \
                and entry.num_trees == cur:
            return entry.margin
        if entry is not None and entry.margin is not None \
                and entry.num_trees < cur:
            sub = model.stacked_slice(entry.num_trees, cur)
            zero = torch.zeros_like(entry.margin)
            margin = entry.margin + predict_margin(sub, dmat.data, zero)
        else:
            margin = predict_margin(model.stacked(), dmat.data,
                                    self._base_margin_for(dmat))
        if entry is not None:
            entry.margin, entry.num_trees = margin, cur
        return margin

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def update(self, dtrain: DMatrix, iteration: int) -> None:
        """One boosting iteration (reference UpdateOneIter learner.cc:1060)."""
        self._configure()
        self._check_device(dtrain)
        self._caches.setdefault(id(dtrain), _PredCache())
        self._cache_refs.setdefault(id(dtrain), dtrain)
        margin = self._predict_margin(dtrain)
        m = margin[:, 0] if self.n_groups == 1 else margin
        label = (dtrain.label if dtrain.label is not None
                 else torch.zeros(dtrain.num_row(), device=self.device))
        grad, hess = self._obj.get_gradient(m, label, dtrain.weight, iteration)
        binned = dtrain.get_binned(self._gbm.train_param.max_bin)
        entry = self._caches[id(dtrain)]
        _, entry.margin = self._gbm.boost_one_round(binned, grad, hess, margin)
        entry.num_trees = self._gbm.model.num_trees

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _resolve_metrics(self) -> List:
        self._configure()
        if not self._metrics:
            names = list(self.lparam.eval_metric)
            if not names and not self.lparam.disable_default_eval_metric:
                names = [self._obj.default_metric()]
            self._metrics = [create_metric(n) for n in names]
        return self._metrics

    def eval_values(self, evals, iteration: int = 0) -> Dict[str, Dict[str, float]]:
        """{data name: {metric name: value}} for one round."""
        self._configure()
        out: Dict[str, Dict[str, float]] = {}
        for dmat, name in evals:
            margin = self._predict_margin(dmat)
            preds = self._obj.eval_transform(
                margin[:, 0] if self.n_groups == 1 else margin)
            label = (dmat.label if dmat.label is not None
                     else torch.zeros(dmat.num_row(), device=self.device))
            out[name] = {m.name: m.evaluate(preds, label, dmat.weight)
                         for m in self._resolve_metrics()}
        return out

    def eval_set(self, evals, iteration: int = 0) -> str:
        parts = [f"[{iteration}]"]
        for name, vals in self.eval_values(evals, iteration).items():
            parts.extend(f"{name}-{k}:{v:.6f}" for k, v in vals.items())
        return "\t".join(parts)

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def predict(self, data: DMatrix, output_margin: bool = False) -> np.ndarray:
        self._configure()
        self._check_device(data)
        margin = self._predict_margin(data)
        out = margin if output_margin else self._obj.pred_transform(
            margin[:, 0] if self.n_groups == 1 else margin)
        out = out.cpu().numpy()
        if out.ndim == 2 and out.shape[1] == 1:
            out = out[:, 0]
        return out

    # ------------------------------------------------------------------
    # model IO (XGBoost JSON schema, doc/model.schema)
    # ------------------------------------------------------------------
    def _num_feature(self) -> int:
        for d in self._cache_refs.values():
            return d.num_col()
        if self._loaded_num_feature:
            return self._loaded_num_feature
        trees = self._gbm.model.trees if self._gbm is not None else []
        return int(max((t.split_indices.max(initial=0) for t in trees),
                       default=-1) + 1)

    def save_json(self) -> dict:
        self._configure()
        learner = {
            "feature_names": [],
            "feature_types": [],
            "learner_model_param": {
                "base_score": str(self.lparam.base_score
                                  if self.lparam.base_score is not None
                                  else self._obj.default_base_score()),
                "num_class": str(self.lparam.num_class),
                "num_feature": str(self._num_feature()),
            },
            "objective": {"name": self._obj.name},
            "gradient_booster": self._gbm.save_json(),
            "attributes": {},
        }
        return {"version": _VERSION, "learner": learner}

    def save_raw(self, raw_format: str = "json") -> bytes:
        if raw_format != "json":
            raise NotImplementedError("only the JSON model format is ported")
        return json.dumps(self.save_json()).encode()

    def save_model(self, fname: Union[str, os.PathLike]) -> None:
        with open(fname, "w") as f:
            json.dump(self.save_json(), f)

    def load_json(self, j: dict) -> None:
        learner = j["learner"]
        lmp = learner["learner_model_param"]
        gb = learner["gradient_booster"]
        self.lparam.update({
            "base_score": float(lmp["base_score"]),
            "num_class": int(lmp.get("num_class", 0)),
            "objective": learner["objective"]["name"],
            "booster": gb.get("name", "gbtree"),
        })
        self._obj = None
        self._gbm = None
        self._configure()
        self._gbm.load_json(gb)
        self._loaded_num_feature = int(lmp.get("num_feature", 0) or 0)
        self._caches.clear()

    def load_model(self, fname: Union[str, bytes, bytearray, os.PathLike]) -> None:
        if isinstance(fname, (bytes, bytearray)):
            self.load_json(json.loads(bytes(fname).decode()))
            return
        with open(fname) as f:
            self.load_json(json.load(f))
