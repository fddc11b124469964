"""Booster: the API core (train one round, evaluate, predict, model IO).

The port of the JAX package's ``learner.py`` (reference ``src/learner.cc``:
``UpdateOneIter`` :1060, ``BoostOneIter`` :1088, ``EvalOneIter`` :1105,
JSON model IO :659-994, ``Learner::Slice``). A Booster lives on one device
(the CUDA card unless ``device="cpu"``); every DMatrix it trains on or
predicts must be on the same device, and a pickled or copied Booster comes
back on the device it was made for (raising where that device is absent).
The model JSON is the XGBoost schema the JAX package writes, feature names,
types, attributes, ``num_class`` and the objective included, so models
carry across in both directions. With K output groups (``num_class``) a
round grows K x ``num_parallel_tree`` trees and margins are ``[n, K]``.
``booster="dart"`` walks every forest with its tree weights and keeps no
prediction cache; ``booster="gblinear"`` trains on the raw rows (no bins)
and recomputes its margins, as the JAX package does. SHAP
(``pred_contribs``, ``approx_contribs``, ``pred_interactions``) runs in
``interpret.py`` on the data's device.

Inside ``parallel.mesh_context(mesh)`` each rank trains on its own rows:
every tree grows over the row group (``parallel/grow.py``), the quantized
matrix is sketched over it (``parallel/sketch.py``) and every metric is
reduced over it, so the ranks hold the same model and stop at the same
round. Only the JAX package's multi-process envelope trains there
(``_check_group_envelope``); without a ``mesh_context`` a multi-process
program trains and evaluates purely locally.
"""

from __future__ import annotations

import copy as _copy
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ._device import resolve_device
from .data.dmatrix import DMatrix
from .data.sparse import CSRStorage
from .gbm import Dart, GBLinear, GBTree
from .gbm.gbtree import GROUP_ENVELOPE
from .metric import create_metric
from .objective import create_objective
from .observability import REGISTRY as _REGISTRY
from .observability import flight as _flight
from .observability import kernelprof as _kernelprof
from .observability import trace as _trace
from .params import LearnerParam, check_ported, known_keys
from .parallel.mesh import current_mesh
from .predictor import StackedForest, predict_leaf, predict_margin
from .predictor.serving import predict_serving
from .predictor.serving import row_blocks as _row_blocks
from .pipeline import RoundPipeline, completion_probe
from .utils import Monitor, fault, observer

__all__ = ["Booster"]

_VERSION = [2, 0, 0]
_BOOSTERS = {"gbtree": GBTree, "dart": Dart, "gblinear": GBLinear}


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
        # (num_trees, rounds) -> (StackedForest, tree weights) for
        # inplace_predict: an LRU of 4, cleared where the leaves change
        # under the same tree count (``_forest_snapshot``)
        self._forest_snapshots: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._forest_snapshots_lock = threading.Lock()
        self._loaded_num_feature = 0
        self._loaded_feature_names: List[str] = []
        self._loaded_feature_types: List[str] = []
        self.attributes_: Dict[str, str] = {}
        self.monitor = Monitor("Booster")
        # update_many's in-flight window, made at its first call; not in
        # __getstate__, so a pickle or a copy starts without one
        self._pipeline = None
        if params:
            self._apply_params(params)
        for d in cache:
            self._add_cache(d)
        if model_file is not None:
            self.load_model(model_file)

    def _add_cache(self, dmat: DMatrix) -> None:
        self._caches.setdefault(id(dmat), _PredCache())
        self._cache_refs.setdefault(id(dmat), dmat)

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def _apply_params(self, params: Dict[str, Any]) -> None:
        """Learner keys go to ``lparam``, the rest to the booster. A key of
        the JAX package that the port has not ported raises unless it is
        at its neutral value; with ``validate_parameters`` a key no
        component knows raises ValueError (the JAX package's
        ``_validate_unknown``, reference learner.cc:351). ``seed`` stays
        at the learner, as in the JAX package: the tree samplers see it
        only when ``set_param`` gives it to a configured booster."""
        params = dict(params)
        params.pop("device", None)  # the device is the constructor's
        if params.get("booster", "gbtree") not in _BOOSTERS:
            raise NotImplementedError(
                f"booster={params['booster']!r} is not ported yet")
        unknown = self.lparam.update(params)
        check_ported(unknown)
        self._extra_params.update(unknown)
        # read by the tree parameters and by count:poisson alike: the
        # learner keeps it and forwards it (the JAX package's rule)
        if "max_delta_step" in params:
            self._extra_params["max_delta_step"] = params["max_delta_step"]
        if self.lparam.validate_parameters:
            known = known_keys()
            bad = [k for k in self._extra_params if k not in known]
            if bad:
                raise ValueError(f"Unknown parameters: {bad}")

    def set_param(self, params, value=None) -> None:
        """Set parameters between rounds: ``set_param("eta", 0.1)``, a dict
        or a list of pairs. The booster's tree parameters change for the
        next tree; the objective is not re-created (as in the JAX
        package)."""
        if isinstance(params, str):
            params = {params: value}
        params = dict(params)
        self._apply_params(params)
        if self._gbm is not None:
            for k, v in params.items():
                if k != "device":
                    self._gbm.set_param(k, v)
            if self._obj is not None:
                self._obj.params = self.lparam
        self._metrics = []  # re-resolved at the next eval

    def _configure(self) -> None:
        if self.lparam.booster not in _BOOSTERS:
            raise NotImplementedError(
                f"booster={self.lparam.booster!r} is not ported yet")
        if self._obj is None:
            self._obj = create_objective(self.lparam.objective, self.lparam)
        if self._gbm is None:
            self._gbm = _BOOSTERS[self.lparam.booster](
                self._obj.n_targets(), self._extra_params, self.device)
        base = self.lparam.base_score
        if base is None:
            base = self._obj.default_base_score()
        self._base_margin_val = float(self._obj.prob_to_margin(float(base)))

    @property
    def n_groups(self) -> int:
        self._configure()
        return self._gbm.n_groups

    @property
    def _per_round(self) -> int:
        """Trees per boosting round: output groups x parallel trees."""
        return self.n_groups * self._gbm.gbtree_param.num_parallel_tree

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

    def _data_blocks(self, dmat: DMatrix, blk: int = 65536):
        """``(lo, hi, X)`` over a matrix's rows, ``X`` [hi-lo, F] float32
        on the matrix's device, without making its whole dense ``data``
        (the JAX package's ``_data_blocks``): a disk-paged matrix page by
        page (each bin's cut midpoint, ``PagedBins.device_float_page``;
        reference ``cpu_predictor.cc:266``), a CSR-backed one in row blocks
        of ``blk`` made dense on the host, any other whole."""
        n = dmat.num_row()
        paged = getattr(dmat, "_paged", None)
        if paged is not None:
            self._warn_foreign_paged(dmat, paged)
            for k in range(paged.n_pages):
                lo = k * paged.page_rows
                yield lo, lo + paged.rows_of(k), paged.device_float_page(
                    k, dmat.device)
        elif dmat._csr_only():
            yield from _row_blocks(dmat._sparse, dmat.device, blk)
        else:
            yield 0, n, dmat.data

    def _walk(self, forest: StackedForest, dmat: DMatrix,
              base: torch.Tensor, tw: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """``predict_margin`` over ``_data_blocks(dmat)``, concatenated
        (``base`` itself for a forest of no trees: no block is made)."""
        if forest.num_trees == 0:
            return base
        parts = [predict_margin(forest, X, base[lo:hi], tw)
                 for lo, hi, X in self._data_blocks(dmat)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _warn_foreign_paged(self, dmat: DMatrix, paged) -> None:
        """Page-streamed rows are their bins' cut midpoints, which route
        exactly only through split conditions drawn from the same cuts. A
        booster with a split condition outside the matrix's cuts for its
        feature (loaded, or trained on other data) warns, once per
        (matrix, tree count) (the JAX package's ``_warn_foreign_paged``)."""
        if self._gbm.name not in ("gbtree", "dart"):
            return
        key = (id(dmat), self._gbm.model.num_trees)
        if getattr(self, "_paged_cuts_checked", None) == key:
            return
        self._paged_cuts_checked = key
        if self._gbm.model.num_trees == 0:
            return
        forest = self._forest(None)[0]
        internal = forest.left.cpu().numpy() >= 0
        if not internal.any():
            return
        f = forest.feature.cpu().numpy()[internal].ravel()
        c = forest.cond.cpu().numpy().astype(np.float32)[internal].ravel()
        cuts = np.asarray(paged.cuts.values, np.float32)
        ok = np.zeros(f.shape[0], bool)
        for fi in np.unique(f):
            if 0 <= int(fi) < cuts.shape[0]:
                sel = f == fi
                ok[sel] = np.isin(c[sel], cuts[int(fi)])
        if not ok.all():
            import warnings

            warnings.warn(
                "predict on an external-memory matrix with a booster whose "
                f"split thresholds are not drawn from this matrix's cuts "
                f"({int((~ok).sum())}/{ok.size} internal nodes foreign): "
                "page-streamed features are reconstructed from cut "
                "midpoints, so decisions near thresholds may flip. "
                "Predict from an in-memory DMatrix for exact results.",
                UserWarning, stacklevel=4)

    def _predict_margin(self, dmat: DMatrix) -> torch.Tensor:
        """[n, K] margin with the prediction cache: only trees not yet
        folded into a cached margin are walked (gbtree.cc:519). DART walks
        every tree with its weight and caches nothing (the dropout
        reweights old trees every round). Rows are walked in
        ``_data_blocks``."""
        self._configure()
        self._check_device(dmat)
        if self._gbm.name == "gblinear":  # no cache (the JAX package's)
            return self._gbm.predict(dmat.data, self._base_margin_for(dmat))
        model = self._gbm.model
        if self._gbm.name == "dart":
            return self._walk(model.stacked(), dmat,
                              self._base_margin_for(dmat),
                              self._gbm.tree_weights())
        cur = model.num_trees
        entry = self._caches.get(id(dmat))
        if entry is not None and entry.margin is not None \
                and entry.num_trees == cur:
            return entry.margin
        if entry is not None and entry.margin is not None \
                and entry.num_trees < cur:
            sub = model.stacked_slice(entry.num_trees, cur)
            margin = entry.margin + self._walk(
                sub, dmat, torch.zeros_like(entry.margin))
        else:
            margin = self._walk(model.stacked(), dmat,
                                self._base_margin_for(dmat))
        if entry is not None:
            entry.margin, entry.num_trees = margin, cur
        return margin

    def _fill_caches_by_round(self, dtrain: DMatrix,
                              others: Sequence[DMatrix] = ()) -> None:
        """Fill a resumed booster's caches as an uninterrupted run filled
        them, so the next round's gradients (and the eval history) keep
        its bits: from the base margin, one round at a time, each step's
        walk from zeros added to the margin (``0 + leaf`` is exact). The
        training cache adds tree by tree where a group holds several trees
        a round (``num_parallel_tree > 1``), as ``boost_one_round`` does;
        an eval cache adds a round's walk, as ``_predict_margin`` does
        after each round. One walk of the whole forest (the caches'
        fill otherwise) sums the trees before adding the base, which can
        differ in the last bit. DART and refresh cache nothing across
        rounds, so they take the usual path."""
        self._configure()
        gbm = self._gbm
        if gbm.name != "gbtree" or gbm.is_update_process:
            return
        model = gbm.model
        per = self._per_round
        total = model.num_trees // per * per
        seen = set()
        for d in [dtrain, *others]:
            if id(d) in seen:
                continue
            seen.add(id(d))
            self._add_cache(d)
            step = 1 if d is dtrain and per != self.n_groups else per
            m = self._base_margin_for(d)
            for lo in range(0, total, step):
                m = m + self._walk(model.stacked_slice(lo, lo + step), d,
                                   torch.zeros_like(m))
            entry = self._caches[id(d)]
            entry.margin, entry.num_trees = m, total

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _check_group_envelope(self, dtrain: DMatrix, custom: bool) -> None:
        """Under an active row group only the JAX package's multi-process
        envelope trains (``learner.py:268-275``, ``gbtree.py:1467``):
        ``gbtree`` with one tree per output group a round, a scan-safe
        objective (the regression family and multiclass), numerical
        features, in-memory data and ``hist``, depthwise, or lossguide (the
        JAX package's ``distributed_grow_tree_lossguide``, which its
        multi-process envelope refuses). Anything else (a custom objective
        or gradients included) raises NotImplementedError, on every rank
        alike."""
        if current_mesh() is None:
            return
        gbm = self._gbm
        inside = not custom and gbm.name == "gbtree" \
            and self._obj.scan_safe \
            and gbm.gbtree_param.num_parallel_tree == 1 \
            and not (gbm.needs_exact_cuts or gbm.needs_iteration_sketch
                     or gbm.needs_local_sketch or gbm.is_update_process) \
            and not dtrain.categorical_features() \
            and getattr(dtrain, "_paged", None) is None
        if not inside:
            raise NotImplementedError(GROUP_ENVELOPE)

    def update(self, dtrain: DMatrix, iteration: int, fobj=None) -> None:
        """One boosting iteration (reference UpdateOneIter learner.cc:1060).
        With ``fobj``, ``fobj(margin, dtrain)`` gets the cached margin as
        numpy (``[n]`` for one output group) and returns ``(grad, hess)``,
        which go through ``boost``. Inside ``mesh_context`` the round grows
        over the row group (``_check_group_envelope`` first). Traced as an
        ``update`` span holding the ``GetGradient``, ``GetBinned`` and
        ``BoostOneRound`` sections (``self.monitor``), as in the JAX
        package."""
        with _trace.span("update", iteration=iteration):
            self._update(dtrain, iteration, fobj)
        _REGISTRY.counter(
            "rounds_total", "Boosting rounds dispatched").inc()

    def _update(self, dtrain: DMatrix, iteration: int, fobj) -> None:
        self._configure()
        self._check_device(dtrain)
        self._check_group_envelope(dtrain, fobj is not None)
        self._add_cache(dtrain)
        fault.begin_version(iteration)
        fault.inject("gradient")
        if fobj is not None:
            pred = self._training_margin(dtrain).cpu().numpy()
            grad, hess = fobj(pred[:, 0] if pred.shape[1] == 1 else pred,
                              dtrain)
            self.boost(dtrain, grad, hess)
            return
        with self.monitor.section("GetGradient"):
            if _kernelprof.active():  # a sampled round: bracketed
                margin, grad, hess = _kernelprof.round_seam(self.device)(
                    "gradient", -1, self._gradient, dtrain, iteration)
            else:
                margin, grad, hess = self._gradient(dtrain, iteration)
        if observer.enabled():  # off: no copy leaves the card
            observer.observe("margin", margin.cpu().numpy(), iteration)
            observer.observe("grad", grad.cpu().numpy(), iteration)
            observer.observe("hess", hess.cpu().numpy(), iteration)
        self._boost(dtrain, grad, hess, iteration)
        self.monitor.maybe_print()

    def _gradient(self, dtrain: DMatrix, iteration: int):
        """``(margin, grad, hess)`` of the round: the margin read and the
        objective's ``get_gradient`` at it."""
        margin = self._training_margin(dtrain)
        m = margin[:, 0] if self.n_groups == 1 else margin
        grad, hess = self._obj.get_gradient(
            m, self._label(dtrain), dtrain.weight, iteration,
            label_lower=dtrain.label_lower_bound,
            label_upper=dtrain.label_upper_bound, groups=dtrain.groups)
        return margin, grad, hess

    def _training_margin(self, dtrain: DMatrix) -> torch.Tensor:
        """The margin the round's gradients are taken at: the cache, or
        for DART a walk with this round's drops (drawn here)."""
        if self._gbm.name == "dart":
            forest, tw = self._gbm.training_forest()
            return self._walk(forest, dtrain, self._base_margin_for(dtrain),
                              tw)
        return self._predict_margin(dtrain)

    def _label(self, dmat: DMatrix) -> torch.Tensor:
        return (dmat.label if dmat.label is not None
                else torch.zeros(dmat.num_row(), device=self.device))

    def boost(self, dtrain: DMatrix, grad, hess) -> None:
        """One round from caller-given gradients (reference BoostOneIter
        learner.cc:1088): ``grad`` and ``hess`` (``[n]``, or ``[n, K]``)
        go to the device as float32 and through ``boost_one_round``, as
        round ``num_boosted_rounds()`` (its samplers' iteration)."""
        self._configure()
        self._check_device(dtrain)
        self._check_group_envelope(dtrain, True)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self._boost(dtrain, dev(grad), dev(hess), self.num_boosted_rounds())

    def _boost(self, dtrain: DMatrix, grad: torch.Tensor,
               hess: torch.Tensor, iteration: int) -> None:
        """One round on the method's matrix (the JAX package's
        ``_do_boost``): a refresh re-stats the existing trees and drops the
        training margin (the leaves changed under the same tree count); the
        local histmaker grows from the raw rows; ``approx`` sketches a new
        matrix from this round's hessians (summed over the output groups on
        the host, as numpy sums them); ``exact`` bins at every distinct
        value; every other method uses the cached matrix of ``max_bin``."""
        fault.inject("grow")
        gbm = self._gbm
        if gbm.name == "gblinear":  # the raw rows: no bins, no one-hot
            gbm.boost_one_round(dtrain.data, grad, hess, iteration)
            return
        self._add_cache(dtrain)
        entry = self._caches[id(dtrain)]
        if gbm.is_update_process:
            with self.monitor.section("Refresh"):
                gbm.refresh_one_round(dtrain.data, grad, hess)
            entry.margin = None
            self._forest_snapshots.clear()  # same num_trees, new leaves
            return
        model = gbm.model
        cache = entry.margin if entry.num_trees == model.num_trees else None
        fw = dtrain.feature_weights
        if gbm.needs_local_sketch:
            if gbm.name != "gbtree":
                raise NotImplementedError(
                    "grow_local_histmaker is a gbtree updater")
            if dtrain.data_is_reconstructed:
                raise NotImplementedError(
                    "grow_local_histmaker needs TRUE raw values; a "
                    "QuantileDMatrix only holds quantized bins — "
                    "construct a DMatrix instead")
            try:
                X_raw = dtrain.data  # paged matrices refuse this
            except NotImplementedError:
                raise NotImplementedError(
                    "grow_local_histmaker needs in-memory data for "
                    "per-node re-sketching") from None
            if dtrain.categorical_features():
                raise NotImplementedError(
                    "grow_local_histmaker supports numerical features "
                    "only (the reference's local maker predates "
                    "categorical support)")
            with self.monitor.section("BoostOneRound"):
                _, entry.margin = gbm.local_boost_one_round(
                    X_raw, grad, hess, cache, iteration, fw)
            entry.num_trees = model.num_trees
            return
        max_bin = gbm.train_param.max_bin
        with self.monitor.section("GetBinned"):
            if gbm.needs_iteration_sketch:
                hw = hess
                if hess.dim() == 2:  # numpy's float32 sum, as the JAX's
                    hw = torch.from_numpy(hess.cpu().numpy().sum(axis=1)
                                          ).to(hess.device)
                binned = dtrain.build_binned(max_bin, hw)
            elif gbm.needs_exact_cuts:
                binned = dtrain.get_binned_exact()
            else:
                binned = dtrain.get_binned(max_bin)
        with self.monitor.section("BoostOneRound"):
            _, entry.margin = gbm.boost_one_round(
                binned, grad, hess, cache, iteration=iteration,
                feature_weights=fw, group=current_mesh())
        entry.num_trees = model.num_trees

    def update_many(self, dtrain: DMatrix, start_iteration: int,
                    num_rounds: int, chunk: int = 25) -> None:
        """``num_rounds`` boosting rounds from ``start_iteration``: the JAX
        package's signature, as a per-round loop (the same trees as calling
        ``update`` per round). The JAX package runs ``chunk`` rounds per
        device dispatch (a ``lax.scan``); the port launches per round
        whatever ``chunk`` is. Inside ``mesh_context`` a configuration
        outside the envelope raises before the first round. The flight
        recorder keeps one record per chunk of ``chunk`` rounds, as the
        JAX package's does (nested in ``train``'s round record, it adds
        none).

        Chunks are pipelined as in the JAX package: each chunk's
        completion event is admitted to ``self._pipeline`` (a
        ``RoundPipeline``, made at the first call), so the host waits only
        when more than ``XGBTPU_PIPELINE_DEPTH`` chunks are in flight; a
        fault at that wait carries the chunk's first round
        (``.pipeline_round``) and drops the younger chunks. The window
        stays open across calls: a caller drains it
        (``bst._pipeline.drain()``) at its own boundaries. Its rounds are
        not kernel-profiled (``observability/kernelprof.py``), as the JAX
        package's scanned chunks are not."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self._configure()
        self._check_group_envelope(dtrain, False)
        if self._pipeline is None:
            self._pipeline = RoundPipeline()
        done = 0
        while done < num_rounds:
            k = min(chunk, num_rounds - done)
            first = start_iteration + done
            owned = _flight.RECORDER.begin_round(first, rounds=k)
            if owned or not _flight.enabled():
                _flight.profile_tick(first)
            try:
                t0 = time.perf_counter()
                with _kernelprof.paused():  # not profiled (the JAX scan)
                    for i in range(first, first + k):
                        self.update(dtrain, i)
                if owned:
                    _flight.note("grow", time.perf_counter() - t0)
                entry = self._caches.get(id(dtrain))
                try:
                    self._pipeline.admit(first, completion_probe(
                        entry.margin if entry is not None else None))
                except BaseException:
                    self._pipeline.abandon()  # younger chunks are dead too
                    raise
                done += k
            finally:
                _flight.RECORDER.end_round()

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
            for m in self._metrics:
                # metrics configured like the objective (aft-nloglik's
                # distribution and scale) read the learner's parameters
                m.lparam = self.lparam
        return self._metrics

    def metric_maximize(self, name: str) -> Optional[bool]:
        """Whether the metric ``name`` of this Booster is better when
        larger (early stopping's direction), or None when no metric of
        the Booster has that name (a custom metric)."""
        for m in self._resolve_metrics():
            if m.name == name:
                return bool(m.maximize)
        return None

    def eval_values(self, evals, iteration: int = 0) -> Dict[str, Dict[str, float]]:
        """{data name: {metric name: value}} for one round. The metrics see
        the objective's ``eval_transform`` of the margin (softmax
        probabilities for both multiclass objectives, the log-space score
        for ``survival:aft``), the label bounds and the query groups. On a
        sampled or traced round each set's walk and its metrics go through
        the round's seam as ``eval_walk`` and ``eval_metric``
        (``kernelprof.round_seam``)."""
        self._configure()
        out: Dict[str, Dict[str, float]] = {}
        step = _kernelprof.round_seam(self.device)
        for dmat, name in evals:
            if step is None:
                margin = self._predict_margin(dmat)
                out[name] = self._metric_values(dmat, margin)
            else:
                margin = step("eval_walk", -1, self._predict_margin, dmat)
                out[name] = step("eval_metric", -1, self._metric_values, dmat,
                                 margin)
        return out

    def _metric_values(self, dmat: DMatrix, margin: torch.Tensor
                       ) -> Dict[str, float]:
        """Every metric of the Booster on the ``eval_transform`` of
        ``dmat``'s margin, each down to its float."""
        preds = self._obj.eval_transform(
            margin[:, 0] if self.n_groups == 1 else margin)
        label = self._label(dmat)
        return {m.name: m.evaluate(
            preds, label, dmat.weight,
            label_lower=dmat.label_lower_bound,
            label_upper=dmat.label_upper_bound, groups=dmat.groups)
            for m in self._resolve_metrics()}

    def eval_set(self, evals, iteration: int = 0, feval=None,
                 output_margin: bool = True) -> str:
        """``"[i]\tname-metric:%.6f..."`` over every ``(DMatrix, name)``
        (reference EvalOneIter learner.cc:1105), each set's metrics
        followed by ``feval(preds, dmat)``'s ``(name, value)``. ``feval``
        gets the margin as numpy (``[n]`` for one group), or with
        ``output_margin=False`` the transformed prediction (the reference's
        rule; the JAX package always passes the margin). Traced as an
        ``eval`` span."""
        fault.inject("eval")
        evals = list(evals)
        with _trace.span("eval", iteration=iteration, n_sets=len(evals)):
            return self._eval_set(evals, iteration, feval, output_margin)

    def _eval_set(self, evals, iteration: int, feval,
                  output_margin: bool) -> str:
        parts = [f"[{iteration}]"]
        for dmat, name in evals:
            vals = self.eval_values([(dmat, name)], iteration)[name]
            parts.extend(f"{name}-{k}:{v:.6f}" for k, v in vals.items())
            if feval is not None:
                m = self._predict_margin(dmat)
                m = m[:, 0] if self.n_groups == 1 else m
                if not output_margin:
                    m = self._obj.pred_transform(m)
                fname, fval = feval(m.cpu().numpy(), dmat)
                parts.append(f"{name}-{fname}:{fval:.6f}")
        return "\t".join(parts)

    def eval(self, data: DMatrix, name: str = "eval", iteration: int = 0) -> str:
        return self.eval_set([(data, name)], iteration)

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def _forest(self, iteration_range=None
                ) -> Tuple[StackedForest, Optional[torch.Tensor]]:
        """The stacked trees of rounds ``[lo, hi)`` of ``iteration_range``
        (``hi`` 0: to the last round; None or ``(0, 0)``: every round) and
        their weights (DART's; None: all ones)."""
        model = self._gbm.model
        per_round = self._per_round
        lo, hi = 0, model.num_trees // per_round
        if iteration_range is not None and tuple(iteration_range) != (0, 0):
            lo, hi = (int(v) for v in iteration_range)
            if hi == 0:
                hi = model.num_trees // per_round
        tw = self._gbm.tree_weights()
        if tw is not None:
            tw = tw[lo * per_round:hi * per_round]
        return model.stacked_slice(lo * per_round, hi * per_round), tw

    def _validate_features(self, data: DMatrix) -> None:
        """The reference's ``Booster._validate_features`` (core.py): where
        both the booster and the matrix carry feature names, they must be
        the same. (The JAX package accepts ``validate_features`` and checks
        nothing in ``predict``.)"""
        names = self.feature_names
        if names and data.feature_names and list(data.feature_names) != names:
            raise ValueError(f"feature_names mismatch: booster {names}, "
                             f"data {list(data.feature_names)}")

    def predict(self, data: DMatrix, output_margin: bool = False,
                pred_leaf: bool = False, pred_contribs: bool = False,
                approx_contribs: bool = False, pred_interactions: bool = False,
                validate_features: bool = True, training: bool = False,
                iteration_range: Optional[Tuple[int, int]] = None,
                strict_shape: bool = False, ntree_limit: int = 0
                ) -> np.ndarray:
        """Predictions of ``data`` (the JAX package's ``Booster.predict``,
        ``learner.py:734``, and its shape rules): transformed values, or
        margins with ``output_margin``, whose ``[n, 1]`` becomes ``[n]``
        unless ``strict_shape``. With K output groups the margins and the
        ``multi:softprob`` probabilities are ``[n, K]`` and
        ``multi:softmax`` gives ``[n]`` class indices (as floats, strict
        or not). With ``pred_leaf`` the ``[n, T]`` leaf ids of the saved
        (BFS-compacted) trees, every tree.
        ``iteration_range=(lo, hi)`` keeps rounds ``[lo, hi)`` and walks
        them afresh, bypassing the prediction cache; ``ntree_limit`` (when
        no range is given) keeps the first ``ntree_limit // (K *
        num_parallel_tree)`` rounds. DART's walks weight every tree.
        ``training`` changes nothing (as in the JAX package: DART drops
        trees only in ``update``). ``pred_contribs`` gives the float64 SHAP
        values ``[n, F+1]`` (``[n, K, F+1]``), bias column last; with
        ``approx_contribs`` Saabas's; ``pred_interactions`` the ``[n, F+1,
        F+1]`` (``[n, K, F+1, F+1]``) interaction values, computed on the
        data's device (``interpret.py``). As in the JAX package they ignore
        ``iteration_range`` / ``ntree_limit`` and the matrix's
        ``base_margin``. A linear booster refuses ``pred_leaf``, gives its
        per-feature products as contributions (float32) and zero
        interactions. Traced as a ``predict`` span."""
        with _trace.span("predict", rows=data.num_row()):
            return self._predict(
                data, output_margin, pred_leaf, pred_contribs,
                approx_contribs, pred_interactions, validate_features,
                iteration_range, strict_shape, ntree_limit)

    def _predict(self, data: DMatrix, output_margin: bool, pred_leaf: bool,
                 pred_contribs: bool, approx_contribs: bool,
                 pred_interactions: bool, validate_features: bool,
                 iteration_range, strict_shape: bool,
                 ntree_limit: int) -> np.ndarray:
        self._configure()
        self._check_device(data)
        if validate_features:
            self._validate_features(data)
        K = self.n_groups
        if self._gbm.name == "gblinear":
            if pred_leaf:
                raise ValueError(
                    "gblinear does not support prediction of leaf index")
            if pred_interactions:
                F = self.num_features()
                shape = ((data.num_row(), F + 1, F + 1) if K == 1
                         else (data.num_row(), K, F + 1, F + 1))
                return np.zeros(shape, np.float32)
            if pred_contribs:
                return self._gblinear_contribs(data)
            iteration_range, ntree_limit = None, 0  # one model, no rounds
        elif pred_contribs or pred_interactions:
            from . import interpret

            if pred_interactions:
                return interpret.predict_interactions(self, data)
            return interpret.predict_contribs(self, data,
                                              approx=approx_contribs)
        if ntree_limit and iteration_range is None:
            iteration_range = (0, max(1, ntree_limit // self._per_round))
        if pred_leaf:
            model = self._gbm.model
            model.trees  # leaf ids of the saved trees, not of the device heap
            forest = model.stacked()
            return torch.cat([predict_leaf(forest, X) for _, _, X in
                              self._data_blocks(data)]).cpu().numpy()
        if iteration_range is None or tuple(iteration_range) == (0, 0):
            margin = self._predict_margin(data)
        else:
            forest, tw = self._forest(iteration_range)
            margin = self._walk(forest, data, self._base_margin_for(data), tw)
        out = margin if output_margin else self._obj.pred_transform(
            margin[:, 0] if K == 1 else margin)
        out = out.cpu().numpy()
        if out.ndim == 2 and out.shape[1] == 1 and not strict_shape:
            out = out[:, 0]
        return out

    def _gblinear_contribs(self, data: DMatrix) -> np.ndarray:
        """The linear booster's contributions (reference gblinear.cc:176
        PredictContribution; the JAX package's ``_gblinear_contribs``):
        ``x_f * w_f`` per present value (missing: 0) and bias plus base
        margin last, float32 ``[n, F+1]`` or ``[n, K, F+1]``, computed on
        the data's device."""
        w = self._gbm.weights  # [F+1, K]
        Xz = torch.nan_to_num(data.data)
        n, F = Xz.shape
        K = w.shape[1]
        out = torch.empty((n, K, F + 1), dtype=torch.float32,
                          device=Xz.device)
        out[:, :, :F] = Xz.unsqueeze(1) * w[:F].t().unsqueeze(0)
        out[:, :, F] = w[F] + self._base_margin_val
        out = out.cpu().numpy()
        return out[:, 0, :] if K == 1 else out

    def _forest_snapshot(self, iteration_range=None
                         ) -> Tuple[StackedForest, Optional[torch.Tensor]]:
        """``_forest(iteration_range)`` cached per model version: an LRU of
        4 keyed on ``(num_trees, rounds)`` (the JAX package's
        ``_forest_snapshot``). Stacking, and for a loaded model the
        host-to-device copy of the trees, happen once per version, not once
        per ``inplace_predict``. Cleared where the leaves change under the
        same tree count: refresh, ``load_model``, slicing."""
        self._configure()
        if iteration_range is not None and tuple(iteration_range) == (0, 0):
            iteration_range = None
        cur = self._gbm.model.num_trees
        rkey = None
        if iteration_range is not None:
            lo, hi = (int(v) for v in iteration_range)
            rkey = (lo, hi if hi else cur // self._per_round)
        key = (cur, rkey)
        with self._forest_snapshots_lock:
            hit = self._forest_snapshots.get(key)
            if hit is not None:
                self._forest_snapshots.move_to_end(key)
                _REGISTRY.counter(
                    "predict_forest_snapshot_hits_total",
                    "Predicts served from a cached stacked forest").inc()
                return hit
        _REGISTRY.counter(
            "predict_forest_snapshot_misses_total",
            "Stacked-forest (re)builds for predict").inc()
        snap = self._forest(rkey)
        with self._forest_snapshots_lock:
            self._forest_snapshots[key] = snap
            while len(self._forest_snapshots) > 4:
                self._forest_snapshots.popitem(last=False)
        return snap

    @staticmethod
    def _inplace_normalize(data, missing):
        """Raw input -> ``[n, F]`` float32 with NaN missing, or a
        ``CSRStorage`` for scipy sparse input; None for inputs the in-place
        path does not take (they predict through a DMatrix)."""
        if hasattr(data, "tocsr") and hasattr(data, "nnz"):
            return CSRStorage(data, missing)
        if isinstance(data, (list, tuple)):
            data = np.asarray(data, np.float32)
        if not isinstance(data, np.ndarray) or data.ndim != 2:
            return None
        X = data.astype(np.float32, copy=False)
        if missing is not None and not (
                isinstance(missing, float) and np.isnan(missing)):
            X = np.where(X == missing, np.nan, X).astype(np.float32)
        return np.ascontiguousarray(X)

    def inplace_predict(self, data, iteration_range=None,
                        predict_type: str = "value", missing: float = np.nan,
                        base_margin=None, validate_features: bool = True,
                        strict_shape: bool = False) -> np.ndarray:
        """Predict from a dense array or a scipy sparse matrix, with no
        DMatrix and no binning (reference ``XGBoosterPredictFromDense`` /
        ``FromCSR``, c_api.cc:833; the JAX package's
        ``Booster.inplace_predict``, ``learner.py:838``): the serving fast
        path (``predictor/serving.py`` ``predict_serving``) over the
        model's cached stacked forest (``_forest_snapshot``). The rows go
        to the device once and through ``predict_margin`` (kernel B on the
        card); the transform runs on the device; one copy comes back.
        Sparse rows go in blocks of 65,536 made dense on the host (absent
        entries NaN, stored ``missing`` values NaN), bit for bit the dense
        walk of the same rows. ``predict_type`` is ``"value"`` or
        ``"margin"``; ``iteration_range`` ``(lo, hi)`` keeps rounds ``[lo,
        hi)`` (``hi`` 0: to the last). With ``validate_features`` an input
        narrower than ``num_features()`` raises. Shapes as ``predict``'s,
        except that ``strict_shape`` also makes ``[n]``
        (``multi:softmax``) ``[n, 1]``, as in the JAX package. A linear
        booster, and input that is neither an array nor sparse, predict
        through a DMatrix of the rows, as in the JAX package."""
        self._configure()
        if predict_type not in ("value", "margin"):
            raise ValueError(
                f"inplace_predict supports predict_type 'value' and "
                f"'margin', got {predict_type!r}")
        if isinstance(data, np.ndarray) and data.ndim != 2:
            raise ValueError(f"data must be 2-D, got shape {data.shape}")
        X = (self._inplace_normalize(data, missing)
             if self._gbm.name in ("gbtree", "dart") else None)
        if X is None:
            d = DMatrix(data, missing=missing, device=self.device)
            if base_margin is not None:
                d.set_base_margin(base_margin)
            return self.predict(d, output_margin=predict_type == "margin",
                                iteration_range=iteration_range,
                                strict_shape=strict_shape)
        n, F = X.shape
        if validate_features:
            nf = self._num_feature()
            if nf and F < nf:
                raise ValueError(
                    f"feature count mismatch: model needs >= {nf} "
                    f"features, input has {F}")
        K = self.n_groups
        if base_margin is not None:
            base = torch.as_tensor(
                np.asarray(base_margin, np.float32).reshape(n, K),
                device=self.device)
        else:
            base = torch.full((n, K), self._base_margin_val,
                              dtype=torch.float32, device=self.device)
        forest, tw = self._forest_snapshot(iteration_range)
        out = predict_serving(
            forest, X, base, tw,
            transform=None if predict_type == "margin"
            else self._obj.pred_transform)
        if out.ndim == 2 and out.shape[1] == 1 and not strict_shape:
            out = out[:, 0]
        elif strict_shape and out.ndim == 1:
            out = out.reshape(n, 1)
        return out

    # ------------------------------------------------------------------
    # model IO (XGBoost JSON schema, doc/model.schema)
    # ------------------------------------------------------------------
    def _num_feature(self) -> int:
        for d in self._cache_refs.values():
            return d.num_col()
        if self._loaded_num_feature:
            return self._loaded_num_feature
        model = getattr(self._gbm, "model", None)  # none for gblinear
        trees = model.trees if model is not None else []
        return int(max((t.split_indices.max(initial=0) for t in trees),
                       default=-1) + 1)

    def _feature_meta(self) -> Tuple[List[str], List[str]]:
        """(feature names, feature types) of the first cached matrix that
        carries either, both from that one matrix; else what a loaded
        model carried (the JAX package's ``_feature_meta``)."""
        for d in self._cache_refs.values():
            if d.feature_names or d.feature_types:
                return list(d.feature_names or []), list(d.feature_types or [])
        return list(self._loaded_feature_names), list(self._loaded_feature_types)

    def save_json(self) -> dict:
        self._configure()
        names, types = self._feature_meta()
        learner = {
            "feature_names": names,
            "feature_types": types,
            "learner_model_param": {
                "base_score": str(self.lparam.base_score
                                  if self.lparam.base_score is not None
                                  else self._obj.default_base_score()),
                "num_class": str(self.lparam.num_class),
                "num_feature": str(self._num_feature()),
            },
            "objective": {"name": self._obj.name},
            "gradient_booster": self._gbm.save_json(),
            "attributes": dict(self.attributes_),
        }
        return {"version": _VERSION, "learner": learner}

    def save_raw(self, raw_format: str = "json") -> bytes:
        """The model JSON as bytes, whatever ``raw_format`` asks for: the
        JAX package writes JSON for ``"ubj"`` and ``"deprecated"`` too."""
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
        self._loaded_feature_names = list(learner.get("feature_names", []))
        self._loaded_feature_types = list(learner.get("feature_types", []))
        self.attributes_ = dict(learner.get("attributes", {}))
        self._caches.clear()
        self._forest_snapshots.clear()

    def load_model(self, fname: Union[str, bytes, bytearray, os.PathLike]) -> None:
        if isinstance(fname, (bytes, bytearray)):
            self.load_json(json.loads(bytes(fname).decode()))
            return
        with open(fname) as f:
            self.load_json(json.load(f))

    # ------------------------------------------------------------------
    # model state: pickling, copies, attributes, slicing
    # (the JAX package's learner.py:984-1069, :1316-1333)
    # ------------------------------------------------------------------
    def __getstate__(self) -> dict:
        return {
            "model": self.save_json() if self._gbm is not None else None,
            "lparam": self.lparam.to_dict(),
            # only the keys a caller set: replaying every default through
            # update() would mark it explicit
            "lparam_explicit": sorted(self.lparam._explicit),
            "extra": dict(self._extra_params),
            "attributes": dict(self.attributes_),
            "device": str(self.device),
        }

    def __setstate__(self, state: dict) -> None:
        # on the device the Booster was made for; raises where it is absent
        self.__init__(device=state["device"])
        self.lparam.update({k: v for k, v in state["lparam"].items()
                            if v is not None})
        self.lparam._explicit = set(state["lparam_explicit"])
        self._extra_params = dict(state["extra"])
        self.attributes_ = dict(state["attributes"])
        if state["model"] is not None:
            self.load_json(state["model"])

    def copy(self) -> "Booster":
        """A new Booster with the model, parameters and attributes, on the
        same device, without prediction caches."""
        return _copy.deepcopy(self)

    def __copy__(self) -> "Booster":
        return self.copy()

    def __deepcopy__(self, memo) -> "Booster":
        b = Booster.__new__(Booster)
        b.__setstate__(json.loads(json.dumps(self.__getstate__(),
                                             default=float)))
        return b

    def num_boosted_rounds(self) -> int:
        """Rounds in the model; 0 for the linear booster, whose rounds the
        JAX package does not count (so continuation and ``boost`` restart
        its random selectors' keys at round 0)."""
        self._configure()
        if self._gbm.name == "gblinear":
            return 0
        return self._gbm.model.num_trees // self._per_round

    def num_features(self) -> int:
        return self._num_feature()

    def attr(self, key: str) -> Optional[str]:
        return self.attributes_.get(key)

    def set_attr(self, **kwargs) -> None:
        """Set string attributes; a value of None removes the key."""
        for k, v in kwargs.items():
            if v is None:
                self.attributes_.pop(k, None)
            else:
                self.attributes_[k] = str(v)

    def attributes(self) -> Dict[str, str]:
        return dict(self.attributes_)

    @property
    def best_iteration(self) -> Optional[int]:
        """The ``best_iteration`` attribute (set by early stopping), or
        None; kept in the attributes, so it survives copies, pickling and
        the model JSON."""
        v = self.attr("best_iteration")
        return None if v is None else int(v)

    @best_iteration.setter
    def best_iteration(self, iteration: int) -> None:
        self.set_attr(best_iteration=str(int(iteration)))

    @property
    def best_score(self) -> Optional[float]:
        v = self.attr("best_score")
        return None if v is None else float(v)

    @best_score.setter
    def best_score(self, score: float) -> None:
        self.set_attr(best_score=f"{score:.9g}")

    @property
    def feature_names(self) -> Optional[List[str]]:
        return self._feature_meta()[0] or None

    @feature_names.setter
    def feature_names(self, names) -> None:
        self._loaded_feature_names = list(names) if names else []
        for d in self._cache_refs.values():
            d.feature_names = list(names) if names else None

    @property
    def feature_types(self) -> Optional[List[str]]:
        return self._feature_meta()[1] or None

    @feature_types.setter
    def feature_types(self, types) -> None:
        self._loaded_feature_types = list(types) if types else []

    # ------------------------------------------------------------------
    # configuration and model inspection (the JAX package's
    # learner.py:1071-1360)
    # ------------------------------------------------------------------
    def save_config(self) -> str:
        """The configuration as a JSON string (reference
        XGBoosterSaveJsonConfig): the learner's parameters, the booster's
        name and parameters and the objective, enough for ``load_config``
        to configure a Booster the same way."""
        self._configure()
        return json.dumps({
            "version": list(_VERSION),
            "learner": {
                "learner_train_param": self.lparam.to_dict(),
                "gradient_booster": {"name": self._gbm.name,
                                     "params": dict(self._extra_params)},
                "objective": {"name": self._obj.name},
            },
        })

    def load_config(self, config: str) -> None:
        """Apply a ``save_config`` string: its parameters go through
        ``_apply_params`` and to a configured booster; the model is
        untouched."""
        learner = json.loads(config).get("learner", {})
        self._apply_params(dict(learner.get("learner_train_param", {})))
        gb = learner.get("gradient_booster", {})
        if gb.get("name"):
            self._apply_params({"booster": gb["name"]})
        gb_params = dict(gb.get("params", {}))
        self._apply_params(gb_params)
        obj = learner.get("objective", {})
        if obj.get("name"):
            self._apply_params({"objective": obj["name"]})
        if self._gbm is not None:
            for k, v in gb_params.items():
                self._gbm.set_param(k, v)
        self._metrics = []

    @staticmethod
    def _parse_fmap_full(fmap: str
                         ) -> Optional[Tuple[List[str], List[str]]]:
        """A feature map file (``<id> <name> <type>`` per line; types ``i``,
        ``q``, ``int``, ``float``, ``c``): ``(names, types)``, or None when
        no file is named. A missing file raises ValueError."""
        if not fmap:
            return None
        if not os.path.exists(fmap):
            raise ValueError(f"No such featmap file: {fmap!r}")
        names: Dict[int, str] = {}
        types: Dict[int, str] = {}
        with open(fmap) as f:
            for line in f:
                ps = line.split()
                if len(ps) >= 2:
                    names[int(ps[0])] = ps[1]
                    if len(ps) >= 3:
                        types[int(ps[0])] = ps[2]
        if not names:
            return None
        n = max(names) + 1
        return ([names.get(i, f"f{i}") for i in range(n)],
                [types.get(i, "q") for i in range(n)])

    def _names(self, fmap: str) -> Optional[List[str]]:
        """Feature names from ``fmap``, else the Booster's, else None."""
        parsed = self._parse_fmap_full(fmap)
        return (parsed[0] if parsed else None) or self._feature_meta()[0] \
            or None

    def get_split_value_histogram(self, feature: str, fmap: str = "",
                                  bins: Optional[int] = None,
                                  as_pandas: bool = True):
        """``[[split value, count], ...]`` of the numerical splits on
        ``feature`` (a name, or ``f<i>`` without names), over
        ``min(bins, distinct values)`` equal-width bins (reference
        core.py:2508); a pandas DataFrame where pandas imports and
        ``as_pandas``. A feature split only by category raises."""
        self._configure()
        names = self._names(fmap) or []
        try:
            fidx = (int(feature[1:]) if (not names and feature.startswith("f")
                                         and feature[1:].isdigit())
                    else names.index(feature))
        except (ValueError, AttributeError):
            raise ValueError(f"unknown feature: {feature!r}")
        values: List[float] = []
        is_cat = False
        for t in self._gbm.model.trees:
            mask = (t.left_children != -1) & (t.split_indices == fidx)
            if bool((t.split_type[mask] != 0).any()):
                is_cat = True
                continue
            values.extend(float(v) for v in t.split_conditions[mask])
        if not values and is_cat:
            raise ValueError(
                "Split value historgam doesn't support categorical split.")
        n_unique = len(np.unique(values))
        bins = max(min(n_unique, bins) if bins is not None else n_unique, 1)
        nph = np.histogram(values, bins=bins)
        nph = np.column_stack((nph[1][1:], nph[0]))
        nph = nph[nph[:, 1] > 0]
        if as_pandas:
            try:
                import pandas as pd
            except ImportError:
                return nph
            return pd.DataFrame(nph, columns=["SplitValue", "Count"])
        return nph

    def get_dump(self, fmap: str = "", with_stats: bool = False,
                 dump_format: str = "text") -> List[str]:
        """One dump string per tree: ``"text"``, ``"json"`` (the
        reference's per-node dump) or ``"dot"`` / ``"dot:{attrs json}"``
        (Graphviz). ``fmap`` names the features and gives their types."""
        self._configure()
        parsed = self._parse_fmap_full(fmap)
        names, types = parsed if parsed else (None, None)
        if not names:
            meta_names, meta_types = self._feature_meta()
            names = meta_names or None
            types = types or (meta_types or None)
        if self._gbm.name == "gblinear":
            # one string: the bias, then the weights (gblinear_model.h:99)
            w = self._gbm.host_weights()
            bias, wt = w[-1], w[:-1]
            if dump_format == "json":
                return [json.dumps(
                    {"bias": [float(b) for b in bias],
                     "weight": [float(v) for row in wt for v in row]},
                    indent=2)]
            lines = (["bias:"] + [f"{float(b):.6g}" for b in bias]
                     + ["weight:"] + [f"{float(v):.6g}" for row in wt
                                      for v in row])
            return ["\n".join(lines) + "\n"]
        out = []
        for t in self._gbm.model.trees:
            if dump_format == "json":
                out.append(t.dump_json_ref(names, with_stats, types))
            elif dump_format == "text":
                out.append(t.dump_text(names, with_stats, types))
            elif dump_format.startswith("dot"):
                attrs = (json.loads(dump_format[4:])
                         if dump_format.startswith("dot:") else None)
                out.append(t.dump_dot(names, types, attrs))
            else:
                raise ValueError(f"Unknown dump format: {dump_format!r}")
        return out

    def dump_model(self, fout, fmap: str = "", with_stats: bool = False,
                   dump_format: str = "text") -> None:
        """``get_dump`` into the file ``fout``: a JSON list, or each tree
        after a ``booster[i]:`` line."""
        dumps = self.get_dump(fmap, with_stats, dump_format)
        with open(fout, "w") as f:
            if dump_format == "json":
                f.write("[\n" + ",\n".join(dumps) + "\n]")
            else:
                for i, d in enumerate(dumps):
                    f.write(f"booster[{i}]:\n{d}\n")

    def get_score(self, fmap: str = "", importance_type: str = "weight"
                  ) -> Dict[str, float]:
        """Feature importance over every split (reference
        CalcFeatureScore): ``weight`` (split count), ``total_gain``,
        ``total_cover``, and ``gain`` / ``cover`` per split. A linear
        booster has ``weight`` only: its coefficients (gblinear.cc:240),
        ``f<i>_g<k>`` for K groups."""
        self._configure()
        if self._gbm.name == "gblinear":
            if importance_type != "weight":
                raise ValueError("gblinear only has `weight` defined for "
                                 "feature importance")
            w = self._gbm.host_weights()[:-1]  # [F, K]
            names = self._names(fmap)

            def lname(f: int) -> str:
                return names[f] if names and f < len(names) else f"f{f}"

            if w.shape[1] == 1:
                return {lname(f): float(w[f, 0]) for f in range(w.shape[0])}
            return {f"{lname(f)}_g{g}": float(w[f, g])
                    for f in range(w.shape[0]) for g in range(w.shape[1])}
        gain: Dict[int, float] = {}
        cover: Dict[int, float] = {}
        weight: Dict[int, float] = {}
        for t in self._gbm.model.trees:
            internal = t.left_children != -1
            for f, g, c in zip(t.split_indices[internal],
                               t.loss_changes[internal],
                               t.sum_hessian[internal]):
                f = int(f)
                weight[f] = weight.get(f, 0.0) + 1.0
                gain[f] = gain.get(f, 0.0) + float(g)
                cover[f] = cover.get(f, 0.0) + float(c)
        names = self._names(fmap)

        def nm(f: int) -> str:
            return names[f] if names and f < len(names) else f"f{f}"

        if importance_type == "weight":
            return {nm(f): v for f, v in weight.items()}
        if importance_type == "total_gain":
            return {nm(f): v for f, v in gain.items()}
        if importance_type == "total_cover":
            return {nm(f): v for f, v in cover.items()}
        if importance_type == "gain":
            return {nm(f): gain[f] / weight[f] for f in gain}
        if importance_type == "cover":
            return {nm(f): cover[f] / weight[f] for f in cover}
        raise ValueError(f"Unknown importance_type: {importance_type}")

    def get_fscore(self, fmap: str = "") -> Dict[str, float]:
        return self.get_score(fmap, "weight")

    def trees_to_dataframe(self, fmap: str = ""):
        """One pandas row per node: Tree, Node, ID, Feature (``f<i>`` or
        ``Leaf``), Split, Yes, No, Missing, Gain (the leaf value at
        leaves) and Cover. Imports pandas."""
        import pandas as pd

        self._configure()
        if self._gbm.name not in ("gbtree", "dart"):
            raise ValueError("This method is not defined for Booster type "
                             f"{self._gbm.name}")
        rows = []
        for ti, t in enumerate(self._gbm.model.trees):
            for i in range(t.num_nodes):
                leaf = t.left_children[i] == -1
                yes = f"{ti}-{t.left_children[i]}"
                no = f"{ti}-{t.right_children[i]}"
                rows.append({
                    "Tree": ti,
                    "Node": i,
                    "ID": f"{ti}-{i}",
                    "Feature": "Leaf" if leaf else f"f{t.split_indices[i]}",
                    "Split": None if leaf else float(t.split_conditions[i]),
                    "Yes": None if leaf else yes,
                    "No": None if leaf else no,
                    "Missing": None if leaf else (
                        yes if t.default_left[i] else no),
                    "Gain": (float(t.split_conditions[i]) if leaf
                             else float(t.loss_changes[i])),
                    "Cover": float(t.sum_hessian[i]),
                })
        return pd.DataFrame(rows)

    def __getitem__(self, val) -> "Booster":
        """The rounds ``val`` selects (an int or a slice with a step), as a
        new Booster without caches (reference Learner::Slice); a linear
        booster refuses (gbm.h:70)."""
        self._configure()
        if self._gbm.name == "gblinear":
            raise ValueError("Slice is not supported by current booster.")
        if isinstance(val, int):
            val = slice(val, val + 1)
        start = val.start or 0
        stop = val.stop if val.stop is not None else self.num_boosted_rounds()
        step = val.step or 1
        out = self.copy()
        out._gbm.model = out._gbm.model.slice(start, stop, step)
        out._caches.clear()
        out._forest_snapshots.clear()
        return out
