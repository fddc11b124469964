"""Declarative parameter structs (the port's copy of the fields the main
path reads; reference: ``dmlc/parameter.h`` usage in ``src/tree/param.h``,
``src/gbm/gbtree.h:61``, ``src/learner.cc``).

Each component owns a parameter struct with defaults, bounds and aliases;
``update`` returns the keys it did not know so they can be chained into the
next struct.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["Field", "ParamSet", "TrainParam", "GBTreeParam", "GBLinearParam",
           "LearnerParam", "NOT_PORTED", "check_ported", "known_keys"]


@dataclasses.dataclass
class Field:
    default: Any
    aliases: Tuple[str, ...] = ()
    lower: Optional[float] = None
    upper: Optional[float] = None
    # str -> value coercion (params often arrive as strings)
    parse: Optional[Callable[[Any], Any]] = None


def _coerce(value: Any, default: Any, parse: Optional[Callable]) -> Any:
    if parse is not None:
        return parse(value)
    if default is None:
        return value
    t = type(default)
    if t is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return bool(value)
    if t is int:
        return int(float(value))
    if t is float:
        return float(value)
    if t is str:
        return str(value)
    return value


class ParamSet:
    """Base for parameter structs. Subclasses define FIELDS."""

    FIELDS: Dict[str, Field] = {}

    def __init__(self, **kwargs: Any):
        self._explicit: set = set()
        for name, f in self.FIELDS.items():
            setattr(self, name, f.default)
        self.update(kwargs)

    @classmethod
    def _alias_map(cls) -> Dict[str, str]:
        return {a: name for name, f in cls.FIELDS.items() for a in f.aliases}

    def update(self, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """Apply known keys; return the dict of unknown keys."""
        unknown: Dict[str, Any] = {}
        amap = self._alias_map()
        for key, value in kwargs.items():
            name = amap.get(key, key)
            f = self.FIELDS.get(name)
            if f is None:
                unknown[key] = value
                continue
            v = _coerce(value, f.default, f.parse)
            if f.lower is not None and isinstance(v, (int, float)) and v < f.lower:
                raise ValueError(f"{name}={v} below lower bound {f.lower}")
            if f.upper is not None and isinstance(v, (int, float)) and v > f.upper:
                raise ValueError(f"{name}={v} above upper bound {f.upper}")
            setattr(self, name, v)
            self._explicit.add(name)
        return unknown

    def is_explicit(self, name: str) -> bool:
        """Whether ``name`` was set by a caller (not left at its default)."""
        return name in self._explicit

    def to_dict(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in self.FIELDS}


def _parse_constraint_list(v: Any) -> Any:
    """"(1,-1,0)" style monotone constraint strings."""
    if isinstance(v, str):
        s = v.strip().strip("()")
        return [int(x) for x in s.replace(" ", "").split(",")] if s else []
    return list(v)


def _parse_interaction(v: Any) -> Any:
    if isinstance(v, str):
        s = v.replace("(", "[").replace(")", "]")
        return json.loads(s) if s.strip() else []
    return [list(g) for g in v]


class TrainParam(ParamSet):
    """Tree training hyper-parameters (reference: ``src/tree/param.h``)."""

    FIELDS = {
        "eta": Field(0.3, aliases=("learning_rate",), lower=0.0),
        "gamma": Field(0.0, aliases=("min_split_loss",), lower=0.0),
        "max_depth": Field(6, lower=0),
        # the lossguide grower's leaf budget (0: 2^max_depth up to depth 8,
        # else 255; gbm/gbtree.py); depthwise growth ignores it
        "max_leaves": Field(0, lower=0),
        "max_bin": Field(256, lower=2),
        "grow_policy": Field("depthwise"),
        "min_child_weight": Field(1.0, lower=0.0),
        "reg_lambda": Field(1.0, aliases=("lambda",), lower=0.0),
        "reg_alpha": Field(0.0, aliases=("alpha",), lower=0.0),
        "max_delta_step": Field(0.0, lower=0.0),
        "subsample": Field(1.0, lower=0.0, upper=1.0),
        # "uniform" | "gradient_based" (MVS); checked in the booster
        "sampling_method": Field("uniform"),
        "colsample_bytree": Field(1.0, lower=0.0, upper=1.0),
        "colsample_bylevel": Field(1.0, lower=0.0, upper=1.0),
        "colsample_bynode": Field(1.0, lower=0.0, upper=1.0),
        "monotone_constraints": Field([], parse=_parse_constraint_list),
        "interaction_constraints": Field([], parse=_parse_interaction),
        # categorical features with fewer categories than this split one
        # category against the rest; the others by optimal partition
        # (reference UseOneHot, evaluate_splits.h)
        "max_cat_to_onehot": Field(4, lower=1),
        # accepted and read by nothing but the booster's warnings, as in
        # the JAX package: the sketch is sized by max_bin, the matrix is
        # dense with a missing bin, and the histograms sum fixed-point
        # integers exactly
        "sparse_threshold": Field(0.2),
        "sketch_eps": Field(0.03),
        "single_precision_histogram": Field(True),
        # the row and column samplers' seed (each tree's key is
        # round_seed_py(seed, iteration, group, parallel tree),
        # gbm/gbtree.py); as in the JAX package, only set_param on a
        # configured booster sets it
        "seed": Field(0),
        # process_type="update" / updater="refresh": also rewrite the leaf
        # values, not only the node statistics (reference TreeRefresher)
        "refresh_leaf": Field(True),
    }


class GBTreeParam(ParamSet):
    """Booster-level params (reference: ``src/gbm/gbtree.h:61``)."""

    FIELDS = {
        "tree_method": Field("auto"),
        # a comma-separated updater sequence (gbm/gbtree.py
        # _KNOWN_UPDATERS); empty: the one tree_method implies
        "updater": Field(""),
        "num_parallel_tree": Field(1, lower=1),
        # "default" grows new trees; "update" re-stats the existing ones
        "process_type": Field("default"),
        # "auto" and the names of the reference's predictors; every one
        # walks the stacked forest (a warning says so for cpu_ / gpu_)
        "predictor": Field("auto"),
        # DART (reference DartTrainParam, gbtree.cc)
        "sample_type": Field("uniform"),
        "normalize_type": Field("tree"),
        "rate_drop": Field(0.0, lower=0.0, upper=1.0),
        "one_drop": Field(False),
        "skip_drop": Field(0.0, lower=0.0, upper=1.0),
    }


class GBLinearParam(ParamSet):
    """Linear booster params (reference ``src/gbm/gblinear.cc``,
    ``src/linear/coordinate_common.h``; the JAX package's
    ``GBLinearParam``): ``lambda`` / ``alpha`` / ``eta`` and their long
    names reach the linear booster's own keys. ``updater`` takes
    ``coord_descent`` (or ``gpu_coord_descent``) and anything else means
    shotgun, as the JAX package reads it."""

    FIELDS = {
        "updater": Field("coord_descent"),
        "feature_selector": Field("cyclic"),
        "top_k": Field(0, lower=0),
        "reg_lambda_linear": Field(0.0, aliases=("lambda", "reg_lambda"),
                                   lower=0.0),
        "reg_alpha_linear": Field(0.0, aliases=("alpha", "reg_alpha"),
                                  lower=0.0),
        "eta_linear": Field(0.5, aliases=("eta", "learning_rate"), lower=0.0),
    }


class LearnerParam(ParamSet):
    """Learner-level params (reference: ``src/learner.cc``), with the
    objectives' own parameters. ``seed`` stays here, as in the JAX package,
    and reaches the tree samplers' ``TrainParam.seed`` only through
    ``Booster.set_param`` on a configured booster; ``nthread`` and
    ``verbosity`` change no result."""

    FIELDS = {
        "objective": Field("reg:squarederror"),
        "booster": Field("gbtree"),
        "base_score": Field(None),
        "num_class": Field(0, lower=0),
        "eval_metric": Field([], parse=lambda v: [v] if isinstance(v, str) else list(v)),
        "disable_default_eval_metric": Field(False),
        "seed": Field(0),
        "nthread": Field(0, aliases=("n_jobs",)),
        "verbosity": Field(1, lower=0, upper=3),
        "validate_parameters": Field(False),
        # declared and read by nothing, as in the JAX package: every value
        # trains one output per tree
        "multi_strategy": Field("one_output_per_tree"),
        "scale_pos_weight": Field(1.0),
        # the objectives' own parameters (reference regression_obj.cu,
        # aft_obj.cu; the JAX package's LearnerParam)
        "tweedie_variance_power": Field(1.5, lower=1.0, upper=2.0),
        "huber_slope": Field(1.0),
        "aft_loss_distribution": Field("normal"),
        "aft_loss_distribution_scale": Field(1.0),
        # read by both the tree parameters and count:poisson, whose own
        # default is 0.7 unless the key is set (regression_obj.cu:197);
        # the learner forwards it to the booster as well
        "max_delta_step": Field(0.0, lower=0.0),
        # the ranking objectives: opponents drawn per row on the sampled
        # pair path; max_pairs is accepted and read by nothing, as in the
        # JAX package
        "lambdarank_num_pair_per_sample": Field(1, lower=1),
        "max_pairs": Field(100),
    }


#: keys that the JAX package's parameter structs know and the port has not
#: ported, each with the value at which it changes nothing; any other value
#: raises NotImplementedError (``check_ported``).
NOT_PORTED: Dict[str, Any] = {}


def check_ported(params: Dict[str, Any]) -> None:
    """Raise NotImplementedError for a key of ``NOT_PORTED`` set to a value
    other than the one at which it changes nothing."""
    for key, value in params.items():
        if key in NOT_PORTED:
            default = NOT_PORTED[key]
            if _coerce(value, default, None) != default:
                raise NotImplementedError(
                    f"{key}={value!r} is not ported yet")


def known_keys() -> set:
    """Every parameter name (and alias) that a component of the JAX
    package knows beyond the learner's own: the set ``validate_parameters``
    checks against (the JAX package's ``Booster._validate_unknown``)."""
    known = set(NOT_PORTED)
    for P in (GBTreeParam, TrainParam, GBLinearParam):
        known.update(P.FIELDS)
        for f in P.FIELDS.values():
            known.update(f.aliases)
    return known
