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

__all__ = ["Field", "ParamSet", "TrainParam", "GBTreeParam", "LearnerParam"]


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
        return unknown


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
        "max_bin": Field(256, lower=2),
        "grow_policy": Field("depthwise"),
        "min_child_weight": Field(1.0, lower=0.0),
        "reg_lambda": Field(1.0, aliases=("lambda",), lower=0.0),
        "reg_alpha": Field(0.0, aliases=("alpha",), lower=0.0),
        "max_delta_step": Field(0.0, lower=0.0),
        "subsample": Field(1.0, lower=0.0, upper=1.0),
        "colsample_bytree": Field(1.0, lower=0.0, upper=1.0),
        "colsample_bylevel": Field(1.0, lower=0.0, upper=1.0),
        "colsample_bynode": Field(1.0, lower=0.0, upper=1.0),
        "monotone_constraints": Field([], parse=_parse_constraint_list),
        "interaction_constraints": Field([], parse=_parse_interaction),
    }


class GBTreeParam(ParamSet):
    """Booster-level params (reference: ``src/gbm/gbtree.h:61``)."""

    FIELDS = {
        "tree_method": Field("auto"),
        "num_parallel_tree": Field(1, lower=1),
    }


class LearnerParam(ParamSet):
    """Learner-level params (reference: ``src/learner.cc``)."""

    FIELDS = {
        "objective": Field("reg:squarederror"),
        "booster": Field("gbtree"),
        "base_score": Field(None),
        "num_class": Field(0, lower=0),
        "eval_metric": Field([], parse=lambda v: [v] if isinstance(v, str) else list(v)),
        "disable_default_eval_metric": Field(False),
        "scale_pos_weight": Field(1.0),
    }
