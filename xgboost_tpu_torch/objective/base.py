"""ObjFunction base class (reference: ``include/xgboost/objective.h``).

Gradients must not depend on the device: the card's and the CPU's float32
``exp``/``log``/``erfc``/``sqrt`` differ in the last ulp, and one ulp can
flip a near-tie split. So every transcendental of a gradient or a
transform is evaluated in float64 and rounded once to float32 (``f64``;
square roots through ``sqrt``); additions, products and quotients of
tensors stay in float32, where both devices round exactly (IEEE), in the
JAX package's order of operations. A quotient with a Python number goes
through ``div``: PyTorch's CUDA kernel multiplies by the number's
reciprocal where the CPU's divides. Prefix and segment sums that must give
the same bits on both devices run in an order the code fixes
(``seg_scan``, ``segment_sum``): a library scan or ``index_add_`` on the
card adds in its own order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Type

import torch

__all__ = ["ObjFunction", "create_objective", "apply_weight", "register",
           "f64", "sqrt", "div", "param", "seg_scan", "segment_sum"]

_REGISTRY: Dict[str, Type["ObjFunction"]] = {}
_ALIASES: Dict[str, str] = {}


def register(name: str, *aliases: str):
    """Register an objective class as ``name``; ``aliases`` resolve to
    ``name``, the name the model JSON carries (the JAX package's
    ``Registry.resolve``)."""
    def deco(cls):
        _REGISTRY[name] = cls
        for a in aliases:
            _ALIASES[a] = name
        return cls
    return deco


def f64(fn: Callable[[torch.Tensor], torch.Tensor],
        x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` evaluated in float64 and rounded once to ``x``'s dtype, so
    the card and the CPU get the same bits."""
    return fn(x.double()).to(x.dtype)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(x)`` of non-negative ``x`` rounded once to ``x``'s dtype:
    float64 ``torch.sqrt`` refined by one Newton step. The CPU's
    ``torch.sqrt`` is not correctly rounded (in float32 nor float64), and
    in a few thread chunks of a large tensor it has been seen off by ~1e-11
    relative; the Newton step takes any such error below a float64 ulp, so
    the rounded result is the card's."""
    d = x.double()
    y = torch.sqrt(d)
    y = torch.where(y > 0, 0.5 * (y + d / y), y)
    return y.to(x.dtype)


def div(a, b) -> torch.Tensor:
    """``a / b`` rounded as IEEE division on every device: a Python-number
    operand becomes a tensor like the other (a number divisor would be a
    multiplication by its reciprocal on the card)."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return a / b


def seg_scan(x: torch.Tensor, seg_start: torch.Tensor,
             max_len: int) -> torch.Tensor:
    """Inclusive prefix sums along the last axis within segments: position
    ``i`` sums ``x[..., seg_start[i]:i+1]``. Hillis-Steele steps
    ``x[i] += x[i-d]`` for ``d = 1, 2, 4, ...`` below ``max_len`` (the
    longest segment), each where ``i - d`` lies in ``i``'s segment: every
    step is one elementwise add, so the order is the same on every
    device."""
    reach = torch.arange(x.shape[-1], device=x.device) - seg_start
    d = 1
    while d < max_len:
        shifted = torch.nn.functional.pad(x[..., :-d], (d, 0))
        x = x + torch.where(reach >= d, shifted, torch.zeros_like(shifted))
        d *= 2
    return x


def segment_sum(vals: torch.Tensor, dest: torch.Tensor,
                n: int) -> torch.Tensor:
    """``[..., n]`` sums of ``vals`` [..., m] by destination ``dest`` [m]
    (int64 in ``[0, n)``) in a fixed order: stable sort by destination,
    then ``seg_scan`` over each destination's run (0 where none)."""
    if not dest.numel():
        return vals.new_zeros(vals.shape[:-1] + (n,))
    by_dest = torch.argsort(dest, stable=True)
    counts = torch.bincount(dest, minlength=n)
    ends = torch.cumsum(counts, 0)
    seg_start = (ends - counts)[dest[by_dest]]
    summed = seg_scan(vals[..., by_dest], seg_start, int(counts.max()))
    last = summed[..., (ends - 1).clamp(min=0)]
    return torch.where(counts > 0, last, torch.zeros_like(last))


def param(params, name: str, default):
    """``params.name``, or ``default`` when there are no params (the JAX
    package's ``getattr(self.params, name, default)``)."""
    return getattr(params, name, default) if params is not None else default


class ObjFunction:
    """Gradient/hessian provider. Shapes: margin [n] or [n, n_targets]."""

    name: str = ""
    #: rowwise gradients from the margin, label and weight alone: the
    #: objectives the JAX package runs in its scanned rounds, and the ones
    #: training under a row group takes (``learner.py``)
    scan_safe: bool = False

    def __init__(self, params=None):
        self.params = params

    def n_targets(self) -> int:
        return 1

    def get_gradient(self, margin: torch.Tensor, label: torch.Tensor,
                     weight: Optional[torch.Tensor], iteration: int = 0, *,
                     label_lower: Optional[torch.Tensor] = None,
                     label_upper: Optional[torch.Tensor] = None,
                     groups=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(grad, hess)`` of ``margin``; ``label_lower``/``label_upper``
        are the censoring bounds (survival) and ``groups`` the matrix's
        ``QueryGroups`` (ranking)."""
        raise NotImplementedError

    # margin -> user-facing prediction (reference: PredTransform)
    def pred_transform(self, margin: torch.Tensor) -> torch.Tensor:
        return margin

    # the same for evaluation-time predictions (softmax differs)
    def eval_transform(self, margin: torch.Tensor) -> torch.Tensor:
        return self.pred_transform(margin)

    # base_score (prob space) -> initial margin (reference: ProbToMargin)
    def prob_to_margin(self, base_score: float) -> float:
        return base_score

    def default_base_score(self) -> float:
        return 0.5

    def default_metric(self) -> str:
        return "rmse"


def create_objective(name: str, params=None) -> ObjFunction:
    """The objective registered as ``name``; a name the port lacks raises
    NotImplementedError."""
    name = _ALIASES.get(name, name)
    cls = _REGISTRY.get(name)
    if cls is None:
        raise NotImplementedError(
            f"objective {name!r} is not ported yet; the port has "
            f"{sorted(_REGISTRY)}")
    obj = cls(params)
    obj.name = name
    return obj


def apply_weight(grad: torch.Tensor, hess: torch.Tensor,
                 weight: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row weights times gradients, broadcast over ``[n, K]``."""
    if weight is None:
        return grad, hess
    if grad.dim() == 2:
        weight = weight[:, None]
    return grad * weight, hess * weight
