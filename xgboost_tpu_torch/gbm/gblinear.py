"""GBLinear: coordinate-descent linear boosting on the data's device.

The port of the JAX package's ``gbm/gblinear.py`` (reference
``src/gbm/gblinear.cc``, ``src/linear/updater_coordinate.cc``,
``updater_shotgun.cc``, the feature selectors of ``coordinate_common.h``).
A round updates the bias, then the weights by the closed-form step
``dw = -(sum g x_f + lambda w_f) / (sum h x_f^2 + lambda)``, soft-thresholded
by ``alpha``: all features at once (``shotgun``) or one coordinate at a
time in the selector's order (``coord_descent``). The raw values go in
with NaN as a zero contribution: the booster builds no bins and no one-hot.
Each sum is taken in float64 and rounded to float32, so the card and the
CPU agree; the rest is the JAX package's float32 arithmetic. The
coordinate loop stays on the device (the chosen feature is a device
index): a round synchronizes nothing.

The random selectors draw from the JAX package's stream (``threefry``):
round ``iteration``'s key ``prng_key(iteration * 2654435761 & 0x7FFFFFFF)``,
folded with the output group.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import threefry
from ..params import GBLinearParam

__all__ = ["GBLinear"]

_SELECTORS = ("cyclic", "shuffle", "random", "greedy", "thrifty")


def _sum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """A float32 sum taken in float64 and rounded once."""
    x = x.to(torch.float64)
    return (x.sum() if dim is None else x.sum(dim)).to(torch.float32)


def _soft_threshold(raw: torch.Tensor, hsum: torch.Tensor,
                    alpha: float) -> torch.Tensor:
    return torch.sign(raw) * torch.clamp(
        torch.abs(raw) - alpha / torch.clamp(hsum, min=1e-10), min=0.0)


def _candidate_deltas(XzT: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, w: torch.Tensor, lam: float,
                      alpha: float) -> torch.Tensor:
    """[F] closed-form weight deltas of every feature at the current
    residuals (reference ``coordinate_common.h`` CoordinateDelta);
    ``XzT`` is the feature-major [F, n] matrix with NaN as 0."""
    gsum = _sum(XzT * grad, 1) + lam * w[:-1]
    hsum = _sum(hess * XzT * XzT, 1) + lam
    raw = w[:-1] - gsum / torch.clamp(hsum, min=1e-10)
    return _soft_threshold(raw, hsum, alpha) - w[:-1]


def _coord_step(XzT: torch.Tensor, f: torch.Tensor, w: torch.Tensor,
                g: torch.Tensor, hess: torch.Tensor, lam: float,
                alpha: float, eta: float):
    """One coordinate step on feature ``f`` (a [1] device index): its
    weight moves by ``eta`` times the thresholded delta and the gradients
    follow (``UpdateResidualParallel``)."""
    xf = XzT.index_select(0, f)[0]
    wf = w.index_select(0, f)
    gsum = _sum(g * xf) + lam * wf
    hsum = _sum(hess * xf * xf) + lam
    raw = wf - gsum / torch.clamp(hsum, min=1e-10)
    dw = eta * (_soft_threshold(raw, hsum, alpha) - wf)
    w = w.index_add(0, f, dw)
    return w, g + hess * xf * dw


def _linear_round(X: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                 weights: torch.Tensor, lam: float, alpha: float, eta: float,
                 key: torch.Tensor, selector: str, steps: int
                 ) -> torch.Tensor:
    """One boosting round of one output group (the JAX package's
    ``_linear_round``): ``weights`` [F+1] (bias last) after the bias step
    and ``steps`` coordinate steps in the selector's order (cyclic: every
    feature in order; shuffle: a permutation; random: F draws with
    replacement; greedy: re-score every feature and take the largest
    delta, ``steps`` times; thrifty: the ``steps`` largest deltas at the
    round's start), or one simultaneous step (``shotgun``)."""
    F = X.shape[1]
    dev = X.device
    XzT = torch.nan_to_num(X).t().contiguous()  # [F, n]
    # the bias first; the residuals advance by the applied delta
    db = -_sum(grad) / torch.clamp(_sum(hess), min=1e-10)
    db_applied = eta * db
    weights = weights.clone()
    weights[-1:] += db_applied
    grad = grad + hess * db_applied
    if selector == "shotgun":
        dw = _candidate_deltas(XzT, grad, hess, weights, lam, alpha)
        weights[:-1] += eta * dw
        return weights
    if selector == "greedy":
        w, g = weights, grad
        for _ in range(steps):
            dws = _candidate_deltas(XzT, g, hess, w, lam, alpha)
            f = torch.argmax(torch.abs(dws)).view(1)
            w, g = _coord_step(XzT, f, w, g, hess, lam, alpha, eta)
        return w
    if selector == "thrifty":
        dws = _candidate_deltas(XzT, grad, hess, weights, lam, alpha)
        order = torch.argsort(-torch.abs(dws), stable=True)[:steps]
    elif selector == "shuffle":
        order = threefry.permutation(key, F, dev)
    elif selector == "random":
        order = threefry.randint(key, (F,), 0, F, dev)
    else:  # cyclic
        order = torch.arange(F, device=dev)
    w, g = weights, grad
    for i in range(order.shape[0]):
        w, g = _coord_step(XzT, order[i:i + 1], w, g, hess, lam, alpha, eta)
    return w


class GBLinear:
    """The linear booster: weights [F+1, K] (bias last) on one device."""

    name = "gblinear"

    def __init__(self, n_groups: int, params: Dict[str, Any], device):
        self.n_groups = max(1, n_groups)
        self.device = device
        self.param = GBLinearParam()
        self.param.update(dict(params))
        self.weights: Optional[torch.Tensor] = None  # [F+1, K] float32

    def set_param(self, key: str, value: Any) -> None:
        self.param.update({key: value})

    def _selector(self) -> str:
        """The round's selector as the JAX package reads ``updater``:
        ``coord_descent`` / ``gpu_coord_descent`` take ``feature_selector``,
        anything else is shotgun (cyclic or shuffle only)."""
        p = self.param
        if p.updater in ("coord_descent", "gpu_coord_descent"):
            if p.feature_selector not in _SELECTORS:
                raise ValueError(
                    f"Unknown feature_selector: {p.feature_selector}")
            return p.feature_selector
        if p.feature_selector not in ("cyclic", "shuffle"):
            raise ValueError(
                "shotgun supports feature_selector cyclic/shuffle only")
        return "shotgun"

    def boost_one_round(self, X: torch.Tensor, grad: torch.Tensor,
                        hess: torch.Tensor, iteration: int) -> None:
        """One round on the raw rows ``X`` [n, F] (NaN missing), gradients
        [n] or [n, K], on their device."""
        F = X.shape[1]
        if self.weights is None:
            self.weights = torch.zeros((F + 1, self.n_groups),
                                       dtype=torch.float32, device=X.device)
        selector = self._selector()
        top_k = int(self.param.top_k)
        steps = (top_k if top_k > 0 and selector in ("greedy", "thrifty")
                 else F)
        key = threefry.prng_key(iteration * 2654435761 & 0x7FFFFFFF)
        p = self.param
        cols = []
        for k in range(self.n_groups):
            g = grad[:, k] if grad.dim() == 2 else grad
            h = hess[:, k] if hess.dim() == 2 else hess
            cols.append(_linear_round(
                X, g, h, self.weights[:, k], float(p.reg_lambda_linear),
                float(p.reg_alpha_linear), float(p.eta_linear),
                threefry.fold_in(key, k), selector, steps))
        self.weights = torch.stack(cols, 1)

    def predict(self, X: torch.Tensor, base_margin: torch.Tensor
                ) -> torch.Tensor:
        """[n, K] margins ``X @ w[:-1] + w[-1]`` (NaN as 0) plus
        ``base_margin``: a plain product, as in the JAX package."""
        w = self.weights if self.weights is not None else torch.zeros(
            (X.shape[1] + 1, self.n_groups), dtype=torch.float32,
            device=X.device)
        return base_margin + (torch.nan_to_num(X) @ w[:-1] + w[-1])

    def host_weights(self) -> np.ndarray:
        """[F+1, K] float32 weights on the host ([1, K] zeros untrained)."""
        if self.weights is None:
            return np.zeros((1, self.n_groups), np.float32)
        return self.weights.cpu().numpy()

    def save_json(self) -> dict:
        w = self.host_weights()
        return {"name": "gblinear",
                "model": {"weights": [float(x) for x in w.reshape(-1)],
                          "shape": list(w.shape)}}

    def load_json(self, j: dict) -> None:
        shape = j["model"].get("shape")
        w = np.asarray(j["model"]["weights"], np.float32)
        w = w.reshape(shape) if shape else w.reshape(-1, 1)
        self.weights = torch.as_tensor(w, device=self.device)
