"""Multiclass objectives (reference ``src/objective/multiclass_obj.cu``,
``multi:softmax``/``multi:softprob`` at :198, :202; the JAX package's
``objective/multiclass.py``). Margins are ``[n, K]``; the softmax runs in
float64 and rounds once, so the card and the CPU get the same bits."""

from __future__ import annotations

import torch

from .base import ObjFunction, apply_weight, param, register

__all__ = ["SoftProb", "SoftMax", "softmax"]

_EPS = 1e-16


def softmax(margin: torch.Tensor) -> torch.Tensor:
    """Row softmax of ``[n, K]`` margins: exp(m - max) over its row sum,
    in float64, rounded once to float32."""
    m = margin.double()
    e = torch.exp(m - m.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(margin.dtype)


class _SoftmaxBase(ObjFunction):
    scan_safe = True
    def n_targets(self) -> int:
        nc = param(self.params, "num_class", 0)
        if nc < 2:
            raise ValueError("multi:* objectives need num_class >= 2")
        return nc

    def get_gradient(self, margin, label, weight, iteration=0, **kw):
        p = softmax(margin)
        classes = torch.arange(margin.shape[1], device=margin.device)
        onehot = (label.long()[:, None] == classes).to(margin.dtype)
        grad = p - onehot
        hess = torch.clamp(2.0 * p * (1.0 - p), min=_EPS)
        return apply_weight(grad, hess, weight)

    def eval_transform(self, margin):
        # the metrics (merror, mlogloss, auc) read the distribution
        return softmax(margin)

    def default_metric(self):
        return "mlogloss"


@register("multi:softprob")
class SoftProb(_SoftmaxBase):
    def pred_transform(self, margin):
        return softmax(margin)


@register("multi:softmax")
class SoftMax(_SoftmaxBase):
    def pred_transform(self, margin):
        return torch.argmax(margin, dim=-1).to(torch.float32)
