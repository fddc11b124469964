"""Survival objectives: AFT (reference ``src/objective/aft_obj.cu:144``,
``src/common/probability_distribution.h``, ``src/common/survival_util.h``)
and Cox proportional hazards (``regression_obj.cu:304``); the JAX
package's ``objective/survival.py``.

AFT follows the JAX package's float32 compositions step by step (the
guarded normal hazard, the sigmoid forms of the logistic terms, the exact
ratios of the extreme ones, the rails of the doubly saturated interval
tail), with every transcendental in float64 rounded once (``base.f64``) and
every quotient by a number through ``base.div``, so its gradients are the
same on the card and the CPU. Cox sums its risk sets in float64 and rounds
once at the end.
"""

from __future__ import annotations

import math

import torch

from .base import ObjFunction, apply_weight, div, f64, param, register

__all__ = ["AFT", "CoxPH"]

_SQRT2PI = math.sqrt(2.0 * math.pi)
_SQRT2 = math.sqrt(2.0)
_EPS = 1e-12
# clamped gradient/hessian bounds (survival_util.h kMaxGradient etc.)
_MAX_G, _MIN_H = 15.0, 1e-16


def _exp(x):
    return f64(torch.exp, x)


def _erfc(x):
    return f64(torch.special.erfc, x)


def _norm_pdf(z):
    return div(_exp(-0.5 * z * z), _SQRT2PI)


def _norm_cdf(z):
    # the erfc form: exact in the lower tail, where 0.5 * (1 + erf)
    # cancels to 0 in float32
    return 0.5 * _erfc(div(-z, _SQRT2))


def _logis_pdf(z):
    e = _exp(-torch.abs(z))
    e1 = 1.0 + e
    return e / (e1 * e1)


def _logis_cdf(z):
    return f64(torch.sigmoid, z)


def _extreme_pdf(z):
    w = _exp(torch.clamp(z, -50.0, 50.0))
    return w * _exp(-w)


def _extreme_cdf(z):
    w = _exp(torch.clamp(z, -50.0, 50.0))
    return 1.0 - _exp(-w)


_DISTS = {
    "normal": (_norm_pdf, _norm_cdf),
    "logistic": (_logis_pdf, _logis_cdf),
    "extreme": (_extreme_pdf, _extreme_cdf),
}


def _normal_hazard(z):
    """pdf(z) / (1 - cdf(z)) at any z: the exact ratio where erfc has
    range, the Mills-ratio asymptote (z + 1/z - 2/z^3) past z = 8."""
    zc = torch.clamp(z, max=8.0)
    direct = _norm_pdf(zc) / torch.clamp(0.5 * _erfc(div(zc, _SQRT2)),
                                         min=1e-30)
    zs = torch.clamp(z, min=1.0)
    asym = zs + div(1.0, zs) - div(2.0, zs * zs * zs)
    return torch.where(z > 8.0, asym, direct)


def _aft_params(p):
    dist = param(p, "aft_loss_distribution", "normal")
    sigma = float(param(p, "aft_loss_distribution_scale", 1.0) or 1.0)
    if dist not in _DISTS:
        raise ValueError(f"unknown aft_loss_distribution {dist!r}; use "
                         f"{sorted(_DISTS)}")
    return dist, sigma


@register("survival:aft")
class AFT(ObjFunction):
    """Accelerated failure time with censoring, in the reference's closed
    forms per distribution for uncensored, right-, left- and
    interval-censored rows (``label_lower == label_upper``, an infinite
    upper bound, a lower bound of 0, and the rest), gradients clipped to
    +-15 and hessians to [1e-16, 15]."""

    def _loglik(self, margin, y_lower, y_upper):
        """Interval log-likelihood per row (the ``aft-nloglik`` metric's;
        training uses the closed-form gradients)."""
        dist, sigma = _aft_params(self.params)
        pdf, cdf = _DISTS[dist]
        log = lambda x: f64(torch.log, x)  # noqa: E731
        log_yl = log(torch.clamp(y_lower, min=_EPS))
        z_l = div(log_yl - margin, sigma)
        uncensored = y_upper == y_lower
        finite_u = torch.isfinite(y_upper)
        log_yu = log(torch.clamp(torch.where(finite_u, y_upper, 1.0),
                                 min=_EPS))
        z_u = div(log_yu - margin, sigma)
        # the uncensored density carries the 1/(sigma * y) Jacobian
        # (survival_util.h AFTLoss::Loss): constant in the margin, but the
        # metric's value includes it
        ll_unc = log(torch.clamp(pdf(z_l), min=_EPS)
                     / (sigma * torch.clamp(y_lower, min=_EPS)))
        ll_right = log(torch.clamp(1.0 - cdf(z_l), min=_EPS))
        ll_int = log(torch.clamp(cdf(z_u) - cdf(z_l), min=_EPS))
        return torch.where(uncensored, ll_unc,
                           torch.where(~finite_u, ll_right, ll_int))

    def get_gradient(self, margin, label, weight, iteration=0, *,
                     label_lower=None, label_upper=None, **kw):
        y_l = (label if label_lower is None else label_lower).float()
        y_u = (label if label_upper is None else label_upper).float()
        dist, sigma = _aft_params(self.params)
        s2 = sigma ** 2
        log = lambda x: f64(torch.log, x)  # noqa: E731
        inf = float("inf")
        log_yl = torch.where(y_l > 0, log(torch.clamp(y_l, min=_EPS)), -inf)
        finite_u = torch.isfinite(y_u)
        log_yu = torch.where(finite_u, log(torch.clamp(
            torch.where(finite_u, y_u, 1.0), min=_EPS)), inf)
        z_l = div(log_yl - margin, sigma)  # -inf where y_l == 0
        z_u = div(log_yu - margin, sigma)  # +inf where right-censored
        fin_l, fin_u = torch.isfinite(z_l), torch.isfinite(z_u)
        zl_f = torch.where(fin_l, z_l, 0.0)
        zu_f = torch.where(fin_u, z_u, 0.0)

        if dist == "normal":
            pdf_l = torch.where(fin_l, _norm_pdf(zl_f), 0.0)
            pdf_u = torch.where(fin_u, _norm_pdf(zu_f), 0.0)
            dpdf_l = -zl_f * pdf_l  # pdf'(z); 0 at infinite z
            dpdf_u = -zu_f * pdf_u
            cdf_l = torch.where(fin_l, _norm_cdf(zl_f), 0.0)
            cdf_u = torch.where(fin_u, _norm_cdf(zu_f), 1.0)
            g_unc = div(-z_l, sigma)
            h_unc = div(torch.ones_like(margin), s2)
            hz = _normal_hazard(zl_f)  # right-censored hazard
            g_right = div(-hz, sigma)
            h_right = div(hz * (hz - zl_f), s2)
            rh = _normal_hazard(-zu_f)  # left-censored: the mirrored hazard
            g_left = div(rh, sigma)
            h_left = div(rh * (rh + zu_f), s2)
        elif dist == "logistic":
            sig_l = _logis_cdf(zl_f)
            sig_u = _logis_cdf(zu_f)
            pdf_l = torch.where(fin_l, _logis_pdf(zl_f), 0.0)
            pdf_u = torch.where(fin_u, _logis_pdf(zu_f), 0.0)
            dpdf_l = pdf_l * (1.0 - 2.0 * sig_l)
            dpdf_u = pdf_u * (1.0 - 2.0 * sig_u)
            cdf_l = torch.where(fin_l, sig_l, 0.0)
            cdf_u = torch.where(fin_u, sig_u, 1.0)
            g_unc = div(1.0 - 2.0 * sig_l, sigma)
            h_unc = div(2.0 * pdf_l, s2)
            g_right = div(-sig_l, sigma)  # pdf/S = sigmoid(z), exact
            h_right = div(pdf_l, s2)
            g_left = div(1.0 - sig_u, sigma)  # pdf/F = sigmoid(-z), exact
            h_left = div(pdf_u, s2)
        else:  # extreme (Gumbel minimum)
            w_l = _exp(torch.clamp(zl_f, -50.0, 50.0))
            w_u = _exp(torch.clamp(zu_f, -50.0, 50.0))
            pdf_l = torch.where(fin_l, _extreme_pdf(zl_f), 0.0)
            pdf_u = torch.where(fin_u, _extreme_pdf(zu_f), 0.0)
            dpdf_l = pdf_l * (1.0 - w_l)
            dpdf_u = pdf_u * (1.0 - w_u)
            cdf_l = torch.where(fin_l, _extreme_cdf(zl_f), 0.0)
            cdf_u = torch.where(fin_u, _extreme_cdf(zu_f), 1.0)
            g_unc = div(1.0 - w_l, sigma)
            h_unc = div(w_l, s2)
            g_right = div(-w_l, sigma)  # pdf/S = w, exact
            h_right = div(w_l, s2)
            # left-censored: pdf/F = w/(e^w - 1), exact through expm1
            E = f64(torch.expm1, torch.clamp(w_u, max=80.0))
            g_left = div(w_u / torch.clamp(E, min=1e-30), sigma)
            h_left = div(w_u * (w_u * (E + 1.0) - E)
                         / torch.clamp(E * E, min=1e-30), s2)

        # interval- and left-censored shared form: loss = -log(F_u - F_l)
        D = cdf_u - cdf_l
        N = pdf_u - pdf_l
        Dc = torch.clamp(D, min=1e-30)
        g_int = N / (sigma * Dc)
        h_int = g_int * g_int + (dpdf_l - dpdf_u) / (s2 * Dc)

        uncensored = y_u == y_l
        right = ~finite_u
        left = y_l <= 0  # z_l = -inf: pure left censoring
        grad = torch.where(uncensored, g_unc, torch.where(
            right, g_right, torch.where(left, g_left, g_int)))
        hess = torch.where(uncensored, h_unc, torch.where(
            right, h_right, torch.where(left, h_left, h_int)))

        # doubly saturated tails (D underflowed to 0): rail with the sign
        # of the side the prediction fell past, as the double-precision
        # reference saturates through its clip (survival_util.h)
        blown = ~torch.isfinite(grad) | (~uncensored & ~right & ~left
                                         & (D <= 0))
        zsum = z_u + z_l
        rail = torch.where(zsum < 0, _MAX_G, -_MAX_G)
        rail = torch.where(torch.isfinite(zsum), rail,
                           torch.where(zu_f + zl_f < 0, _MAX_G, -_MAX_G))
        grad = torch.where(blown, rail, grad)
        hess = torch.where(blown | ~torch.isfinite(hess), _MAX_G, hess)
        grad = torch.clamp(grad, -_MAX_G, _MAX_G)
        hess = torch.clamp(hess, _MIN_H, _MAX_G)
        return apply_weight(grad, hess, weight)

    def pred_transform(self, margin):
        return _exp(margin)

    def eval_transform(self, margin):
        # the AFT metrics read the untransformed (log-space) score
        # (reference aft_obj.cu:117)
        return margin

    def prob_to_margin(self, base_score):
        return math.log(max(base_score, 1e-16))

    def default_metric(self):
        return "aft-nloglik"


@register("survival:cox")
class CoxPH(ObjFunction):
    """Cox partial likelihood (reference ``regression_obj.cu:304``:
    negative labels mark censored rows). Rows are taken in ascending
    ``|label|`` by a stable sort (``MetaInfo::LabelAbsSort``), tied times
    share one risk-set denominator (Breslow, the ``last_abs_y < abs_y``
    gate at :354), and ``r_k``/``s_k`` sum 1/denominator over the event
    rows up to and including each row. All in float64, rounded once."""

    def get_gradient(self, margin, label, weight, iteration=0, **kw):
        n = margin.shape[0]
        abs_y = torch.abs(label)
        order = torch.argsort(abs_y, stable=True)
        exp_s = torch.exp(margin.double())[order]
        ys = label[order]
        abs_s = abs_y[order]
        # the risk set of a row is the suffix from its tie group's first
        # row
        suffix = torch.flip(torch.cumsum(torch.flip(exp_s, [0]), 0), [0])
        idx = torch.arange(n, device=margin.device)
        first = torch.ones(n, dtype=torch.bool, device=margin.device)
        first[1:] = abs_s[1:] != abs_s[:-1]
        group_start = torch.cummax(torch.where(first, idx, 0), 0).values
        denom = torch.clamp(suffix[group_start], min=1e-30)
        event = ys > 0
        zero = torch.zeros_like(denom)
        r_k = torch.cumsum(torch.where(event, 1.0 / denom, zero), 0)
        s_k = torch.cumsum(torch.where(event, 1.0 / (denom * denom), zero), 0)
        grad_s = exp_s * r_k - event.double()
        hess_s = exp_s * r_k - exp_s * exp_s * s_k
        grad = torch.empty_like(grad_s).index_copy_(0, order, grad_s)
        hess = torch.empty_like(hess_s).index_copy_(0, order, hess_s)
        return apply_weight(grad.to(margin.dtype), hess.to(margin.dtype),
                            weight)

    def pred_transform(self, margin):
        return _exp(margin)

    def default_metric(self):
        return "cox-nloglik"
