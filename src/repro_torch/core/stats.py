"""Minimal special-function toolkit (no scipy): regularized incomplete
gamma, gamma/chi-square quantiles, exponential-rate confidence intervals;
copy of ``repro.core.stats``.

Used by the MTTF model's Gamma CIs (paper Fig. 7: '90% confidence intervals
are generated by fitting a Gamma distribution')."""
from __future__ import annotations

import math

import numpy as np


def _gammaln(a: float) -> float:
    return math.lgamma(a)


def gammainc_p(a: float, x: float, *, eps: float = 1e-12,
               max_iter: int = 500) -> float:
    """Regularized lower incomplete gamma P(a, x) (Numerical Recipes)."""
    if x < 0 or a <= 0:
        raise ValueError("bad args")
    if x == 0:
        return 0.0
    if x < a + 1.0:
        # series representation
        ap = a
        summ = 1.0 / a
        delta = summ
        for _ in range(max_iter):
            ap += 1.0
            delta *= x / ap
            summ += delta
            if abs(delta) < abs(summ) * eps:
                break
        return summ * math.exp(-x + a * math.log(x) - _gammaln(a))
    # continued fraction for Q(a, x)
    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, max_iter + 1):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < eps:
            break
    q = math.exp(-x + a * math.log(x) - _gammaln(a)) * h
    return 1.0 - q


def gamma_quantile(p: float, shape: float, scale: float = 1.0) -> float:
    """Inverse CDF of Gamma(shape, scale) by bisection."""
    if not 0.0 < p < 1.0:
        raise ValueError("p in (0,1)")
    lo, hi = 0.0, shape * scale * 2 + 10 * scale
    while gammainc_p(shape, hi / scale) < p:
        hi *= 2.0
        if hi > 1e12 * scale:
            break
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if gammainc_p(shape, mid / scale) < p:
            lo = mid
        else:
            hi = mid
        if hi - lo < 1e-12 * max(hi, 1.0):
            break
    return 0.5 * (lo + hi)


def chi2_quantile(p: float, df: float) -> float:
    return gamma_quantile(p, df / 2.0, 2.0)


def poisson_rate_ci(n_events: int, exposure: float,
                    conf: float = 0.90) -> tuple[float, float]:
    """Exact (Gamma/chi-square) CI for a Poisson rate: events per unit
    exposure.  Returns (lo, hi)."""
    alpha = 1.0 - conf
    if n_events == 0:
        lo = 0.0
    else:
        lo = chi2_quantile(alpha / 2.0, 2.0 * n_events) / (2.0 * exposure)
    hi = chi2_quantile(1.0 - alpha / 2.0, 2.0 * (n_events + 1)) / (2.0 * exposure)
    return lo, hi


def mttf_ci(n_failures: int, total_time: float,
            conf: float = 0.90) -> tuple[float, float]:
    """CI for MTTF = 1/rate; (lo, hi) in the same units as total_time."""
    rlo, rhi = poisson_rate_ci(n_failures, total_time, conf)
    lo = 1.0 / rhi if rhi > 0 else float("inf")
    hi = 1.0 / rlo if rlo > 0 else float("inf")
    return lo, hi
