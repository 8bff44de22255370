"""Special functions of the statistical test harnesses (utils/special.py
counterpart; mitsuba.python.math): the regularized upper incomplete gamma
function, which turns a chi^2 statistic into a p-value (the series and
continued-fraction expansions of Numerical Recipes), and the inverse
error function (Giles' polynomial). Plain Python and numpy on the host.
"""

from __future__ import annotations

import numpy as np

import math as _math


def gamma_q(a: float, x: float) -> float:
    """Upper regularized incomplete gamma Q(a, x) = Gamma(a,x)/Gamma(a)."""
    if x < 0 or a <= 0:
        raise ValueError("gamma_q domain error")
    if x == 0:
        return 1.0
    if x < a + 1.0:
        return 1.0 - _gser_math(a, x)
    return _gcf_math(a, x)


def _gser_math(a, x, eps=1e-14, max_iter=1000):
    gln = _math.lgamma(a)
    ap = a
    s = 1.0 / a
    term = s
    for _ in range(max_iter):
        ap += 1.0
        term *= x / ap
        s += term
        if abs(term) < abs(s) * eps:
            break
    return s * _math.exp(-x + a * _math.log(x) - gln)


def _gcf_math(a, x, eps=1e-14, max_iter=1000):
    gln = _math.lgamma(a)
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
    return _math.exp(-x + a * _math.log(x) - gln) * h


def chi2_p_value(stat: float, dof: int) -> float:
    """Survival function of the chi^2 distribution with ``dof`` degrees."""
    if dof <= 0:
        return 1.0
    return gamma_q(0.5 * dof, 0.5 * stat)


def erf_inv(y):
    """Inverse error function (vectorized), Giles 2010 polynomial approximation."""
    y = np.asarray(y, dtype=np.float64)
    w = -np.log(np.maximum((1.0 - y) * (1.0 + y), 1e-300))
    small = w < 5.0
    ws = w - 2.5
    p_small = 2.81022636e-08
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941):
        p_small = p_small * ws + c
    wl = np.sqrt(np.maximum(w, 5.0)) - 3.0
    p_large = -0.000200214257
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        p_large = p_large * wl + c
    return np.where(small, p_small, p_large) * y
