"""Catmull-Rom cubic splines (core/spline.py counterpart; Mitsuba's
spline.h): Hermite evaluation from samples with finite-difference
tangents, definite integration, monotone inversion and CDF sampling, on
uniform (``x_min``/``x_max``) or non-uniform (``nodes``) grids, vectorized
over the evaluation points.

As in the reference, the boundary cells take second-order one-sided
tangents (spline.h's are first order), so quadratics are reproduced on the
whole domain.
"""

from __future__ import annotations

import torch


def eval_spline(f0, f1, d0, d1, t):
    """The cubic Hermite basis on [0, 1]."""
    t2 = t * t
    t3 = t2 * t
    return ((2.0 * t3 - 3.0 * t2 + 1.0) * f0 + (-2.0 * t3 + 3.0 * t2) * f1
            + (t3 - 2.0 * t2 + t) * d0 + (t3 - t2) * d1)


def eval_spline_d(f0, f1, d0, d1, t):
    """The Hermite segment's value and derivative."""
    t2 = t * t
    deriv = ((6.0 * t2 - 6.0 * t) * (f0 - f1)
             + (3.0 * t2 - 4.0 * t + 1.0) * d0 + (3.0 * t2 - 2.0 * t) * d1)
    return eval_spline(f0, f1, d0, d1, t), deriv


def eval_spline_i(f0, f1, d0, d1):
    """The Hermite segment's integral over [0, 1]."""
    return 0.5 * (f0 + f1) + (d0 - d1) / 12.0


def _uniform_cell(values, i):
    """(f0, f1, d0, d1) of cells ``i`` of uniform samples: centered
    differences inside, second-order one-sided at the ends, in units of
    one cell."""
    n = values.shape[-1]
    f = lambda k: values[..., torch.clamp(k, 0, n - 1)]
    f0, f1, fm, fp = f(i), f(i + 1), f(i - 1), f(i + 2)
    d0 = torch.where(i > 0, 0.5 * (f1 - fm), -1.5 * f0 + 2.0 * f1 - 0.5 * fp)
    d1 = torch.where(i + 2 < n, 0.5 * (fp - f0),
                     1.5 * f1 - 2.0 * f0 + 0.5 * fm)
    return f0, f1, d0, d1


def eval_1d(x_min, x_max, values, x):
    """The Catmull-Rom interpolant of uniform samples ``values`` over
    [x_min, x_max] at ``x``."""
    values = torch.as_tensor(values)
    x = torch.as_tensor(x)
    n = values.shape[-1]
    u = torch.clamp((x - x_min) / ((x_max - x_min) / (n - 1)), 0.0,
                    n - 1 - 1e-6)
    i = torch.clamp(u.to(torch.int64), 0, n - 2)
    return eval_spline(*_uniform_cell(values, i), u - i.to(u.dtype))


def eval_1d_nonuniform(nodes, values, x):
    """The interpolant on a non-uniform grid: tangents are scaled finite
    differences over the neighbouring intervals."""
    nodes = torch.as_tensor(nodes)
    values = torch.as_tensor(values)
    x = torch.as_tensor(x)
    n = nodes.shape[-1]
    i = torch.clamp(torch.searchsorted(nodes, x.contiguous(), right=True)
                    - 1, 0, n - 2)
    x0 = nodes[i]
    x1 = nodes[i + 1]
    w = x1 - x0
    t = torch.clamp((x - x0) / w, 0.0, 1.0)
    f = lambda k: values[torch.clamp(k, 0, n - 1)]
    g = lambda k: nodes[torch.clamp(k, 0, n - 1)]
    f0, f1, fm, fp = f(i), f(i + 1), f(i - 1), f(i + 2)
    d0 = torch.where(i > 0, w * (f1 - fm) / (x1 - g(i - 1)), f1 - f0)
    d1 = torch.where(i + 2 < n, w * (fp - f0) / (g(i + 2) - x0), f1 - f0)
    return eval_spline(f0, f1, d0, d1, t)


def integrate_1d(x_min, x_max, values):
    """The interpolant's integral from x_min to every node: a cumsum of the
    segments' Hermite integrals."""
    values = torch.as_tensor(values)
    n = values.shape[-1]
    i = torch.arange(n - 1, device=values.device)
    seg = eval_spline_i(*_uniform_cell(values, i)) * ((x_max - x_min)
                                                     / (n - 1))
    return torch.cat([torch.zeros(values.shape[:-1] + (1,),
                                  dtype=values.dtype, device=values.device),
                      torch.cumsum(seg, -1)], -1)


def _newton(fn, target, n_iter):
    """t in [0, 1] with fn(t)[0] = target: bracketed Newton with a
    bisection fallback, a fixed number of steps. fn returns (value,
    derivative, derivative usable)."""
    lo = torch.zeros_like(target)
    hi = torch.ones_like(target)
    t = 0.5 * (lo + hi)
    for _ in range(n_iter):
        val, deriv, ok_d = fn(t)
        too_low = val < target
        lo = torch.where(too_low, t, lo)
        hi = torch.where(too_low, hi, t)
        t_newton = t - (val - target) / torch.where(ok_d, deriv, 1.0)
        ok = (t_newton > lo) & (t_newton < hi) & ok_d
        t = torch.where(ok, t_newton, 0.5 * (lo + hi))
    return t


def invert_1d(x_min, x_max, values, y, n_iter=16):
    """x with f(x) = y for a strictly increasing interpolant."""
    values = torch.as_tensor(values)
    y = torch.as_tensor(y)
    n = values.shape[-1]
    i = torch.clamp(torch.searchsorted(values, y.contiguous(), right=True)
                    - 1, 0, n - 2)
    f0, f1, d0, d1 = _uniform_cell(values, i)

    def fn(t):
        val, deriv = eval_spline_d(f0, f1, d0, d1, t)
        return val, deriv, torch.abs(deriv) > 1e-12

    t = _newton(fn, y, n_iter)
    return x_min + (i.to(t.dtype) + t) * ((x_max - x_min) / (n - 1))


def sample_1d(x_min, x_max, values, cdf, sample, n_iter=16):
    """Sample the density interpolant given its node CDF from
    ``integrate_1d``: (x, pdf)."""
    values = torch.as_tensor(values)
    cdf = torch.as_tensor(cdf)
    total = cdf[..., -1]
    y = torch.as_tensor(sample) * total
    n = values.shape[-1]
    width = (x_max - x_min) / (n - 1)
    i = torch.clamp(torch.searchsorted(cdf, y.contiguous(), right=True) - 1,
                    0, n - 2)
    f0, f1, d0, d1 = _uniform_cell(values, i)

    def fn(t):
        """The segment's antiderivative from 0 to t, and its density."""
        t2 = t * t
        t3 = t2 * t
        t4 = t2 * t2
        val = (f0 * (0.5 * t4 - t3 + t) + f1 * (-0.5 * t4 + t3)
               + d0 * (0.25 * t4 - (2.0 / 3.0) * t3 + 0.5 * t2)
               + d1 * (0.25 * t4 - t3 / 3.0))
        deriv = eval_spline(f0, f1, d0, d1, t)
        return val, deriv, deriv > 1e-12

    t = _newton(fn, (y - cdf[i]) / width, n_iter)
    x = x_min + (i.to(t.dtype) + t) * width
    return x, eval_spline(f0, f1, d0, d1, t) / torch.clamp(total, min=1e-20)
