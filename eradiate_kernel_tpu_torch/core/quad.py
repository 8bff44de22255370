"""Quadrature rules (core/quad.py counterpart; Mitsuba's quad.h).

Every rule returns ``(nodes, weights)`` on [-1, 1] as float32 tensors; the
nodes are computed on the host in float64 (tiny, build-once tables).
"""

from __future__ import annotations

import numpy as np
import torch


def _out(x, w, device):
    return (torch.as_tensor(np.asarray(x, np.float32), device=device),
            torch.as_tensor(np.asarray(w, np.float32), device=device))


def gauss_legendre(n, device="cpu"):
    """Gauss-Legendre with n points: exact for degree 2n - 1."""
    if n < 1:
        raise ValueError("gauss_legendre: n must be >= 1")
    return _out(*np.polynomial.legendre.leggauss(int(n)), device)


def gauss_lobatto(n, device="cpu"):
    """Gauss-Lobatto with n points, both endpoints among them: exact for
    degree 2n - 3."""
    n = int(n)
    if n < 2:
        raise ValueError("gauss_lobatto: n must be >= 2")
    interior = np.polynomial.legendre.Legendre.basis(n - 1).deriv().roots()
    x = np.concatenate([[-1.0], np.sort(interior.real), [1.0]])
    pn = np.polynomial.legendre.legval(x, [0.0] * (n - 1) + [1.0])
    return _out(x, 2.0 / (n * (n - 1) * pn ** 2), device)


def composite_simpson(n, device="cpu"):
    """Composite Simpson over n (odd, >= 3) equally spaced points."""
    n = int(n)
    if n < 3 or n % 2 == 0:
        raise ValueError("composite_simpson: n must be odd and >= 3")
    h = 2.0 / (n - 1)
    w = np.full(n, 2.0)
    w[1::2] = 4.0
    w[0] = w[-1] = 1.0
    return _out(-1.0 + h * np.arange(n), w * (h / 3.0), device)


def composite_simpson_38(n, device="cpu"):
    """Composite Simpson 3/8 over n points, (n - 1) divisible by 3."""
    n = int(n)
    if n < 4 or (n - 1) % 3 != 0:
        raise ValueError("composite_simpson_38: need (n - 1) % 3 == 0, "
                         "n >= 4")
    h = 2.0 / (n - 1)
    w = np.full(n, 3.0)
    w[3::3] = 2.0
    w[0] = w[-1] = 1.0
    return _out(-1.0 + h * np.arange(n), w * (3.0 * h / 8.0), device)
