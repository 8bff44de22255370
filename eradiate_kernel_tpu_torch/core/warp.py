"""Sampling warps [0, 1)^2 -> disk, triangle, sphere, hemisphere, cone,
tent, normal, Beckmann and von Mises-Fisher domains, each with its pdf
at the warped point (core/warp.py counterpart; warp.h:27-434).

A parameter (alpha, kappa, a tent's nodes) may be a Python number or a
tensor. A Python number is divided as the reference divides by it
(core/rng.py::_div): CUDA would multiply by its reciprocal."""

from __future__ import annotations

import math

import torch

from .math import safe_sqrt, sqr
from .rng import _div

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
INV_TWO_PI = 1.0 / (2.0 * math.pi)
INV_FOUR_PI = 1.0 / (4.0 * math.pi)


def _over(x, y):
    """x / y, y a tensor or a Python number (then through _div)."""
    return x / y if torch.is_tensor(y) else _div(x, y)


def _f32_exp(x, like):
    """exp(x) of a Python number x in ``like``'s dtype and device, as the
    reference's jnp.exp of a Python number computes it; a tensor x
    directly."""
    if not torch.is_tensor(x):
        x = torch.tensor(x, dtype=like.dtype, device=like.device)
    return torch.exp(x)


def square_to_uniform_disk(sample):
    r = torch.sqrt(sample[..., 0])
    phi = TWO_PI * sample[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_uniform_disk_pdf(p):
    inside = torch.sum(p * p, dim=-1) <= 1.0
    return torch.where(inside, p.new_full((), INV_PI), 0.0)


def square_to_uniform_disk_concentric(sample):
    """Shirley-Chiu concentric mapping."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_1_or_3 = torch.abs(x) < torch.abs(y)
    r = torch.where(quadrant_1_or_3, y, x)
    rp = torch.where(quadrant_1_or_3, x, y)
    phi = 0.25 * math.pi * rp / torch.where(r == 0.0, 1.0, r)
    phi = torch.where(quadrant_1_or_3, 0.5 * math.pi - phi, phi)
    phi = torch.where(is_zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def uniform_disk_to_square_concentric(p):
    """The inverse of square_to_uniform_disk_concentric."""
    quadrant_0_or_2 = torch.abs(p[..., 0]) > torch.abs(p[..., 1])
    r_sign = torch.where(quadrant_0_or_2, p[..., 0], p[..., 1])
    sgn = torch.sign(r_sign + (r_sign == 0))
    r = torch.sqrt(torch.sum(p * p, dim=-1)) * sgn
    phi = torch.atan2(p[..., 1] * sgn, p[..., 0] * sgn)
    t = 4.0 / math.pi * phi
    t = torch.where(quadrant_0_or_2, t, 2.0 - t) * r
    a = torch.where(quadrant_0_or_2, r, t)
    b = torch.where(quadrant_0_or_2, t, r)
    return torch.stack([(a + 1.0) * 0.5, (b + 1.0) * 0.5], dim=-1)


def square_to_uniform_triangle(sample):
    """Barycentric (u, v) with u + v <= 1."""
    t = safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - t, t * sample[..., 1]], dim=-1)


def square_to_uniform_triangle_pdf(p):
    inside = (p[..., 0] >= 0) & (p[..., 1] >= 0) \
        & (p[..., 0] + p[..., 1] <= 1.0)
    return torch.where(inside, p.new_full((), 2.0), 0.0)


def square_to_uniform_sphere(sample):
    z = 1.0 - 2.0 * sample[..., 1]
    r = safe_sqrt(1.0 - z * z)
    phi = TWO_PI * sample[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere_pdf(d):
    return torch.full_like(d[..., 0], INV_FOUR_PI)


def square_to_uniform_hemisphere(sample):
    """Concentric low-distortion mapping (warp.h:158-173)."""
    p = square_to_uniform_disk_concentric(sample)
    z = 1.0 - torch.sum(p * p, dim=-1)
    scale = safe_sqrt(z + 1.0)
    return torch.stack([p[..., 0] * scale, p[..., 1] * scale, z], dim=-1)


def square_to_uniform_hemisphere_pdf(d):
    return torch.where(d[..., 2] >= 0, d.new_full((), INV_TWO_PI), 0.0)


def square_to_cosine_hemisphere(sample):
    p = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - torch.sum(p * p, dim=-1))
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp(d[..., 2], min=0.0) * INV_PI


def interval_to_linear(a, b, u):
    """Sample t in [0,1] with density proportional to lerp(a, b, t)."""
    denom = b - a
    t = (safe_sqrt(a * a + (b * b - a * a) * u) - a) / torch.where(
        torch.abs(denom) < 1e-12, 1e-12, denom)
    return torch.where(torch.abs(denom) < 1e-12 * (a + b), u,
                       torch.clamp(t, 0.0, 1.0))


def linear_to_interval(a, b, t):
    """Inverse of interval_to_linear: the CDF of the linear density."""
    denom = a + b
    u = t * (2.0 * a + (b - a) * t) / torch.where(torch.abs(denom) < 1e-12,
                                                  1e-12, denom)
    return torch.where(torch.abs(denom) < 1e-12, t, torch.clamp(u, 0.0, 1.0))


def square_to_bilinear(v00, v10, v01, v11, sample):
    """Sample [0,1]^2 with density proportional to the bilinear interpolant
    of corners v00 (x0, y0), v10 (x1, y0), v01 (x0, y1), v11 (x1, y1).
    Returns (position, the interpolant at the position)."""
    y = interval_to_linear(v00 + v10, v01 + v11, sample[..., 1])
    c0 = v00 * (1 - y) + v01 * y
    c1 = v10 * (1 - y) + v11 * y
    x = interval_to_linear(c0, c1, sample[..., 0])
    return torch.stack([x, y], -1), c0 * (1 - x) + c1 * x


def bilinear_to_square(v00, v10, v01, v11, pos):
    """Inverse of square_to_bilinear: (sample, interpolant at pos)."""
    x = pos[..., 0]
    y = pos[..., 1]
    c0 = v00 * (1 - y) + v01 * y
    c1 = v10 * (1 - y) + v11 * y
    return (torch.stack([linear_to_interval(c0, c1, x),
                         linear_to_interval(v00 + v10, v01 + v11, y)], -1),
            c0 * (1 - x) + c1 * x)


def square_to_bilinear_pdf(v00, v10, v01, v11, pos):
    x = pos[..., 0]
    y = pos[..., 1]
    return ((v00 * (1 - x) + v10 * x) * (1 - y)
            + (v01 * (1 - x) + v11 * x) * y)


def square_to_uniform_cone(sample, cos_cutoff):
    """A uniform direction in the cone of cos_cutoff around +z."""
    ct = 1.0 - (1.0 - cos_cutoff) * sample[..., 1]
    st = safe_sqrt(1.0 - ct * ct)
    phi = TWO_PI * sample[..., 0]
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)


def square_to_uniform_cone_pdf(d, cos_cutoff):
    return torch.where(d[..., 2] >= cos_cutoff,
                       (1.0 / TWO_PI) / (1.0 - cos_cutoff), 0.0)


def square_to_tent(sample):
    """The 2D tent over [-1, 1]^2."""
    return torch.stack([interval_to_tent(sample[..., 0]),
                        interval_to_tent(sample[..., 1])], dim=-1)


def square_to_tent_pdf(p):
    inside = torch.all(torch.abs(p) <= 1.0, dim=-1)
    return torch.where(inside, (1.0 - torch.abs(p[..., 0]))
                       * (1.0 - torch.abs(p[..., 1])), 0.0)


def interval_to_tent(sample):
    """[0, 1) -> [-1, 1], tent-distributed."""
    t = sample - 0.5
    return torch.sign(t) * (1.0 - safe_sqrt(1.0 - 2.0 * torch.abs(t)))


def interval_to_nonuniform_tent(a, b, c, sample):
    """The tent of nodes a < b < c."""
    factor_lo = (a - b) / (a - c)  # the left side's probability
    left = sample < factor_lo
    s = torch.where(left, _over(sample, factor_lo),
                    _over(sample - factor_lo, 1.0 - factor_lo))
    return torch.where(left, a + (b - a) * safe_sqrt(s),
                       c + (b - c) * safe_sqrt(1.0 - s))


def square_to_std_normal(sample):
    """Box-Muller."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - sample[..., 0],
                                                min=1e-38)))
    phi = TWO_PI * sample[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_std_normal_pdf(p):
    return INV_TWO_PI * torch.exp(-0.5 * torch.sum(p * p, dim=-1))


def square_to_beckmann(sample, alpha):
    phi = TWO_PI * sample[..., 0]
    log_arg = torch.clamp(1.0 - sample[..., 1], min=1e-38)
    tan_theta_2 = -sqr(alpha) * torch.log(log_arg)
    ct = 1.0 / torch.sqrt(1.0 + tan_theta_2)
    st = safe_sqrt(1.0 - ct * ct)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)


def square_to_beckmann_pdf(m, alpha):
    """D_beckmann(m) cos(theta_m), the pdf of square_to_beckmann."""
    ct = m[..., 2]
    ct2 = sqr(ct)
    tt2 = (1.0 - ct2) / torch.clamp(ct2, min=1e-20)
    a2 = sqr(alpha)
    pdf = torch.exp(_over(-tt2, a2)) / (math.pi * a2 * torch.clamp(
        ct2 * ct, min=1e-20))
    return torch.where(ct > 1e-9, pdf, 0.0)


def square_to_von_mises_fisher(sample, kappa):
    """The vMF distribution of concentration kappa around +z."""
    sy = torch.clamp(sample[..., 1], min=1e-7)
    ct = 1.0 + _over(torch.log(sy + (1.0 - sy) * _f32_exp(-2.0 * kappa, sy)),
                     kappa)
    st = safe_sqrt(1.0 - ct * ct)
    phi = TWO_PI * sample[..., 0]
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)


def square_to_von_mises_fisher_pdf(d, kappa):
    return (torch.exp(kappa * (d[..., 2] - 1.0)) * (kappa * INV_TWO_PI)
            / (1.0 - _f32_exp(-2.0 * kappa, d)))
