"""Sampling warps (core/warp.py counterpart): the ones the surface path,
the emitters, shape sampling and the sensors call."""

from __future__ import annotations

import math

import torch

from .math import safe_sqrt

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
INV_FOUR_PI = 1.0 / (4.0 * math.pi)


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


def square_to_uniform_triangle(sample):
    """Barycentric (u, v) with u + v <= 1."""
    t = safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - t, t * sample[..., 1]], dim=-1)


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


def square_to_uniform_cone(sample, cos_cutoff):
    """A uniform direction in the cone of cos_cutoff around +z."""
    ct = 1.0 - (1.0 - cos_cutoff) * sample[..., 1]
    st = safe_sqrt(1.0 - ct * ct)
    phi = TWO_PI * sample[..., 0]
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)


def square_to_uniform_cone_pdf(d, cos_cutoff):
    return torch.where(d[..., 2] >= cos_cutoff,
                       (1.0 / TWO_PI) / (1.0 - cos_cutoff), 0.0)
