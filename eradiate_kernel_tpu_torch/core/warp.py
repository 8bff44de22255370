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
