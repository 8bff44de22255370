"""Phase functions (phase/__init__.py counterpart): isotropic,
Henyey-Greenstein and Rayleigh.

Directions are sampled in a frame whose +z is the propagation direction
``ray.d``; ``phase_eval`` takes (wi, wo) with wi = -ray.d and returns the
pdf (every phase function here is a normalized pdf over the sphere).
"""

from __future__ import annotations

import math

import torch

from ..core.frame import Frame
from ..core.math import dot, safe_sqrt

INV_FOUR_PI = 1.0 / (4.0 * math.pi)


def _hg(cos_theta, g):
    temp = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_FOUR_PI * (1.0 - g * g) / torch.clamp(temp * safe_sqrt(temp),
                                                     min=1e-12)


def _rayleigh(cos_theta):
    return (3.0 / 16.0) / math.pi * (1.0 + cos_theta * cos_theta)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _sample_cos_theta(kind, params, slot, s1):
    """Inverse-CDF sample of cos(theta) between wo and +z (= ray.d)."""
    if kind == "isotropic":
        return 1.0 - 2.0 * s1
    if kind == "hg":
        g = params["g"][slot]
        safe_g = torch.where(torch.abs(g) < 1e-4, 1e-4, g)
        sqr_term = (1.0 - g * g) / (1.0 - g + 2.0 * g * s1)
        ct = (1.0 + g * g - sqr_term * sqr_term) / (2.0 * safe_g)
        return torch.where(torch.abs(g) < 1e-4, 1.0 - 2.0 * s1, ct)
    if kind == "rayleigh":
        # the exact inverse of the Rayleigh cdf (rayleigh.cpp:42-67)
        z = 2.0 * (2.0 * s1 - 1.0)
        tmp = torch.sqrt(z * z + 1.0)
        return torch.clamp(_cbrt(z + tmp) + _cbrt(z - tmp), -1.0, 1.0)
    raise NotImplementedError(f"phase {kind!r}: comes with slice 6")


def _kind_slot(scene, phase_idx, k):
    """(mask, slot) of phase kind k; other kinds' lanes read slot 0."""
    m = scene.phase_kind[phase_idx] == k
    return m, torch.where(m, scene.phase_slot[phase_idx], 0)


def phase_eval(scene, phase_idx, wi, wo, active=True):
    """Phase value (= pdf) for (wi, wo) world directions; wi = -ray.d."""
    ct = dot(wi, wo)
    out = torch.zeros_like(ct)
    for k, kind in enumerate(scene.config.phase_kinds):
        m, slot = _kind_slot(scene, phase_idx, k)
        if kind == "isotropic":
            v = torch.full_like(ct, INV_FOUR_PI)
        elif kind == "hg":
            v = _hg(ct, scene.phases["hg"]["g"][slot])
        elif kind == "rayleigh":
            v = _rayleigh(ct)
        else:
            raise NotImplementedError(f"phase {kind!r}: comes with slice 6")
        out = torch.where(m, v, out)
    return torch.where(torch.as_tensor(active, device=ct.device), out, 0.0)


def phase_sample(scene, phase_idx, ray_d, s1, s2, active=True):
    """Sample wo (world); returns (wo, pdf). Frame +z = ray.d."""
    ct = torch.zeros_like(s1)
    for k, kind in enumerate(scene.config.phase_kinds):
        m, slot = _kind_slot(scene, phase_idx, k)
        ct = torch.where(m, _sample_cos_theta(kind, scene.phases[kind], slot,
                                              s1), ct)
    st = safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * math.pi * s2[..., 1]
    wo_local = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    wo = Frame.from_normal(ray_d).to_world(wo_local)
    return wo, phase_eval(scene, phase_idx, -ray_d, wo, active)
