"""Phase functions (phase/__init__.py counterpart): isotropic,
Henyey-Greenstein, Rayleigh, tabulated (``tabphase``) and the weighted mix
of two of them (``blendphase``).

Directions are sampled in a frame whose +z is the propagation direction
``ray.d``; ``phase_eval`` takes (wi, wo) with wi = -ray.d and returns the
pdf (every phase function here is a normalized pdf over the sphere).

A tabphase row holds ``nodes`` and ``values`` (n, K) of the phase function
over the cosine of the scattering angle, the cumulative trapezoid ``cdf``
(n, K - 1), its ``integral`` and the row's node ``count`` (rows of several
tables are zero-padded to one K). A blendphase row holds its ``weight`` and
the phase indices ``phase0`` and ``phase1`` of its children, which are not
blendphases themselves.

``phase_mueller`` and ``phase_sample_mueller`` are the polarized
counterparts: the scalar value times the identity for every kind but
``rayleigh``, whose lanes take the Rayleigh scattering matrix rotated
through the scattering plane.
"""

from __future__ import annotations

import math

import torch

from ..core import mueller as mu
from ..core.frame import Frame
from ..core.math import cross, dot, safe_sqrt

INV_FOUR_PI = 1.0 / (4.0 * math.pi)


def _hg(cos_theta, g):
    temp = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_FOUR_PI * (1.0 - g * g) / torch.clamp(temp * safe_sqrt(temp),
                                                     min=1e-12)


def _rayleigh(cos_theta):
    return (3.0 / 16.0) / math.pi * (1.0 + cos_theta * cos_theta)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _count_le(table, slot, x):
    """sum(x >= table[slot], -1) per lane: the count of a lane's row
    entries at or below x, ties included. One sorted search a row of the
    (n, K) table (the count does not depend on the row's order, so padded
    rows count their padding as the reference's sum does), not a
    comparison of every lane against a gathered (K,) row."""
    out = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for r in range(table.shape[0]):
        row = torch.sort(table[r]).values
        out = torch.where(slot == r, torch.searchsorted(
            row, x.contiguous(), right=True), out)
    return out


def _tab_eval(params, slot, cos_theta):
    """The tabulated phase function at ``cos_theta`` (the cosine between
    ray.d and wo): linear in the nodes, normalised so that its sphere
    integral is 1, f / (2 pi integral)."""
    nodes, vals = params["nodes"], params["values"]
    K = vals.shape[-1]
    cnt = params["count"][slot]
    idx = torch.clamp(_count_le(nodes, slot, cos_theta) - 1, 0, K - 2)
    idx = torch.minimum(idx, torch.clamp(cnt - 2, min=0).long())
    x0, x1 = nodes[slot, idx], nodes[slot, idx + 1]
    y0, y1 = vals[slot, idx], vals[slot, idx + 1]
    f = torch.clamp((cos_theta - x0) / torch.clamp(x1 - x0, min=1e-9), 0.0,
                    1.0)
    v = y0 * (1 - f) + y1 * f
    return v / torch.clamp(2.0 * math.pi * params["integral"][slot],
                           min=1e-12)


def _sample_tab(params, slot, s1):
    """Inverse-cdf sample of cos(theta) from a tabulated phase function:
    the segment by the cumulative table, then the root of the linear
    pdf's quadratic within it."""
    cdf, nodes, vals = params["cdf"], params["nodes"], params["values"]
    K = nodes.shape[-1]
    u = s1 * params["integral"][slot]
    seg = torch.clamp(_count_le(cdf, slot, u), 0, K - 2)
    cdf_lo = torch.where(seg > 0, cdf[slot, torch.clamp(seg - 1, min=0)],
                         0.0)
    u_loc = u - cdf_lo
    x0, x1 = nodes[slot, seg], nodes[slot, seg + 1]
    y0, y1 = vals[slot, seg], vals[slot, seg + 1]
    dx = torch.clamp(x1 - x0, min=1e-9)
    slope = (y1 - y0) / dx
    disc = torch.clamp(y0 * y0 + 2.0 * slope * u_loc, min=0.0)
    tq = 2.0 * u_loc / torch.clamp(y0 + torch.sqrt(disc), min=1e-12)
    t_lin = u_loc / torch.clamp(y0, min=1e-12)
    t = torch.where(torch.abs(slope) * dx
                    < 1e-9 * torch.clamp(y0, min=1e-9), t_lin, tq)
    return torch.clamp(x0 + torch.minimum(torch.clamp(t, min=0.0), dx),
                       -1.0, 1.0)


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
    if kind == "tabphase":
        return _sample_tab(params, slot, s1)
    raise ValueError(f"phase {kind!r} samples through its children")


def _kind_slot(scene, phase_idx, k):
    """(mask, slot) of phase kind k; other kinds' lanes read slot 0."""
    m = scene.phase_kind[phase_idx] == k
    return m, torch.where(m, scene.phase_slot[phase_idx], 0)


def _eval_kind(scene, kind, slot, ct):
    """The value of a non-blend phase kind at ct = dot(wi, wo)."""
    if kind == "isotropic":
        return torch.full_like(ct, INV_FOUR_PI)
    if kind == "hg":
        return _hg(ct, scene.phases["hg"]["g"][slot])
    if kind == "rayleigh":
        return _rayleigh(ct)
    # tabulated over the scattering angle: cos = dot(ray.d, wo) = -ct
    return _tab_eval(scene.phases["tabphase"], slot, -ct)


def _over_children(scene, child, fn, like):
    """fn(kind, slot) of each lane's child phase ``child`` (phase
    indices), swept over the non-blend kinds."""
    out = torch.zeros_like(like)
    for k, kind in enumerate(scene.config.phase_kinds):
        if kind != "blendphase":
            m, slot = _kind_slot(scene, child, k)
            out = torch.where(m, fn(kind, slot), out)
    return out


def phase_eval(scene, phase_idx, wi, wo, active=True):
    """Phase value (= pdf) for (wi, wo) world directions; wi = -ray.d."""
    ct = dot(wi, wo)
    out = torch.zeros_like(ct)
    for k, kind in enumerate(scene.config.phase_kinds):
        m, slot = _kind_slot(scene, phase_idx, k)
        if kind == "blendphase":
            params = scene.phases["blendphase"]
            w = params["weight"][slot]
            child = lambda key: _over_children(
                scene, params[key][slot],
                lambda kd, cs: _eval_kind(scene, kd, cs, ct), ct)
            v = (1.0 - w) * child("phase0") + w * child("phase1")
        else:
            v = _eval_kind(scene, kind, slot, ct)
        out = torch.where(m, v, out)
    return torch.where(torch.as_tensor(active, device=ct.device), out, 0.0)


def phase_sample(scene, phase_idx, ray_d, s1, s2, active=True):
    """Sample wo (world); returns (wo, pdf). Frame +z = ray.d. A
    blendphase picks its child by ``s1 < weight`` and hands it s1
    renormalised; the pdf is the mixture's (phase_eval)."""
    ct = torch.zeros_like(s1)
    for k, kind in enumerate(scene.config.phase_kinds):
        m, slot = _kind_slot(scene, phase_idx, k)
        if kind == "blendphase":
            params = scene.phases["blendphase"]
            w = params["weight"][slot]
            pick1 = s1 < w
            s1r = torch.where(pick1, s1 / torch.clamp(w, min=1e-12),
                              (s1 - w) / torch.clamp(1.0 - w, min=1e-12))
            child = torch.where(pick1, params["phase1"][slot],
                                params["phase0"][slot])
            v = _over_children(scene, child, lambda kd, cs: _sample_cos_theta(
                kd, scene.phases[kd], cs, s1r), s1)
        else:
            v = _sample_cos_theta(kind, scene.phases[kind], slot, s1)
        ct = torch.where(m, v, ct)
    st = safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * math.pi * s2[..., 1]
    wo_local = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    wo = Frame.from_normal(ray_d).to_world(wo_local)
    return wo, phase_eval(scene, phase_idx, -ray_d, wo, active)


def phase_mueller(scene, phase_idx, wi, wo, active=True):
    """The polarized phase eval: an (N, 4, 4) Mueller matrix in the
    implicit world-space Stokes bases (the convention of
    bsdfs.bsdf_eval_mueller) whose M[0, 0] is ``phase_eval``.

    Mitsuba's phase functions are scalar (phase.h:130-225), so its
    polarized variants scale the Mueller throughput by the phase value.
    So does every kind here but ``rayleigh``, which takes the Rayleigh
    scattering matrix rotated through the scattering plane (molecular
    scattering makes the dominant polarization of Earth atmospheres)."""
    value = phase_eval(scene, phase_idx, wi, wo, active)
    out = value[..., None, None] * torch.eye(4, dtype=value.dtype,
                                             device=value.device)
    if "rayleigh" not in scene.config.phase_kinds:
        return out
    # the light arrives along -wo and leaves along wi
    in_fwd = -wo
    out_fwd = wi
    m_plane = mu.rayleigh_scatter(dot(in_fwd, out_fwd))
    # the scattering plane's normal; for collinear directions sin^2 = 0
    # and any basis serves
    n = cross(in_fwd, out_fwd)
    n_len = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = torch.where(n_len > 1e-8, n / torch.clamp(n_len, min=1e-12),
                    mu.stokes_basis(in_fwd))
    m_world = mu.rotate_mueller_basis(
        m_plane, in_fwd, n, mu.stokes_basis(in_fwd),
        out_fwd, n, mu.stokes_basis(out_fwd))
    act = torch.as_tensor(active, device=value.device)
    for k, kind in enumerate(scene.config.phase_kinds):
        if kind == "rayleigh":
            m = (scene.phase_kind[phase_idx] == k) & act
            out = torch.where(m[..., None, None], m_world, out)
    return out


def phase_sample_mueller(scene, phase_idx, ray_d, s1, s2, active=True):
    """The polarized phase_sample: wo from the scalar sampler, its pdf and
    the Mueller importance weight (matrix / pdf; the identity for the
    polarization-preserving kinds, whose sampling is exact)."""
    wo, pdf = phase_sample(scene, phase_idx, ray_d, s1, s2, active)
    m = phase_mueller(scene, phase_idx, -ray_d, wo, active)
    den = torch.clamp(pdf, min=1e-20)[..., None, None]
    return wo, pdf, torch.where((pdf > 0)[..., None, None], m / den, 0.0)
