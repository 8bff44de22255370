"""Microfacet normal distributions, GGX and Beckmann (render/microfacet.py
counterpart; microfacet.h): the density, Smith shadowing-masking and
visible-normal sampling, isotropic or anisotropic (alpha_u, alpha_v), in
the local shading frame (+z the normal).

GGX samples visible normals after Heitz 2018; Beckmann inverts the
visible-slope CDF of Heitz and d'Eon 2014 with three Newton steps in erf
space, as the reference does."""

from __future__ import annotations

import math

import torch

from ..core.math import cross, dot, normalize, safe_sqrt, sqr

GGX = 0
BECKMANN = 1

_TYPE_NAMES = {"ggx": GGX, "beckmann": BECKMANN}

_SQRT_PI_INV = 1.0 / math.sqrt(math.pi)


def distr_type(name: str) -> int:
    return _TYPE_NAMES[name]


def _alpha2(m, alpha_u, alpha_v):
    return sqr(m[..., 0] / alpha_u) + sqr(m[..., 1] / alpha_v)


def eval_d(dist_type: int, m, alpha_u, alpha_v):
    """The microfacet density D(m); zero on the lower hemisphere."""
    cos2 = sqr(m[..., 2])
    az = alpha_u * alpha_v
    if dist_type == GGX:
        t = _alpha2(m, alpha_u, alpha_v) + cos2
        d = 1.0 / torch.clamp(math.pi * az * sqr(t), min=1e-20)
    else:
        d = torch.exp(-_alpha2(m, alpha_u, alpha_v)
                      / torch.clamp(cos2, min=1e-12)) \
            / torch.clamp(math.pi * az * sqr(cos2), min=1e-20)
    return torch.where(m[..., 2] > 0.0, d, 0.0)


def smith_g1(dist_type: int, v, m, alpha_u, alpha_v):
    """Smith's mono-directional shadowing G1(v, m)."""
    cz = v[..., 2]
    xy_alpha_2 = sqr(alpha_u * v[..., 0]) + sqr(alpha_v * v[..., 1])
    tan2 = xy_alpha_2 / torch.clamp(sqr(cz), min=1e-12)
    if dist_type == GGX:
        g = 2.0 / (1.0 + torch.sqrt(1.0 + tan2))
    else:
        a = 1.0 / torch.clamp(torch.sqrt(tan2), min=1e-12)
        a2 = sqr(a)
        g = torch.where(a >= 1.6, 1.0, (3.535 * a + 2.181 * a2)
                        / (1.0 + 2.276 * a + 2.577 * a2))
    # v must lie on m's side of the surface
    ok = dot(v, m) * cz > 0.0
    g = torch.where(xy_alpha_2 == 0.0, 1.0, torch.where(ok, g, 0.0))
    return torch.where(ok, g, 0.0)


def g_smith(dist_type: int, wi, wo, m, alpha_u, alpha_v):
    """The separable Smith shadowing-masking G(wi, wo, m)."""
    return smith_g1(dist_type, wi, m, alpha_u, alpha_v) \
        * smith_g1(dist_type, wo, m, alpha_u, alpha_v)


def _sample_ggx_vndf(wi, alpha_u, alpha_v, sample):
    """Heitz 2018; wi in the upper hemisphere."""
    vh = normalize(torch.stack([alpha_u * wi[..., 0], alpha_v * wi[..., 1],
                                wi[..., 2]], dim=-1))
    lensq = sqr(vh[..., 0]) + sqr(vh[..., 1])
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                     torch.zeros_like(inv_len)], dim=-1),
        torch.tensor([1.0, 0.0, 0.0], device=vh.device).expand_as(vh))
    t2 = cross(vh, t1)
    r = torch.sqrt(sample[..., 0])
    phi = 2.0 * math.pi * sample[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - sqr(p1)) + s * p2
    nh = p1[..., None] * t1 + p2[..., None] * t2 \
        + safe_sqrt(1.0 - sqr(p1) - sqr(p2))[..., None] * vh
    return normalize(torch.stack([alpha_u * nh[..., 0], alpha_v * nh[..., 1],
                                  torch.clamp(nh[..., 2], min=1e-6)], dim=-1))


# Giles 2010's single-precision erfinv (the polynomial XLA evaluates for
# the reference's erfinv; torch.erfinv differs from it by up to 5.6e-6
# relative, which the Newton steps below amplify): (w < 5, w >= 5)
_ERFINV_COEFFS = (
    (2.81022636e-08, -0.000200214257), (3.43273939e-07, 0.000100950558),
    (-3.5233877e-06, 0.00134934322), (-4.39150654e-06, -0.00367342844),
    (0.00021858087, 0.00573950773), (-0.00125372503, -0.0076224613),
    (-0.00417768164, 0.00943887047), (0.246640727, 1.00167406),
    (1.50140941, 2.83297682))


def erfinv(x):
    """erfinv of x in (-1, 1), Giles' polynomial in w = -log(1 - x^2)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for lo, hi in _ERFINV_COEFFS:
        c = torch.where(lt, lo, hi)
        p = c if p is None else c + p * w
    return p * x


def _beckmann_sample_visible_11(cos_theta_i, u1, u2):
    """Visible slopes of the alpha = 1 Beckmann distribution."""
    ct = torch.clamp(cos_theta_i, -1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - sqr(ct), min=1e-20))
    tan_t = st / torch.clamp(ct, min=1e-6)
    cot_t = 1.0 / torch.clamp(tan_t, min=1e-6)

    # normal incidence: the slopes are a standard 2D gaussian
    r = torch.sqrt(-torch.log(torch.clamp(1.0 - u1, min=1e-10)))
    phi = 2.0 * math.pi * u2
    sx_normal = r * torch.cos(phi)
    sy_normal = r * torch.sin(phi)

    # tilted: invert the marginal visible-slope CDF in erf space
    c = torch.erf(cot_t)
    ux = torch.clamp(u1, min=1e-6)
    theta = torch.arccos(torch.clamp(ct, 0.0, 1.0))
    fit = 1.0 + theta * (-0.876 + theta * (0.4265 - 0.0594 * theta))
    b = c - (1.0 + c) * torch.pow(1.0 - ux, fit)
    norm = 1.0 / (1.0 + c + _SQRT_PI_INV * tan_t * torch.exp(-sqr(cot_t)))
    for _ in range(3):
        b = torch.minimum(torch.clamp(b, min=-0.9999), c - 1e-6)
        inv_erf = erfinv(b)
        value = norm * (1.0 + b + _SQRT_PI_INV * tan_t
                        * torch.exp(-sqr(inv_erf))) - ux
        deriv = norm * (1.0 - inv_erf * tan_t)
        b = b - value / torch.where(torch.abs(deriv) < 1e-10, 1e-10, deriv)
    sx_tilt = erfinv(torch.minimum(torch.clamp(b, min=-0.9999),
                                         c - 1e-6))
    sy_tilt = erfinv(torch.clamp(2.0 * torch.clamp(u2, min=1e-6) - 1.0,
                                       -0.9999, 0.9999))

    normal_inc = ct > 0.9999
    return (torch.where(normal_inc, sx_normal, sx_tilt),
            torch.where(normal_inc, sy_normal, sy_tilt))


def _sample_beckmann_vndf(wi, alpha_u, alpha_v, sample2):
    """Visible-normal Beckmann sampling; wi in the upper hemisphere."""
    wi_s = normalize(torch.stack([alpha_u * wi[..., 0], alpha_v * wi[..., 1],
                                  wi[..., 2]], dim=-1))
    sx, sy = _beckmann_sample_visible_11(wi_s[..., 2], sample2[..., 0],
                                         sample2[..., 1])
    lensq = sqr(wi_s[..., 0]) + sqr(wi_s[..., 1])
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    # near normal incidence phi is undefined: no rotation
    near_n = lensq < 1e-12
    cp = torch.where(near_n, 1.0, wi_s[..., 0] * inv_len)
    sp = torch.where(near_n, 0.0, wi_s[..., 1] * inv_len)
    rx = (cp * sx - sp * sy) * alpha_u
    ry = (sp * sx + cp * sy) * alpha_v
    return normalize(torch.stack([-rx, -ry, torch.ones_like(rx)], dim=-1))


def sample(dist_type: int, wi, alpha_u, alpha_v, sample2):
    """A visible microfacet normal seen from ``wi`` (flipped into the upper
    hemisphere first) -> (m, pdf)."""
    wi_u = torch.where((wi[..., 2] < 0.0)[..., None], -wi, wi)
    if dist_type == GGX:
        m = _sample_ggx_vndf(wi_u, alpha_u, alpha_v, sample2)
    else:
        m = _sample_beckmann_vndf(wi_u, alpha_u, alpha_v, sample2)
    return m, pdf(dist_type, wi_u, m, alpha_u, alpha_v)


def pdf(dist_type: int, wi, m, alpha_u, alpha_v):
    """The density of sample() in solid angle of m: G1(wi) |wi.m| D(m) /
    |cos_theta_i|."""
    wi_u = torch.where((wi[..., 2] < 0.0)[..., None], -wi, wi)
    d = eval_d(dist_type, m, alpha_u, alpha_v)
    g1 = smith_g1(dist_type, wi_u, m, alpha_u, alpha_v)
    return g1 * torch.abs(dot(wi_u, m)) * d \
        / torch.clamp(torch.abs(wi_u[..., 2]), min=1e-12)
