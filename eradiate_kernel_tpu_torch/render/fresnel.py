"""Fresnel equations and specular directions (render/fresnel.py
counterpart; fresnel.h and ior.h): the unpolarized dielectric and
conductor terms, total internal reflection, the diffuse Fresnel
reflectance fit of the plastics, and reflect/refract about the local
normal (+z) or a microfacet normal m. The IOR table and the conductor
presets are the port's own copies of the reference's."""

from __future__ import annotations

import torch

from ..core.math import dot, safe_sqrt, sqr


def fresnel(cos_theta_i, eta):
    """Unpolarized dielectric Fresnel term. ``cos_theta_i`` (N,) is signed
    against the normal, ``eta`` the relative IOR (transmitted / incident
    side). Returns (r, cos_theta_t, eta_it, eta_ti): the reflectance (1
    under TIR), the signed cosine of the transmitted direction, the
    relative IOR along the crossing and its reciprocal."""
    eta = torch.as_tensor(eta, dtype=cos_theta_i.dtype,
                          device=cos_theta_i.device)
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)

    cos_theta_t_sqr = 1.0 - sqr(eta_ti) * (1.0 - sqr(cos_theta_i))
    cos_i_abs = torch.abs(cos_theta_i)
    cos_t_abs = safe_sqrt(cos_theta_t_sqr)

    denom_s = cos_i_abs + eta_it * cos_t_abs
    denom_p = eta_it * cos_i_abs + cos_t_abs
    a_s = (cos_i_abs - eta_it * cos_t_abs) / torch.where(denom_s == 0, 1.0,
                                                         denom_s)
    a_p = (eta_it * cos_i_abs - cos_t_abs) / torch.where(denom_p == 0, 1.0,
                                                         denom_p)
    r = 0.5 * (sqr(a_s) + sqr(a_p))

    tir = cos_theta_t_sqr <= 0.0
    r = torch.where(tir | (cos_i_abs == 0.0), 1.0, r)
    r = torch.where(eta == 1.0, 0.0, r)

    cos_theta_t = -torch.sign(cos_theta_i) * cos_t_abs
    cos_theta_t = torch.where(tir, 0.0, cos_theta_t)
    return r, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta_r, eta_i):
    """Unpolarized conductor Fresnel term: ``eta_r``/``eta_i`` (N, nc) the
    real and imaginary parts of the complex relative IOR, ``cos_theta_i``
    (N,). Returns (N, nc)."""
    ct = torch.abs(cos_theta_i)[..., None]
    cos2 = sqr(ct)
    sin2 = 1.0 - cos2
    eta2 = sqr(eta_r)
    k2 = sqr(eta_i)

    t0 = eta2 - k2 - sin2
    a2pb2 = safe_sqrt(sqr(t0) + 4.0 * eta2 * k2)
    t1 = a2pb2 + cos2
    a = safe_sqrt(torch.clamp(0.5 * (a2pb2 + t0), min=0.0))
    t2 = 2.0 * a * ct
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = cos2 * a2pb2 + sqr(sin2)
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rs + rp)


def fresnel_diffuse_reflectance(eta: float) -> float:
    """Hemispherically integrated Fresnel reflectance under diffuse
    illumination (the fast fit of fresnel.h), for a host-side float, in
    float32 as the reference computes it."""
    e = torch.tensor(eta, dtype=torch.float32)
    inv_eta = 1.0 / e
    lo = -1.4399 * sqr(e) + 0.7099 * e + 0.6681 + 0.0636 * inv_eta
    i2 = sqr(inv_eta)
    i3 = i2 * inv_eta
    i4 = i2 * i2
    i5 = i4 * inv_eta
    hi = (0.919317 - 3.4793 * inv_eta + 6.75335 * i2
          - 7.80989 * i3 + 4.98554 * i4 - 1.36881 * i5)
    return float(torch.where(e < 1.0, lo, hi))


def reflect(wi):
    """Mirror about the local +z normal."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def reflect_m(wi, m):
    """Mirror about the microfacet normal m."""
    return 2.0 * dot(wi, m, keepdims=True) * m - wi


def refract(wi, cos_theta_t, eta_ti):
    """Refract about the local +z normal (cos_theta_t, eta_ti from
    fresnel())."""
    return torch.stack([-eta_ti * wi[..., 0], -eta_ti * wi[..., 1],
                        cos_theta_t], dim=-1)


def refract_m(wi, m, cos_theta_t, eta_ti):
    """Refract about the microfacet normal m."""
    proj = dot(wi, m, keepdims=True) * eta_ti[..., None] \
        + cos_theta_t[..., None]
    return m * proj - wi * eta_ti[..., None]


# the IOR database (ior.h lookup_ior)
IOR_DATABASE = {
    "vacuum": 1.0, "air": 1.000277, "helium": 1.000036,
    "hydrogen": 1.000132, "carbon dioxide": 1.00045,
    "water": 1.3330, "acetone": 1.36, "ethanol": 1.361,
    "carbon tetrachloride": 1.461, "glycerol": 1.4729,
    "benzene": 1.501, "silicone oil": 1.52045, "bromine": 1.661,
    "water ice": 1.31, "fused quartz": 1.458, "pyrex": 1.470,
    "acrylic glass": 1.49, "polypropylene": 1.49, "bk7": 1.5046,
    "sodium chloride": 1.544, "amber": 1.55, "pet": 1.5750,
    "diamond": 2.419,
}


def lookup_ior(value, default=None):
    """A material name or a number -> the IOR as a float."""
    if value is None:
        return default
    if isinstance(value, str):
        return IOR_DATABASE[value.lower()]
    return float(value)


# complex-IOR presets of common conductors at the sRGB primaries:
# name -> (eta rgb, k rgb)
CONDUCTOR_PRESETS = {
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),   # a perfect mirror
    "au": ((0.1431, 0.3749, 1.4424), (3.9831, 2.3857, 1.6032)),
    "ag": ((0.1552, 0.1160, 0.1383), (4.8283, 3.1222, 2.1457)),
    "al": ((1.6574, 0.8803, 0.5212), (9.2238, 6.2695, 4.8370)),
    "cu": ((0.2004, 0.9240, 1.1022), (3.9129, 2.4528, 2.1421)),
    "cr": ((4.3696, 2.9167, 1.6547), (5.2083, 4.2321, 3.7544)),
    "ni": ((2.3672, 1.6633, 1.4670), (4.4988, 3.0501, 2.3454)),
    "tio2": ((2.5, 2.5, 2.5), (0.0001, 0.0001, 0.0001)),
    "w": ((4.3707, 3.3002, 2.9970), (3.5006, 2.6048, 2.2731)),
}
