"""Rahman-Pinty-Verstraete (RPV) Earth-surface BRDF (bsdfs/rpv.py
counterpart; reference src/bsdfs/rpv.cpp:67-146). Params rho_0, g, k and
rho_c are texture indices; sampled with a cosine hemisphere."""

from __future__ import annotations

import math

import torch

from ..core import warp
from ..core.frame import cos_theta, sin_cos_phi_2, sin_theta, tan_theta
from ..core.math import safe_sqrt, sqr
from . import common

FLAGS = common.GlossyReflection | common.FrontSide


def build(props, builder):
    rho_0 = builder.texture(props.get("rho_0", 0.1))
    return {
        "rho_0": rho_0,
        "g": builder.texture(props.get("g", 0.0)),
        "k": builder.texture(props.get("k", 0.1)),
        "rho_c": (builder.texture(props["rho_c"]) if "rho_c" in props
                  else rho_0),
        "twosided": builder.twosided_flag(props),
    }


def _sincos_phi(v):
    s2, c2 = sin_cos_phi_2(v)
    sp = safe_sqrt(s2) * torch.sign(v[..., 1] + (v[..., 1] == 0))
    cp = safe_sqrt(c2) * torch.sign(v[..., 0] + (v[..., 0] == 0))
    return sp, cp


def eval_rpv(scene, params, slot, si, wi, wo, active):
    """BRDF value without the cosine factor (rpv.cpp:107-146). The
    reference hands ``active`` to its texture lookups, which read every
    lane; so is the value here computed on every lane."""
    rho_0 = common.tex(scene, params["rho_0"][slot], si)
    rho_c = common.tex(scene, params["rho_c"][slot], si)
    g = common.tex(scene, params["g"][slot], si)
    k = common.tex(scene, params["k"][slot], si)

    sp1, cp1 = _sincos_phi(wi)
    sp2, cp2 = _sincos_phi(wo)
    cos_dphi = cp1 * cp2 + sp1 * sp2
    st1, ct1, tt1 = (sin_theta(wi), torch.clamp(cos_theta(wi), min=1e-6),
                     tan_theta(wi))
    st2, ct2, tt2 = (sin_theta(wo), torch.clamp(cos_theta(wo), min=1e-6),
                     tan_theta(wo))

    G = safe_sqrt(sqr(tt1) + sqr(tt2) - 2.0 * tt1 * tt2 * cos_dphi)
    cos_g = ct1 * ct2 + st1 * st2 * cos_dphi
    F = (1.0 - sqr(g)) / torch.clamp(
        (1.0 + sqr(g) + 2.0 * g * cos_g[..., None]) ** 1.5, min=1e-9)
    minnaert = (ct1 * ct2 * (ct1 + ct2))[..., None] ** (k - 1.0)
    return (rho_0 * minnaert * F
            * (1.0 + (1.0 - rho_c) / (1.0 + G[..., None])) / math.pi)


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    act = active & (wi[..., 2] > 0.0)
    wo = warp.square_to_cosine_hemisphere(s2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    value = eval_rpv(scene, params, slot, si, wi, wo, act)
    bs = common.BSDFSample(
        wo=torch.where(flip[..., None], common.flip_z(wo), wo),
        pdf=torch.where(act, pdf, 0.0),
        eta=torch.ones_like(pdf),
        sampled_type=torch.full(pdf.shape, FLAGS, dtype=torch.int32,
                                device=pdf.device))
    # weight = value * cos / pdf = value * pi (the cosine cancels)
    weight = torch.where((act & (pdf > 0))[..., None], value * math.pi, 0.0)
    return bs, weight


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    wo = torch.where(flip[..., None], common.flip_z(wo), wo)
    act = active & (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    value = (eval_rpv(scene, params, slot, si, wi, wo, act)
             * torch.abs(wo[..., 2])[..., None])
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return (torch.where(act[..., None], value, 0.0),
            torch.where(act, pdf, 0.0))
