"""Bi-Lambertian BSDF (bsdfs/bilambertian.py counterpart; Eradiate's
bilambertian.cpp:53-175): a diffuse reflectance on the incident side and
a diffuse transmittance through to the other side (canopy leaves). Params
reflectance and transmittance (texture indices), twosided."""

from __future__ import annotations

import math

import torch

from ..core import warp
from . import common

FLAGS = (common.DiffuseReflection | common.DiffuseTransmission
         | common.FrontSide | common.BackSide)


def build(props, builder):
    return {
        "reflectance": builder.texture(props.get("reflectance", 0.5)),
        "transmittance": builder.texture(props.get("transmittance", 0.5)),
        "twosided": builder.twosided_flag(props),
    }


def _weights(scene, params, slot, si):
    """(r, t, w_r): the two albedos and the reflection lobe's share."""
    r = common.tex(scene, params["reflectance"][slot], si)
    t = common.tex(scene, params["transmittance"][slot], si)
    total = torch.mean(r + t, dim=-1)
    w_r = torch.where(total > 0, torch.mean(r, dim=-1)
                      / torch.clamp(total, min=1e-12), 0.0)
    return r, t, w_r


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    cos_i = si.wi[..., 2]
    r, t, w_r = _weights(scene, params, slot, si)
    wo = warp.square_to_cosine_hemisphere(s2)
    pdf_base = warp.square_to_cosine_hemisphere_pdf(wo)
    sel_r = (s1 < w_r) & active
    value = torch.where(sel_r[..., None],
                        r / torch.clamp(w_r, min=1e-12)[..., None],
                        t / torch.clamp(1.0 - w_r, min=1e-12)[..., None])
    pdf = torch.where(sel_r, pdf_base * w_r, pdf_base * (1.0 - w_r))
    # into the incident hemisphere, then through for a transmission
    wo = torch.where((cos_i > 0)[..., None], wo, common.flip_z(wo))
    wo = torch.where(sel_r[..., None], wo, common.flip_z(wo))
    bs = common.BSDFSample(
        wo=wo, pdf=torch.where(active, pdf, 0.0), eta=torch.ones_like(pdf),
        sampled_type=torch.where(sel_r, common.DiffuseReflection,
                                 common.DiffuseTransmission).to(torch.int32))
    return bs, torch.where((active & (pdf > 0))[..., None], value, 0.0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    cos_i = si.wi[..., 2]
    cos_o = wo[..., 2]
    r, t, w_r = _weights(scene, params, slot, si)
    is_reflect = torch.sign(cos_i) == torch.sign(cos_o)
    value = torch.where(is_reflect[..., None], r, t) \
        * (torch.abs(cos_o) / math.pi)[..., None]
    pdf_base = warp.square_to_cosine_hemisphere_pdf(torch.stack(
        [wo[..., 0], wo[..., 1], torch.abs(cos_o)], dim=-1))
    pdf = torch.where(is_reflect, pdf_base * w_r, pdf_base * (1.0 - w_r))
    return (torch.where(active[..., None], value, 0.0),
            torch.where(active, pdf, 0.0))
