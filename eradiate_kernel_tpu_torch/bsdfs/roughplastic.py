"""Rough plastic (bsdfs/roughplastic.py counterpart; roughplastic.cpp):
a microfacet coat over the plastic's internally scattering base. As in
the reference, the base is modulated by the smooth Fresnel factors
(1 - F_i)(1 - F_o), not the reference renderer's tabulated rough
transmittances. Params: as the plastic's, with distribution and alpha
(isotropic)."""

from __future__ import annotations

import numpy as np
import torch

from ..core import warp
from ..core.math import normalize
from ..render import fresnel as fr
from ..render import microfacet as mf
from . import common
from .plastic import DIFFUSE, diffuse_term, prob_specular
from .plastic import build as plastic_build
from .roughconductor import dist_sweep

FLAGS = common.GlossyReflection | common.DiffuseReflection | common.FrontSide
GLOSSY = common.GlossyReflection | common.FrontSide


def build(props, builder):
    alpha = np.float32(props.get("alpha", 0.1))
    return dict(plastic_build(props, builder), alpha_u=alpha, alpha_v=alpha,
                dist=np.int32(mf.distr_type(props.get("distribution",
                                                      "ggx"))))


def _specular(scene, params, slot, si, wi, wo):
    """(value with the cosine, pdf) of the microfacet lobe."""
    au = params["alpha_u"][slot]
    av = params["alpha_v"][slot]
    h = normalize(wi + wo)

    def per_dist(ty):
        return (mf.eval_d(ty, h, au, av), mf.g_smith(ty, wi, wo, h, au, av),
                mf.pdf(ty, wi, h, au, av))

    d, g, pdf_m = dist_sweep(params, slot, per_dist)
    f, _, _, _ = fr.fresnel(torch.sum(wi * h, -1), params["eta"][slot])
    val = f * d * g / torch.clamp(4.0 * wi[..., 2], min=1e-12)
    pdf = pdf_m / torch.clamp(4.0 * torch.abs(torch.sum(wo * h, -1)),
                              min=1e-12)
    spec = common.tex(scene, params["specular_reflectance"][slot], si)
    return val[..., None] * spec, pdf


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    act = active & (wi[..., 2] > 0.0)
    au = params["alpha_u"][slot]
    av = params["alpha_v"][slot]
    f_i, _, _, _ = fr.fresnel(wi[..., 2], params["eta"][slot])
    sel_spec = s1 < prob_specular(params, slot, f_i)

    (m,) = dist_sweep(params, slot,
                      lambda ty: (mf.sample(ty, wi, au, av, s2)[0],))
    wo = torch.where(sel_spec[..., None], fr.reflect_m(wi, m),
                     warp.square_to_cosine_hemisphere(s2))
    act_o = act & (wo[..., 2] > 0.0)
    wo = torch.where(flip[..., None], common.flip_z(wo), wo)
    value, pdf = eval_pdf(scene, params, slot, si, wo, active, mode)
    weight = torch.where((act_o & (pdf > 0))[..., None],
                         value / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
    bs = common.BSDFSample(
        wo=wo, pdf=torch.where(act_o, pdf, 0.0), eta=torch.ones_like(pdf),
        sampled_type=torch.where(sel_spec, GLOSSY, DIFFUSE).to(torch.int32))
    return bs, weight


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    wo = torch.where(flip[..., None], common.flip_z(wo), wo)
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    act = active & (cos_i > 0.0) & (cos_o > 0.0)
    eta = params["eta"][slot]
    f_i, _, _, _ = fr.fresnel(cos_i, eta)
    f_o, _, _, _ = fr.fresnel(cos_o, eta)
    spec_val, spec_pdf = _specular(scene, params, slot, si, wi, wo)
    value = spec_val + diffuse_term(scene, params, slot, si, f_i, f_o, cos_o)
    prob_spec = prob_specular(params, slot, f_i)
    pdf = prob_spec * spec_pdf \
        + (1.0 - prob_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
    return (torch.where(act[..., None], value, 0.0),
            torch.where(act, pdf, 0.0))
