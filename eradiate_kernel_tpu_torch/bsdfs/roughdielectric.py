"""Rough dielectric (bsdfs/roughdielectric.py counterpart;
roughdielectric.cpp, Walter et al. 2007): microfacet reflection and
transmission through a rough interface, sampled from either side.
Params: int_ior / ext_ior, distribution, alpha or alpha_u / alpha_v,
specular_reflectance, specular_transmittance."""

from __future__ import annotations

import numpy as np
import torch

from ..core import mueller as mu
from ..core.math import cross, normalize, sqr
from ..render import fresnel as fr
from ..render import microfacet as mf
from . import common
from .dielectric import relative_ior
from .roughconductor import dist_sweep

FLAGS = (common.GlossyReflection | common.GlossyTransmission
         | common.FrontSide | common.BackSide | common.NonSymmetric
         | common.Anisotropic)
REFLECT = common.GlossyReflection | common.FrontSide | common.BackSide
TRANSMIT = (common.GlossyTransmission | common.FrontSide | common.BackSide
            | common.NonSymmetric)


def build(props, builder):
    alpha = float(props.get("alpha", 0.1))
    return {
        "eta": relative_ior(props),
        "alpha_u": np.float32(props.get("alpha_u", alpha)),
        "alpha_v": np.float32(props.get("alpha_v", alpha)),
        "dist": np.int32(mf.distr_type(props.get("distribution", "ggx"))),
        "specular_reflectance": builder.texture(
            props.get("specular_reflectance", 1.0)),
        "specular_transmittance": builder.texture(
            props.get("specular_transmittance", 1.0)),
        "twosided": builder.twosided_flag(props),
    }


def _mulsign(v, s):
    """v times the sign of s, with sign(0) = 1."""
    return v * torch.sign(s + (s == 0))[..., None]


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    eta = params["eta"][slot]
    au = params["alpha_u"][slot]
    av = params["alpha_v"][slot]
    wi = si.wi
    cos_i = wi[..., 2]
    act = active & (cos_i != 0.0)
    wi_up = _mulsign(wi, cos_i)  # into m's hemisphere

    m, pdf_m = dist_sweep(params, slot,
                          lambda ty: mf.sample(ty, wi_up, au, av, s2))
    # m stays in the upper hemisphere; the sign of wi.m tells fresnel()
    # whether the ray enters or leaves the dense side
    wim = torch.sum(wi * m, -1)
    f, cos_t, eta_it, eta_ti = fr.fresnel(wim, eta)
    select_r = s1 <= f
    wo = torch.where(select_r[..., None], fr.reflect_m(wi, m),
                     fr.refract_m(wi, m, cos_t, eta_ti))
    cos_o = wo[..., 2]
    # reflection stays on wi's side, transmission crosses
    ok = torch.where(select_r, cos_i * cos_o > 0, cos_i * cos_o < 0)
    act = act & ok & (pdf_m > 0)

    # visible normals: weight = G2 / G1(wi) = G1(wo)
    wo_up = _mulsign(wo, cos_o)
    w_nof = torch.where(params["dist"][slot] == mf.GGX,
                        mf.smith_g1(mf.GGX, wo_up, m, au, av),
                        mf.smith_g1(mf.BECKMANN, wo_up, m, au, av))

    wom = torch.sum(wo * m, -1)
    dwh_dwo_r = 1.0 / torch.clamp(4.0 * torch.abs(wom), min=1e-12)
    denom_t = wim + eta_it * wom
    dwh_dwo_t = sqr(eta_it) * torch.abs(wom) / torch.clamp(sqr(denom_t),
                                                           min=1e-12)
    pdf = pdf_m * torch.where(select_r, f, 1.0 - f) \
        * torch.where(select_r, dwh_dwo_r, dwh_dwo_t)

    refl = common.tex(scene, params["specular_reflectance"][slot], si)
    trans = common.tex(scene, params["specular_transmittance"][slot], si)
    weight = torch.where(
        select_r[..., None], refl,
        trans * common.radiance_scale(eta_ti, mode)[..., None]) \
        * w_nof[..., None]
    bs = common.BSDFSample(
        wo=wo, pdf=torch.where(act, pdf, 0.0),
        eta=torch.where(select_r, 1.0, eta_it),
        sampled_type=torch.where(select_r, REFLECT, TRANSMIT).to(torch.int32))
    return bs, torch.where((act & (pdf > 0))[..., None], weight, 0.0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    eta = params["eta"][slot]
    au = params["alpha_u"][slot]
    av = params["alpha_v"][slot]
    wi = si.wi
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    reflect = cos_i * cos_o > 0.0
    act = active & (cos_i != 0.0) & (cos_o != 0.0)

    # the half vector: wi + wo (reflection), wi + eta wo (transmission),
    # with the relative IOR along the crossing, in the upper hemisphere
    eta_e = torch.where(cos_i > 0, eta, 1.0 / eta)
    m = normalize(wi + wo * torch.where(reflect, 1.0, eta_e)[..., None])
    m = _mulsign(m, m[..., 2])
    wi_up = _mulsign(wi, cos_i)
    wo_up = _mulsign(wo, cos_o)
    f, _, eta_it, eta_ti = fr.fresnel(torch.sum(wi * m, -1), eta)

    def per_dist(ty):
        return (mf.eval_d(ty, m, au, av),
                mf.smith_g1(ty, wi_up, m, au, av)
                * mf.smith_g1(ty, wo_up, m, au, av),
                mf.pdf(ty, wi_up, m, au, av))

    d, g, pdf_m = dist_sweep(params, slot, per_dist)
    wim = torch.sum(wi * m, -1)
    wom = torch.sum(wo * m, -1)
    # beyond the fold of the refraction map the algebraic m is not the
    # pair's and the sampler never makes it
    act = act & (wim * cos_i > 0.0) & (wom * cos_o > 0.0)

    # reflection: f |cos_o| = F D G / (4 |cos_i|)
    val_r = f * d * g / torch.clamp(4.0 * torch.abs(cos_i), min=1e-12)
    pdf_r = pdf_m * f / torch.clamp(4.0 * torch.abs(wom), min=1e-12)
    # transmission (Walter eq. 21 times |cos_o|, with the radiance factor)
    denom = wim + eta_it * wom
    common_t = d * g * torch.abs(wim * wom) \
        / torch.clamp(torch.abs(cos_i) * sqr(denom), min=1e-12)
    val_t = ((1.0 - f) * sqr(eta_it) * common_t
             * common.radiance_scale(eta_ti, mode))
    dwh_dwo_t = sqr(eta_it) * torch.abs(wom) / torch.clamp(sqr(denom),
                                                           min=1e-12)
    pdf_t = pdf_m * (1.0 - f) * dwh_dwo_t

    value = torch.where(reflect, val_r, val_t)
    pdf = torch.where(reflect, pdf_r, pdf_t)
    tex = torch.where(
        reflect[..., None],
        common.tex(scene, params["specular_reflectance"][slot], si),
        common.tex(scene, params["specular_transmittance"][slot], si))
    return (torch.where(act[..., None], value[..., None] * tex, 0.0),
            torch.where(act, pdf, 0.0))


def eval_mueller(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    """The polarized rough-dielectric eval: the microfacet eval with the
    Fresnel factor replaced by the specular reflection or transmission
    matrix about the facet normal m, rotated from the s/p frame of the
    plane of incidence into the implicit Stokes bases of (-wo, wi), its
    M00 rescaled to the scalar Fresnel split. The per-channel (N, nc, 4,
    4) stack, cosine included. Beyond Mitsuba, whose roughdielectric.cpp
    has no polarized branch, as in the reference."""
    eta = params["eta"][slot]
    au = params["alpha_u"][slot]
    av = params["alpha_v"][slot]
    wi = si.wi
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    reflect = cos_i * cos_o > 0.0
    act = active & (cos_i != 0.0) & (cos_o != 0.0)
    eta_e = torch.where(cos_i > 0, eta, 1.0 / eta)
    m = normalize(wi + wo * torch.where(reflect, 1.0, eta_e)[..., None])
    m = _mulsign(m, m[..., 2])
    wi_up = _mulsign(wi, cos_i)
    wo_up = _mulsign(wo, cos_o)
    f, _, eta_it, eta_ti = fr.fresnel(torch.sum(wi * m, -1), eta)
    dg, = dist_sweep(params, slot, lambda ty: (
        mf.eval_d(ty, m, au, av) * mf.smith_g1(ty, wi_up, m, au, av)
        * mf.smith_g1(ty, wo_up, m, au, av),))
    wim = torch.sum(wi * m, -1)
    wom = torch.sum(wo * m, -1)
    act = act & (wim * cos_i > 0.0) & (wom * cos_o > 0.0)

    # the eval's magnitudes with f and 1 - f factored out
    val_r_nof = dg / torch.clamp(4.0 * torch.abs(cos_i), min=1e-12)
    denom = wim + eta_it * wom
    common_t = dg * torch.abs(wim * wom) \
        / torch.clamp(torch.abs(cos_i) * sqr(denom), min=1e-12)
    val_nof = torch.where(
        reflect, val_r_nof,
        sqr(eta_it) * common_t * common.radiance_scale(eta_ti, mode))

    # the facet's Fresnel matrix, the IOR oriented by the signed cosine
    wo_hat, wi_hat = common.mode_bases(wo, wi, mode)
    ci_m = torch.sum(wo_hat * m, -1)
    eta_rel = torch.where(ci_m >= 0, eta, 1.0 / eta)
    f_m = torch.where(reflect[..., None, None],
                      mu.specular_reflection(torch.abs(ci_m), eta_rel),
                      mu.specular_transmission(torch.abs(ci_m), eta_rel))
    # M00 to the scalar split exactly (f is taken against wi.m as in
    # eval_pdf; reciprocity makes the orientations agree analytically)
    m00 = f_m[..., 0, 0]
    target = torch.where(reflect, f, 1.0 - f)
    scale = torch.where(m00 > 1e-12, target / torch.clamp(m00, min=1e-12),
                        0.0)
    f_m = f_m * scale[..., None, None]
    f_m = mu.to_local_frames(
        f_m, wo_hat, wi_hat, mu.plane_basis(cross(m, -wo_hat), -wo_hat),
        mu.plane_basis(cross(m, wi_hat), wi_hat))
    tex = torch.where(
        reflect[..., None],
        common.tex(scene, params["specular_reflectance"][slot], si),
        common.tex(scene, params["specular_transmittance"][slot], si))
    out = (tex * val_nof[..., None])[..., None, None] * f_m[..., None, :, :]
    return torch.where(act[..., None, None, None], out, 0.0)
