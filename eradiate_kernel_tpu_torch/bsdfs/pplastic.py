"""Polarized plastic (bsdfs/pplastic.py counterpart; pplastic.cpp, the Baek
et al. 2018 pBRDF): a rough microfacet specular lobe plus a Lambertian
base attenuated by the two smooth refractions into and out of the coating.

There is no internal-scattering normalisation: the two lobes are added
(pplastic.cpp:66-84). ``eval_pdf`` is the unpolarized eval
(pplastic.cpp:305-330), ``eval_mueller`` the Mueller-matrix pBRDF
(pplastic.cpp:229-302) of the stokes integrator's transport. Params:
int_ior / ext_ior, distribution (beckmann by default), alpha or alpha_u /
alpha_v, diffuse_reflectance and specular_reflectance (texture indices)
and the specular lobe's sampling weight."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import mueller as mu
from ..core import warp
from ..core.math import cross, normalize
from ..render import fresnel as fr
from ..render import microfacet as mf
from . import common
from .roughconductor import dist_sweep

FLAGS = (common.GlossyReflection | common.DiffuseReflection
         | common.FrontSide)
SPECULAR = common.GlossyReflection | common.FrontSide
DIFFUSE = common.DiffuseReflection | common.FrontSide


def _mean_reflectance(value, default):
    """The scalar mean of a constant reflectance prop; textures fall back
    to the reference's default (its parameters_changed())."""
    if value is None:
        return default
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, (list, tuple)):
        return float(np.mean([float(v) for v in value]))
    if isinstance(value, dict) and isinstance(value.get("value"),
                                              (int, float)):
        return float(value["value"])
    return default


def build(props, builder):
    eta = (fr.lookup_ior(props.get("int_ior", "polypropylene"))
           / fr.lookup_ior(props.get("ext_ior", "air")))
    alpha = float(props.get("alpha", 0.1))
    # the specular sampling weight s_mean / (d_mean + s_mean)
    # (pplastic.cpp parameters_changed)
    d_mean = _mean_reflectance(props.get("diffuse_reflectance"), 0.5)
    s_mean = _mean_reflectance(props.get("specular_reflectance"), 1.0)
    return {
        "eta": np.float32(eta),
        "alpha_u": np.float32(props.get("alpha_u", alpha)),
        "alpha_v": np.float32(props.get("alpha_v", alpha)),
        "dist": np.int32(mf.distr_type(props.get("distribution",
                                                 "beckmann"))),
        "diffuse_reflectance": builder.texture(
            props.get("diffuse_reflectance", 0.5)),
        "specular_reflectance": builder.texture(
            props.get("specular_reflectance", 1.0)),
        "spec_weight": np.float32(s_mean / max(d_mean + s_mean, 1e-6)),
        "twosided": builder.twosided_flag(props),
    }


def _spec_terms(params, slot, wi, wo):
    """(D, G, G1(wi, h), h) of each lane's distribution."""
    au = params["alpha_u"][slot]
    av = params["alpha_v"][slot]
    h = normalize(wi + wo)
    d, g, g1 = dist_sweep(params, slot, lambda ty: (
        mf.eval_d(ty, h, au, av), mf.g_smith(ty, wi, wo, h, au, av),
        mf.smith_g1(ty, wi, h, au, av)))
    return d, g, g1, h


def _pdf(params, slot, wi, wo, act):
    """The lobe mixture's pdf (pplastic.cpp:336-375): the constant
    specular weight, the visible-normal specular density and the cosine
    diffuse density."""
    d, _g, g1, h = _spec_terms(params, slot, wi, wo)
    p_spec = d * g1 / torch.clamp(4.0 * wi[..., 2], min=1e-12)
    p_spec = torch.where((torch.sum(wi * h, -1) > 0)
                         & (torch.sum(wo * h, -1) > 0), p_spec, 0.0)
    ws = params["spec_weight"][slot]
    pdf = ws * p_spec + (1.0 - ws) * warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(act, pdf, 0.0)


def _frame(params, slot, si, wo):
    """(wi, wo, active) in the twosided frame."""
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    wo = torch.where(flip[..., None], common.flip_z(wo), wo)
    return wi, wo, (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    wi, wo, ok = _frame(params, slot, si, wo)
    act = active & ok
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    eta = params["eta"][slot]
    d, g, _g1, h = _spec_terms(params, slot, wi, wo)
    f, _, _, _ = fr.fresnel(torch.sum(wi * h, -1), eta)
    spec = common.tex(scene, params["specular_reflectance"][slot], si)
    spec_val = spec * (f * d * g / torch.clamp(4.0 * cos_i,
                                               min=1e-12))[..., None]
    # the diffuse base through the refractions in and out
    # (pplastic.cpp:319-329)
    f_i, _, _, _ = fr.fresnel(cos_i, eta)
    f_o, _, _, _ = fr.fresnel(cos_o, eta)
    diff = common.tex(scene, params["diffuse_reflectance"][slot], si)
    diff_val = diff * ((1.0 - f_i) * (1.0 - f_o) * cos_o
                       / math.pi)[..., None]
    value = torch.where(act[..., None], spec_val + diff_val, 0.0)
    return value, _pdf(params, slot, wi, wo, act)


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    act = active & (wi[..., 2] > 0.0)
    au = params["alpha_u"][slot]
    av = params["alpha_v"][slot]
    sel_spec = s1 < params["spec_weight"][slot]
    m, = dist_sweep(params, slot,
                    lambda ty: (mf.sample(ty, wi, au, av, s2)[0],))
    wo = torch.where(sel_spec[..., None], fr.reflect_m(wi, m),
                     warp.square_to_cosine_hemisphere(s2))
    act_o = act & (wo[..., 2] > 0.0)
    wo_world = torch.where(flip[..., None], common.flip_z(wo), wo)
    value, pdf = eval_pdf(scene, params, slot, si, wo_world, active, mode)
    weight = torch.where((act_o & (pdf > 0))[..., None],
                         value / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
    bs = common.BSDFSample(
        wo=wo_world, pdf=torch.where(act_o, pdf, 0.0),
        eta=torch.ones_like(pdf),
        sampled_type=torch.where(sel_spec, SPECULAR,
                                 DIFFUSE).to(torch.int32))
    return bs, weight


def eval_mueller(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    """The polarization-aware eval (pplastic.cpp:229-302): the per-channel
    Mueller stack (N, nc, 4, 4) in the implicit Stokes bases of -wo (the
    incident light) and wi (the outgoing light), cosine included."""
    wi, wo, ok = _frame(params, slot, si, wo)
    act = active & ok
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    eta = params["eta"][slot]

    # the light arrives along -wo_hat and leaves along wi_hat
    # (pplastic.cpp:236)
    wo_hat, wi_hat = common.mode_bases(wo, wi, mode)

    # the specular lobe: the Fresnel matrix about the half vector
    d, g, _g1, h = _spec_terms(params, slot, wi, wo)
    f_m = mu.specular_reflection(torch.sum(wo_hat * h, -1), eta)
    f_m = mu.to_local_frames(
        f_m, wo_hat, wi_hat,
        mu.plane_basis(cross(h, -wo_hat), -wo_hat, 1e-12),
        mu.plane_basis(cross(h, wi_hat), wi_hat, 1e-12))
    spec = common.tex(scene, params["specular_reflectance"][slot], si)
    spec_m = (spec * (d * g / torch.clamp(4.0 * cos_i, min=1e-12))[..., None]
              )[..., None, None] * f_m[..., None, :, :]

    # the diffuse base: refract in (t_o), depolarize, refract out (t_i)
    t_o = mu.specular_transmission(torch.abs(wo_hat[..., 2]), eta)
    _, cos_t_i, _, eta_ti = fr.fresnel(cos_i, eta)
    wi_p = -fr.refract(wi_hat, cos_t_i, eta_ti)
    t_i = mu.specular_transmission(torch.abs(wi_p[..., 2]), 1.0 / eta)
    diff_m = t_i @ mu.depolarizer(torch.ones((), dtype=t_i.dtype,
                                             device=t_i.device)) @ t_o
    n = torch.zeros_like(wo_hat)
    n[..., 2] = 1.0
    diff_m = mu.to_local_frames(
        diff_m, wo_hat, wi_hat,
        mu.plane_basis(cross(n, -wo_hat), -wo_hat, 1e-12),
        mu.plane_basis(cross(n, wi_hat), wi_hat, 1e-12))
    diff = common.tex(scene, params["diffuse_reflectance"][slot], si)
    diff_m = (diff * (cos_o / math.pi)[..., None])[..., None, None] \
        * diff_m[..., None, :, :]
    return torch.where(act[..., None, None, None], spec_m + diff_m, 0.0)
