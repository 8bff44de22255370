"""Smooth plastic (bsdfs/plastic.py counterpart; plastic.cpp): a delta
specular coat over a diffuse base with internal scattering. Params:
int_ior / ext_ior, diffuse_reflectance, specular_reflectance, nonlinear
(the base's saturation from internal scattering),
specular_sampling_weight, twosided."""

from __future__ import annotations

import numpy as np
import torch

from ..core import warp
from ..render import fresnel as fr
from . import common
from .dielectric import relative_ior

FLAGS = common.DeltaReflection | common.DiffuseReflection | common.FrontSide
SPECULAR = common.DeltaReflection | common.FrontSide
DIFFUSE = common.DiffuseReflection | common.FrontSide


def build(props, builder):
    eta = relative_ior(props, "polypropylene")
    return {
        "eta": eta,
        "fdr_int": np.float32(fr.fresnel_diffuse_reflectance(1.0 / eta)),
        "diffuse_reflectance": builder.texture(
            props.get("diffuse_reflectance", 0.5)),
        "specular_reflectance": builder.texture(
            props.get("specular_reflectance", 1.0)),
        "nonlinear": np.bool_(props.get("nonlinear", False)),
        "spec_weight": np.float32(props.get("specular_sampling_weight",
                                            0.5)),
        "twosided": builder.twosided_flag(props),
    }


def prob_specular(params, slot, f_i):
    """The specular lobe's selection probability F_i w_s / (F_i w_s +
    (1 - F_i) w_d)."""
    ws = params["spec_weight"][slot]
    denom = f_i * ws + (1.0 - f_i) * (1.0 - ws)
    return torch.where(denom > 0, f_i * ws / torch.clamp(denom, min=1e-12),
                       1.0)


def diffuse_term(scene, params, slot, si, f_i, f_o, cos_o):
    """The base's value with the cosine, corrected for internal
    scattering."""
    eta = params["eta"][slot]
    fdr = params["fdr_int"][slot]
    diff = common.tex(scene, params["diffuse_reflectance"][slot], si)
    sat = torch.where(params["nonlinear"][slot][..., None], diff,
                      torch.ones_like(diff))
    value = diff / (1.0 - sat * fdr[..., None])
    return value * (warp.INV_PI * (1.0 / torch.square(eta)) * cos_o
                    * (1.0 - f_i) * (1.0 - f_o))[..., None]


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    cos_i = wi[..., 2]
    act = active & (cos_i > 0.0)
    eta = params["eta"][slot]

    f_i, _, _, _ = fr.fresnel(cos_i, eta)
    prob_spec = prob_specular(params, slot, f_i)
    sel_spec = s1 < prob_spec
    wo = torch.where(sel_spec[..., None], fr.reflect(wi),
                     warp.square_to_cosine_hemisphere(s2))
    cos_o = wo[..., 2]
    f_o, _, _, _ = fr.fresnel(cos_o, eta)
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo) * (1.0 - prob_spec)
    pdf = torch.where(sel_spec, prob_spec, pdf_diff)

    spec = common.tex(scene, params["specular_reflectance"][slot], si)
    w_spec = spec * (f_i / torch.clamp(prob_spec, min=1e-12))[..., None]
    w_diff = diffuse_term(scene, params, slot, si, f_i, f_o, cos_o) \
        / torch.clamp(pdf_diff, min=1e-12)[..., None]
    weight = torch.where(sel_spec[..., None], w_spec, w_diff)
    bs = common.BSDFSample(
        wo=torch.where(flip[..., None], common.flip_z(wo), wo),
        pdf=torch.where(act, pdf, 0.0), eta=torch.ones_like(pdf),
        sampled_type=torch.where(sel_spec, SPECULAR, DIFFUSE).to(torch.int32))
    return bs, torch.where((act & (pdf > 0))[..., None], weight, 0.0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    wo = torch.where(flip[..., None], common.flip_z(wo), wo)
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    act = active & (cos_i > 0.0) & (cos_o > 0.0)
    eta = params["eta"][slot]
    f_i, _, _, _ = fr.fresnel(cos_i, eta)
    f_o, _, _, _ = fr.fresnel(cos_o, eta)
    value = diffuse_term(scene, params, slot, si, f_i, f_o, cos_o)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo) \
        * (1.0 - prob_specular(params, slot, f_i))
    return (torch.where(act[..., None], value, 0.0),
            torch.where(act, pdf, 0.0))
