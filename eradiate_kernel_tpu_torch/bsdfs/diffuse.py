"""Smooth Lambertian BSDF (bsdfs/diffuse.py counterpart). Params:
reflectance (texture index), twosided."""

from __future__ import annotations

import math

import torch

from ..core import warp
from . import common

FLAGS = common.DiffuseReflection | common.FrontSide


def build(props, builder):
    return {
        "reflectance": builder.texture(props.get("reflectance", 0.5)),
        "twosided": builder.twosided_flag(props),
    }


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    act = active & (wi[..., 2] > 0.0)
    wo = warp.square_to_cosine_hemisphere(s2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    value = common.tex(scene, params["reflectance"][slot], si, True)
    bs = common.BSDFSample(
        wo=torch.where(flip[..., None], common.flip_z(wo), wo),
        pdf=torch.where(act, pdf, 0.0),
        eta=torch.ones_like(pdf),
        sampled_type=torch.full(pdf.shape, FLAGS, dtype=torch.int32,
                                device=pdf.device))
    return bs, torch.where(act[..., None], value, 0.0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    wo = torch.where(flip[..., None], common.flip_z(wo), wo)
    cos_o = wo[..., 2]
    act = active & (wi[..., 2] > 0.0) & (cos_o > 0.0)
    refl = common.tex(scene, params["reflectance"][slot], si, True)
    value = refl * (cos_o[..., None] / math.pi)
    return (torch.where(act[..., None], value, 0.0),
            torch.where(act, cos_o / math.pi, 0.0))
