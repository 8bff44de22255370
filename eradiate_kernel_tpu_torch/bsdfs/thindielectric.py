"""Thin dielectric sheet (bsdfs/thindielectric.py counterpart;
thindielectric.cpp): both interfaces at once, R' = 2R / (1 + R); a
transmission keeps its direction (wo = -wi) and enters no medium (eta
1). Params as the dielectric's."""

from __future__ import annotations

import torch

from ..render import fresnel as fr
from . import common
from .dielectric import relative_ior

FLAGS = (common.DeltaReflection | common.Null
         | common.FrontSide | common.BackSide)
REFLECT = common.DeltaReflection | common.FrontSide | common.BackSide
PASS = common.Null | common.FrontSide | common.BackSide


def build(props, builder):
    return {
        "eta": relative_ior(props),
        "specular_reflectance": builder.texture(
            props.get("specular_reflectance", 1.0)),
        "specular_transmittance": builder.texture(
            props.get("specular_transmittance", 1.0)),
        "twosided": builder.twosided_flag(props),
    }


def _reflectance(params, slot, si):
    """R' of the two interfaces (thindielectric.cpp:62)."""
    r, _, _, _ = fr.fresnel(torch.abs(si.wi[..., 2]), params["eta"][slot])
    return torch.where(r < 1.0, 2.0 * r / (1.0 + r), 1.0)


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    wi = si.wi
    r = _reflectance(params, slot, si)
    act = active & (wi[..., 2] != 0.0)
    select_r = s1 <= r
    weight = torch.where(
        select_r[..., None],
        common.tex(scene, params["specular_reflectance"][slot], si),
        common.tex(scene, params["specular_transmittance"][slot], si))
    bs = common.BSDFSample(
        wo=torch.where(select_r[..., None], fr.reflect(wi), -wi),
        pdf=torch.where(act, torch.where(select_r, r, 1.0 - r), 0.0),
        eta=torch.ones_like(r),
        sampled_type=torch.where(select_r, REFLECT, PASS).to(torch.int32))
    return bs, torch.where(act[..., None], weight, 0.0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    n = si.t.shape[0]
    return (torch.zeros(n, scene.config.variant.channels(si.wavelengths),
                        device=si.t.device),
            torch.zeros(n, device=si.t.device))


def eval_null_transmission(scene, params, slot, si, active):
    """The straight-through transmittance (1 - R') times the specular
    transmittance."""
    r = _reflectance(params, slot, si)
    trans = common.tex(scene, params["specular_transmittance"][slot], si)
    return torch.where(active[..., None], trans * (1.0 - r)[..., None], 0.0)
