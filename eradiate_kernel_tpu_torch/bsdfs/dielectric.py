"""Smooth dielectric (bsdfs/dielectric.py counterpart; dielectric.cpp):
delta reflection and delta transmission, chosen by the Fresnel term.
Params: int_ior / ext_ior (names or numbers; eta = int / ext),
specular_reflectance, specular_transmittance. A transmission carries
the radiance compression eta_ti^2 and the relative IOR in the sample's
``eta``."""

from __future__ import annotations

import numpy as np
import torch

from ..render import fresnel as fr
from . import common

FLAGS = (common.DeltaReflection | common.DeltaTransmission
         | common.FrontSide | common.BackSide | common.NonSymmetric)
REFLECT = common.DeltaReflection | common.FrontSide | common.BackSide
TRANSMIT = (common.DeltaTransmission | common.FrontSide | common.BackSide
            | common.NonSymmetric)


def relative_ior(props, default_int="bk7"):
    return np.float32(fr.lookup_ior(props.get("int_ior", default_int))
                      / fr.lookup_ior(props.get("ext_ior", "air")))


def build(props, builder):
    return {
        "eta": relative_ior(props),
        "specular_reflectance": builder.texture(
            props.get("specular_reflectance", 1.0)),
        "specular_transmittance": builder.texture(
            props.get("specular_transmittance", 1.0)),
        "twosided": builder.twosided_flag(props),
    }


def sample(scene, params, slot, si, s1, s2, active):
    wi = si.wi
    cos_i = wi[..., 2]
    r, cos_t, eta_it, eta_ti = fr.fresnel(cos_i, params["eta"][slot])
    act = active & (cos_i != 0.0)
    select_r = s1 <= r
    wo = torch.where(select_r[..., None], fr.reflect(wi),
                     fr.refract(wi, cos_t, eta_ti))
    refl = common.tex(scene, params["specular_reflectance"][slot], si)
    trans = common.tex(scene, params["specular_transmittance"][slot], si)
    factor = torch.where(select_r, 1.0, torch.square(eta_ti))
    weight = torch.where(select_r[..., None], refl, trans) * factor[..., None]
    bs = common.BSDFSample(
        wo=wo, pdf=torch.where(act, torch.where(select_r, r, 1.0 - r), 0.0),
        eta=torch.where(select_r, 1.0, eta_it),
        sampled_type=torch.where(select_r, REFLECT, TRANSMIT).to(torch.int32))
    return bs, torch.where(act[..., None], weight, 0.0)


def eval_pdf(scene, params, slot, si, wo, active):
    n = si.t.shape[0]
    return (torch.zeros(n, scene.config.variant.channels(si.wavelengths),
                        device=si.t.device),
            torch.zeros(n, device=si.t.device))


def eval_null_transmission(scene, params, slot, si, active):
    """No unscattered transmission (bsdf.h's default for a non-null
    BSDF)."""
    nc = scene.config.variant.channels(si.wavelengths)
    return torch.zeros(si.t.shape[0], nc, device=si.t.device)
