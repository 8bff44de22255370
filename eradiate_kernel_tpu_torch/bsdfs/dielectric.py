"""Smooth dielectric (bsdfs/dielectric.py counterpart; dielectric.cpp):
delta reflection and delta transmission, chosen by the Fresnel term.
Params: int_ior / ext_ior (names or numbers; eta = int / ext),
specular_reflectance, specular_transmittance. A transmission carries
the radiance compression eta_ti^2 and the relative IOR in the sample's
``eta``."""

from __future__ import annotations

import numpy as np
import torch

from ..core import mueller as mu
from ..core.math import cross
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


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    wi = si.wi
    cos_i = wi[..., 2]
    r, cos_t, eta_it, eta_ti = fr.fresnel(cos_i, params["eta"][slot])
    act = active & (cos_i != 0.0)
    select_r = s1 <= r
    wo = torch.where(select_r[..., None], fr.reflect(wi),
                     fr.refract(wi, cos_t, eta_ti))
    refl = common.tex(scene, params["specular_reflectance"][slot], si)
    trans = common.tex(scene, params["specular_transmittance"][slot], si)
    factor = torch.where(select_r, 1.0, common.radiance_scale(eta_ti, mode))
    weight = torch.where(select_r[..., None], refl, trans) * factor[..., None]
    bs = common.BSDFSample(
        wo=wo, pdf=torch.where(act, torch.where(select_r, r, 1.0 - r), 0.0),
        eta=torch.where(select_r, 1.0, eta_it),
        sampled_type=torch.where(select_r, REFLECT, TRANSMIT).to(torch.int32))
    return bs, torch.where(act[..., None], weight, 0.0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    return common.zero_eval(scene, si)


def eval_null_transmission(scene, params, slot, si, active):
    """No unscattered transmission (bsdf.h's default for a non-null
    BSDF)."""
    nc = scene.config.variant.channels(si.wavelengths)
    return torch.zeros(si.t.shape[0], nc, device=si.t.device)


def sample_mueller_weight(scene, params, slot, si, bs, weight, active,
                          mode=common.RADIANCE):
    """The polarized delta-dielectric weight (dielectric.cpp:250-307): the
    Fresnel reflection or transmission matrix of the sampled lobe over the
    lobe's pdf, rotated from the s/p frame of the plane of incidence into
    the implicit local Stokes bases, times the reflectance or the
    transmittance (with the radiance compression eta_ti^2) as an
    absorber."""
    eta = params["eta"][slot]
    wi = si.wi
    cos_i = wi[..., 2]
    act = active & (cos_i != 0.0)
    wo_hat, wi_hat = common.mode_bases(bs.wo, wi, mode)
    ci = wo_hat[..., 2]
    # the reference's fresnel_polarized handles a signed incidence inside;
    # here a hit from inside flips the relative IOR
    eta_rel = torch.where(ci >= 0, eta, 1.0 / eta)
    R = mu.specular_reflection(torch.abs(ci), eta_rel)
    T = mu.specular_transmission(torch.abs(ci), eta_rel)
    selected_r = (bs.sampled_type & common.DeltaReflection) != 0
    r, _cos_t, _eta_it, eta_ti = fr.fresnel(cos_i, eta)
    pdf = torch.where(selected_r, r, 1.0 - r)
    m4 = torch.where(selected_r[..., None, None], R, T) \
        / torch.clamp(pdf, min=1e-12)[..., None, None]
    # the s axis is perpendicular to the plane of incidence
    # (dielectric.cpp:272-274)
    n = torch.zeros_like(wo_hat)
    n[..., 2] = 1.0
    m4 = mu.to_local_frames(
        m4, wo_hat, wi_hat, mu.plane_basis(cross(n, -wo_hat), -wo_hat),
        mu.plane_basis(cross(n, wi_hat), wi_hat))
    refl = common.tex(scene, params["specular_reflectance"][slot], si)
    trans = common.tex(scene, params["specular_transmittance"][slot], si)
    ch_scale = torch.where(
        selected_r[..., None], refl,
        trans * common.radiance_scale(eta_ti, mode)[..., None])
    return torch.where(act[..., None, None, None],
                       m4[..., None, :, :] * ch_scale[..., None, None], 0.0)
