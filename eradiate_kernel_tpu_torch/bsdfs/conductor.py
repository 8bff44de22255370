"""Smooth conductor (bsdfs/conductor.py counterpart; conductor.cpp).
Params: eta and k (spectrum indices of the complex relative IOR, given
or from a named preset of fresnel.CONDUCTOR_PRESETS; the default
material "none" is a perfect mirror), specular_reflectance (texture
index), twosided."""

from __future__ import annotations

import numpy as np
import torch

from ..core import mueller as mu
from ..core.math import cross
from ..render import fresnel as fr
from ..render.texture import scene_spectrum_eval
from . import common

FLAGS = common.DeltaReflection | common.FrontSide


def _eta_k(props, builder):
    """(eta, k) spectrum indices of a conductor's props. eta and k exceed
    1, which the spectral variant's rgb upsampling would clip: there an
    rgb triple becomes the uniform spectrum of its mean, as in the
    reference."""
    def unbounded(v):
        if builder.variant.is_spectral and isinstance(v, (list, tuple)):
            return builder.spectrum({"type": "uniform",
                                     "value": float(np.mean(v))})
        return builder.spectrum(v)

    if "eta" in props or "k" in props:
        return (unbounded(props.get("eta", 0.0)),
                unbounded(props.get("k", 1.0)))
    eta_rgb, k_rgb = fr.CONDUCTOR_PRESETS[props.get("material",
                                                    "none").lower()]
    return unbounded(list(eta_rgb)), unbounded(list(k_rgb))


def build(props, builder):
    eta, k = _eta_k(props, builder)
    return {
        "eta": eta, "k": k,
        "specular_reflectance": builder.texture(
            props.get("specular_reflectance", 1.0)),
        "twosided": builder.twosided_flag(props),
    }


def spectrum(scene, index, si):
    """(N, nc) values of the spectra ``index`` (N,) at the lanes'
    wavelengths: eta and k are not spatially varying."""
    return scene_spectrum_eval(scene, index, si.wavelengths)


def fresnel_term(scene, params, slot, si, cos_i):
    """(N, nc) conductor Fresnel term at ``cos_i`` times the specular
    reflectance."""
    f = fr.fresnel_conductor(cos_i, spectrum(scene, params["eta"][slot], si),
                             spectrum(scene, params["k"][slot], si))
    return f * common.tex(scene, params["specular_reflectance"][slot], si)


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    cos_i = wi[..., 2]
    act = active & (cos_i > 0.0)
    wo = fr.reflect(wi)
    weight = fresnel_term(scene, params, slot, si, cos_i)
    bs = common.BSDFSample(
        wo=torch.where(flip[..., None], common.flip_z(wo), wo),
        pdf=torch.where(act, 1.0, 0.0), eta=torch.ones_like(cos_i),
        sampled_type=torch.full_like(cos_i, FLAGS, dtype=torch.int32))
    return bs, torch.where(act[..., None], weight, 0.0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    return common.zero_eval(scene, si)


def sample_mueller_weight(scene, params, slot, si, bs, weight, active,
                          mode=common.RADIANCE):
    """The polarized specular weight (conductor.cpp:242-264): the complex
    Fresnel matrix of each channel, rotated from the s/p frame of the
    plane of incidence into the implicit local Stokes bases of (-bs.wo,
    si.wi), times the specular reflectance as an absorber (pdf 1)."""
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    wo = torch.where(flip[..., None], common.flip_z(bs.wo), bs.wo)
    act = active & (wi[..., 2] > 0.0)
    wo_hat, wi_hat = common.mode_bases(wo, wi, mode)
    f_m = mu.specular_reflection(wo_hat[..., 2:3],
                                 spectrum(scene, params["eta"][slot], si),
                                 spectrum(scene, params["k"][slot], si))
    # the s axis is perpendicular to the plane of incidence
    # (conductor.cpp:255-257)
    n = torch.zeros_like(wo_hat)
    n[..., 2] = 1.0
    f_m = mu.to_local_frames(
        f_m, wo_hat, wi_hat, mu.plane_basis(cross(n, -wo_hat), -wo_hat),
        mu.plane_basis(cross(n, wi_hat), wi_hat), channels=True)
    refl = common.tex(scene, params["specular_reflectance"][slot], si)
    return torch.where(act[..., None, None, None],
                       f_m * refl[..., None, None], 0.0)
