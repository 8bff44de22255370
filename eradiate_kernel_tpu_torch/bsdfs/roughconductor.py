"""Rough conductor (bsdfs/roughconductor.py counterpart;
roughconductor.cpp): a microfacet reflection lobe with the conductor's
Fresnel term. Params: distribution ("ggx" or "beckmann"), alpha or
alpha_u / alpha_v (scalar roughness), eta and k, specular_reflectance,
twosided."""

from __future__ import annotations

import numpy as np
import torch

from ..core import mueller as mu
from ..core.math import cross, normalize
from ..render import fresnel as fr
from ..render import microfacet as mf
from . import common
from .conductor import _eta_k, spectrum

FLAGS = common.GlossyReflection | common.FrontSide


def build(props, builder):
    eta, k = _eta_k(props, builder)
    alpha = float(props.get("alpha", 0.1))
    return {
        "eta": eta, "k": k,
        "alpha_u": np.float32(props.get("alpha_u", alpha)),
        "alpha_v": np.float32(props.get("alpha_v", alpha)),
        "dist": np.int32(mf.distr_type(props.get("distribution", "ggx"))),
        "specular_reflectance": builder.texture(
            props.get("specular_reflectance", 1.0)),
        "twosided": builder.twosided_flag(props),
    }


def dist_sweep(params, slot, fn):
    """fn(dist_type) for both distributions, blended by each lane's
    ``dist`` (a data column, as in the reference: both are evaluated)."""
    dist = params["dist"][slot]
    out = None
    for ty in (mf.GGX, mf.BECKMANN):
        m = dist == ty
        res = fn(ty)
        sel = lambda r, o: torch.where(m[..., None] if r.ndim > m.ndim
                                       else m, r, o)
        out = ([sel(r, torch.zeros_like(r)) for r in res] if out is None
               else [sel(r, o) for r, o in zip(res, out)])
    return out


def _conductor_f(scene, params, slot, si, cos):
    return fr.fresnel_conductor(cos,
                                spectrum(scene, params["eta"][slot], si),
                                spectrum(scene, params["k"][slot], si))


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    act = active & (wi[..., 2] > 0.0)
    au = params["alpha_u"][slot]
    av = params["alpha_v"][slot]

    def per_dist(ty):
        m, pdf_m = mf.sample(ty, wi, au, av, s2)
        wo = fr.reflect_m(wi, m)
        ok = (pdf_m > 0) & (wo[..., 2] > 0)
        # the half-direction map's Jacobian: 1 / (4 |wo . m|)
        pdf = pdf_m / torch.clamp(4.0 * torch.abs(torch.sum(wo * m, -1)),
                                  min=1e-12)
        # visible normals: weight = F G2 / G1(wi) = F G1(wo)
        w_nof = torch.where(ok, mf.smith_g1(ty, wo, m, au, av), 0.0)
        return wo, torch.where(ok, pdf, 0.0), w_nof, torch.sum(wi * m, -1)

    wo, pdf, w_nof, cos_im = dist_sweep(params, slot, per_dist)
    weight = (_conductor_f(scene, params, slot, si, cos_im)
              * common.tex(scene, params["specular_reflectance"][slot], si)
              * w_nof[..., None])
    bs = common.BSDFSample(
        wo=torch.where(flip[..., None], common.flip_z(wo), wo),
        pdf=torch.where(act, pdf, 0.0), eta=torch.ones_like(pdf),
        sampled_type=torch.full_like(pdf, FLAGS, dtype=torch.int32))
    return bs, torch.where((act & (pdf > 0))[..., None], weight, 0.0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    wo = torch.where(flip[..., None], common.flip_z(wo), wo)
    cos_i = wi[..., 2]
    act = active & (cos_i > 0.0) & (wo[..., 2] > 0.0)
    au = params["alpha_u"][slot]
    av = params["alpha_v"][slot]
    h = normalize(wi + wo)

    def per_dist(ty):
        # D G F / (4 cos_i cos_o) times cos_o
        val = (mf.eval_d(ty, h, au, av) * mf.g_smith(ty, wi, wo, h, au, av)
               / torch.clamp(4.0 * cos_i, min=1e-12))
        pdf = mf.pdf(ty, wi, h, au, av) / torch.clamp(
            4.0 * torch.abs(torch.sum(wo * h, -1)), min=1e-12)
        return val, pdf

    val_nof, pdf = dist_sweep(params, slot, per_dist)
    value = (_conductor_f(scene, params, slot, si, torch.sum(wi * h, -1))
             * common.tex(scene, params["specular_reflectance"][slot], si)
             * val_nof[..., None])
    return (torch.where(act[..., None], value, 0.0),
            torch.where(act, pdf, 0.0))


def eval_mueller(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    """The polarized microfacet eval (roughconductor.cpp:315-340): eval
    with the scalar Fresnel term replaced by the complex Fresnel matrix
    about the half vector, rotated from the s/p frame of the microfacet
    reflection into the implicit Stokes bases of (-wo, wi). The
    per-channel (N, nc, 4, 4) stack, cosine included."""
    wi, flip = common.twosided_frame(params["twosided"][slot], si.wi)
    wo = torch.where(flip[..., None], common.flip_z(wo), wo)
    cos_i = wi[..., 2]
    act = active & (cos_i > 0.0) & (wo[..., 2] > 0.0)
    au = params["alpha_u"][slot]
    av = params["alpha_v"][slot]
    h = normalize(wi + wo)
    val_nof, = dist_sweep(params, slot, lambda ty: (
        mf.eval_d(ty, h, au, av) * mf.g_smith(ty, wi, wo, h, au, av)
        / torch.clamp(4.0 * cos_i, min=1e-12),))
    wo_hat, wi_hat = common.mode_bases(wo, wi, mode)
    f_m = mu.specular_reflection(torch.sum(wo_hat * h, -1)[..., None],
                                 spectrum(scene, params["eta"][slot], si),
                                 spectrum(scene, params["k"][slot], si))
    f_m = mu.to_local_frames(
        f_m, wo_hat, wi_hat, mu.plane_basis(cross(h, -wo_hat), -wo_hat),
        mu.plane_basis(cross(h, wi_hat), wi_hat), channels=True)
    refl = common.tex(scene, params["specular_reflectance"][slot], si)
    out = (refl * val_nof[..., None])[..., None, None] * f_m
    return torch.where(act[..., None, None, None], out, 0.0)
