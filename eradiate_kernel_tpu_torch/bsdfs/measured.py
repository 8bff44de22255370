"""Data-driven measured BRDF (bsdfs/measured.py counterpart; Mitsuba's
measured.cpp, the Dupuy & Jakob 2018 adaptively parameterized format).

A ``.bsdf`` tensor file stores, on a (phi_i, theta_i) grid of incident
directions: the microfacet NDF and projected area sigma, a VNDF warp over
the half-vector unit square, a luminance warp for importance sampling, and
spectral measurements over the VNDF-warped unit square. Sampling is the
luminance warp, then the VNDF warp, then a microfacet reflection; eval and
pdf invert the same chain.

The five Marginal2D interpolants are ``core.marginal2d`` tables. Each
slot's tables have resolutions of their own (the config's
``bsdf_static``), so the dispatch loops over slots and slices each slot's
padded registry rows back to their true shapes. Spectra are read at the
lane's hero wavelengths in spectral, and at fixed wavelengths in rgb (612,
549 and 465 nm) and at 612 nm in mono, as the reference reads them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import marginal2d as m2d
from ..core.math import normalize, sqr
from ..utils.tensorfile import read_tensor_file
from . import common

FLAGS = common.GlossyReflection | common.FrontSide

_RGB_REP_WAVELENGTHS = (612.0, 549.0, 465.0)


def build(props, builder):
    fields = (props["fields"] if "fields" in props
              else read_tensor_file(props["filename"]))
    theta_i = np.asarray(fields["theta_i"], np.float32)
    phi_i = np.asarray(fields["phi_i"], np.float32)
    wav = np.asarray(fields["wavelengths"], np.float32)
    ndf = np.asarray(fields["ndf"], np.float32)
    sigma = np.asarray(fields["sigma"], np.float32)
    vndf = np.asarray(fields["vndf"], np.float32)
    lum = np.asarray(fields["luminance"], np.float32)
    spectra = np.asarray(fields["spectra"], np.float32)
    jac = bool(np.asarray(fields.get("jacobian", [1])).ravel()[0])
    P, T, L = len(phi_i), len(theta_i), len(wav)
    if (vndf.shape[:2] != (P, T) or lum.shape[:2] != (P, T)
            or spectra.shape[:3] != (P, T, L)):
        raise ValueError("measured: table shapes disagree with the "
                         "(phi_i, theta_i, wavelengths) grid")
    isotropic = P <= 2
    reduction = 0 if isotropic else int(round(
        (2 * np.pi) / (phi_i[-1] - phi_i[0])))
    vndf_tabs = m2d.build_continuous(vndf, normalize=True)
    lum_tabs = m2d.build_continuous(lum, normalize=True)
    static = ((P, T, L), tuple(vndf.shape[-2:]), tuple(lum.shape[-2:]),
              tuple(spectra.shape[-2:]), tuple(ndf.shape),
              tuple(sigma.shape), isotropic, jac, reduction)
    return {
        "phi_i": phi_i, "theta_i": theta_i, "wavelengths": wav,
        "ndf": ndf, "sigma": sigma, "spectra": spectra,
        "vndf_data": vndf_tabs["data"], "vndf_cond": vndf_tabs["cond_cdf"],
        "vndf_marg": vndf_tabs["marg_cdf"],
        "lum_data": lum_tabs["data"], "lum_cond": lum_tabs["cond_cdf"],
        "lum_marg": lum_tabs["marg_cdf"],
        "twosided": builder.twosided_flag(props),
        "_static": static,
    }


def _statics(scene):
    for kind, slots in scene.config.bsdf_static:
        if kind == "measured":
            return slots
    return ()


def _slot_tables(params, st, s):
    """Slot s's tables sliced back to their true shapes."""
    (P, T, L), (vh, vw), (lh, lw), (sh, sw), ndf_hw, sig_hw, iso, jac, red \
        = st
    pv2 = (params["phi_i"][s][:P], params["theta_i"][s][:T])
    return dict(
        pv2=pv2, pv3=pv2 + (params["wavelengths"][s][:L],), iso=iso,
        jac=jac, red=red,
        vndf={"data": params["vndf_data"][s][:P, :T, :vh, :vw],
              "cond_cdf": params["vndf_cond"][s][:P, :T, :vh, :vw - 1],
              "marg_cdf": params["vndf_marg"][s][:P, :T, :vh - 1]},
        lum={"data": params["lum_data"][s][:P, :T, :lh, :lw],
             "cond_cdf": params["lum_cond"][s][:P, :T, :lh, :lw - 1],
             "marg_cdf": params["lum_marg"][s][:P, :T, :lh - 1]},
        spectra={"data": params["spectra"][s][:P, :T, :L, :sh, :sw]},
        ndf={"data": params["ndf"][s][:ndf_hw[0], :ndf_hw[1]]},
        sigma={"data": params["sigma"][s][:sig_hw[0], :sig_hw[1]]})


# --- the angular parameterization ------------------------------------------

def _elevation(d):
    """acos(cos theta), stably: 2 asin(|d - z| / 2)."""
    dist = torch.sqrt(sqr(d[..., 0]) + sqr(d[..., 1]) + sqr(d[..., 2] - 1.0))
    return 2.0 * torch.asin(torch.clamp(0.5 * dist, -1.0, 1.0))


def _u2theta(u):
    return u * u * (math.pi / 2.0)


def _u2phi(u):
    return (2.0 * u - 1.0) * math.pi


def _theta2u(theta):
    return torch.sqrt(theta * (2.0 / math.pi))


def _phi2u(phi):
    return (phi + math.pi) * (0.5 / math.pi)


def _mulsign_neg(a, b):
    return torch.where(b >= 0, -a, a)


def _lane_wavelengths(si, nc):
    """(N, nc) wavelengths: the lane's own in spectral, else the rgb
    primaries' (mono reads the first)."""
    if si.wavelengths.shape[-1]:
        return si.wavelengths
    return torch.tensor(_RGB_REP_WAVELENGTHS[:nc], dtype=torch.float32,
                        device=si.t.device).expand(si.t.shape[0], nc)


def _reduce_in(tabs, wi, wo=None):
    """Fold wi (and wo) into the measured sector of anisotropic data with
    a symmetry reduction."""
    if tabs["red"] < 2:
        return wi, wo, None, None
    sy = wi[..., 1]
    sx = wi[..., 0] if tabs["red"] == 4 else sy

    def fold(v):
        return torch.stack([_mulsign_neg(v[..., 0], sx),
                            _mulsign_neg(v[..., 1], sy), v[..., 2]], dim=-1)

    return fold(wi), (None if wo is None else fold(wo)), sx, sy


def _spectra_eval(tabs, pos, phi_i, theta_i, wl, active):
    """The spectral lookup of each channel at the VNDF-inverted pos."""
    return torch.stack([
        m2d.eval(tabs["spectra"], pos, tabs["pv3"],
                 (phi_i, theta_i, wl[..., c]), active)
        for c in range(wl.shape[-1])], dim=-1)


def _jacobian_factor(tabs, u_m, u_wi, act):
    """ndf / (4 sigma) of the stored jacobian."""
    ndf_v = m2d.eval(tabs["ndf"], u_m, (), (), act)
    sigma_v = m2d.eval(tabs["sigma"], u_wi, (), (), act)
    return (ndf_v / torch.clamp(4.0 * sigma_v, min=1e-12))[..., None]


def _invert_chain(tabs, wi, wo, active):
    """The eval/pdf chain: half-vector, unit square, VNDF inverse.
    Returns (sample_pos, vndf_pdf, u_m, u_wi, phi_i, theta_i, m)."""
    m = normalize(wi + wo)
    theta_i = _elevation(wi)
    phi_i = torch.atan2(wi[..., 1], wi[..., 0])
    theta_m = _elevation(m)
    phi_m = torch.atan2(m[..., 1], m[..., 0])
    u_m_y = _phi2u(phi_m - phi_i if tabs["iso"] else phi_m)
    u_m = torch.stack([_theta2u(theta_m), u_m_y - torch.floor(u_m_y)], -1)
    u_wi = torch.stack([_theta2u(theta_i), _phi2u(phi_i)], dim=-1)
    pos, vndf_pdf = m2d.invert(tabs["vndf"], u_m, tabs["pv2"],
                               (phi_i, theta_i), active)
    return pos, vndf_pdf, u_m, u_wi, phi_i, theta_i, m


def _sample_jacobian(u_m_x, sin_theta_m, wi, m):
    """d(wo)/d(u_m) of the warp chain."""
    return (torch.clamp(2.0 * math.pi ** 2 * u_m_x * sin_theta_m, min=1e-6)
            * 4.0 * torch.sum(wi * m, dim=-1))


def _eval_pdf_slot(tabs, wi_in, wo_in, active, wl):
    wi0, wo0, _, _ = _reduce_in(tabs, wi_in, wo_in)
    act = active & (wi0[..., 2] > 0) & (wo0[..., 2] > 0)
    pos, vndf_pdf, u_m, u_wi, phi_i, theta_i, m = _invert_chain(
        tabs, wi0, wo0, act)
    spec = _spectra_eval(tabs, pos, phi_i, theta_i, wl, act)
    if tabs["jac"]:
        spec = spec * _jacobian_factor(tabs, u_m, u_wi, act)
    lum_pdf = m2d.eval(tabs["lum"], pos, tabs["pv2"], (phi_i, theta_i), act)
    sin_theta_m = torch.sqrt(torch.clamp(1.0 - sqr(m[..., 2]), 0.0, 1.0))
    pdf = vndf_pdf * lum_pdf / _sample_jacobian(u_m[..., 0], sin_theta_m,
                                                wi0, m)
    return (torch.where(act[..., None], spec, 0.0),
            torch.where(act & (pdf > 0), pdf, 0.0))


def _sample_slot(tabs, wi_in, s2, active, wl):
    wi0, _, sx, sy = _reduce_in(tabs, wi_in)
    act = active & (wi0[..., 2] > 0)
    theta_i = _elevation(wi0)
    phi_i = torch.atan2(wi0[..., 1], wi0[..., 0])
    u_wi = torch.stack([_theta2u(theta_i), _phi2u(phi_i)], dim=-1)
    # the luminance warp feeds the VNDF warp
    smp = torch.stack([s2[..., 1], s2[..., 0]], dim=-1)
    smp, lum_pdf = m2d.sample(tabs["lum"], smp, tabs["pv2"],
                              (phi_i, theta_i), act)
    u_m, vndf_pdf = m2d.sample(tabs["vndf"], smp, tabs["pv2"],
                               (phi_i, theta_i), act)
    phi_m = _u2phi(u_m[..., 1])
    theta_m = _u2theta(u_m[..., 0])
    if tabs["iso"]:
        phi_m = phi_m + phi_i
    sin_t, cos_t = torch.sin(theta_m), torch.cos(theta_m)
    m = torch.stack([torch.cos(phi_m) * sin_t, torch.sin(phi_m) * sin_t,
                     cos_t], dim=-1)
    wo = 2.0 * torch.sum(m * wi0, dim=-1, keepdim=True) * m - wi0
    pdf = vndf_pdf * lum_pdf / _sample_jacobian(u_m[..., 0], sin_t, wi0, m)
    spec = _spectra_eval(tabs, smp, phi_i, theta_i, wl, act)
    if tabs["jac"]:
        spec = spec * _jacobian_factor(tabs, u_m, u_wi, act)
    if sx is not None:
        wo = torch.stack([_mulsign_neg(wo[..., 0], sx),
                          _mulsign_neg(wo[..., 1], sy), wo[..., 2]], dim=-1)
    act = act & (wo[..., 2] > 0) & (pdf > 0)
    weight = torch.where(act[..., None],
                         spec / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
    return wo, torch.where(act, pdf, 0.0), weight


def _twosided(params, s, si):
    return common.twosided_frame(params["twosided"][s].expand(si.t.shape),
                                 si.wi)


def eval_pdf(scene, params, slot, si, wo, active):
    nc = scene.config.variant.channels(si.wavelengths)
    wl = _lane_wavelengths(si, nc)
    value = torch.zeros(si.t.shape[0], nc, device=si.t.device)
    pdf = torch.zeros_like(si.t)
    for s, st in enumerate(_statics(scene)):
        m = active & (slot == s)
        wi, flip = _twosided(params, s, si)
        wo_s = torch.where(flip[..., None], common.flip_z(wo), wo)
        v, p = _eval_pdf_slot(_slot_tables(params, st, s), wi, wo_s, m, wl)
        value = torch.where(m[..., None], v, value)
        pdf = torch.where(m, p, pdf)
    return value, pdf


def sample(scene, params, slot, si, s1, s2, active):
    nc = scene.config.variant.channels(si.wavelengths)
    wl = _lane_wavelengths(si, nc)
    bs, weight = common.zero_bsdf_sample(si.t.shape[0], nc, si.t.device,
                                         si.t.dtype)
    for s, st in enumerate(_statics(scene)):
        m = active & (slot == s)
        wi, flip = _twosided(params, s, si)
        wo, pdf, w = _sample_slot(_slot_tables(params, st, s), wi, s2, m, wl)
        wo = torch.where(flip[..., None], common.flip_z(wo), wo)
        bs = dataclasses.replace(
            bs, wo=torch.where(m[..., None], wo, bs.wo),
            pdf=torch.where(m, pdf, bs.pdf),
            sampled_type=torch.where(m, FLAGS, bs.sampled_type).to(
                torch.int32))
        weight = torch.where(m[..., None], w, weight)
    return bs, weight
