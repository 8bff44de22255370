"""Measured polarized pBRDF (bsdfs/measured_polarized.py counterpart;
measured_polarized.cpp, the Baek et al. 2020 KAIST dataset).

A ``.pbsdf`` tensor file stores full 4x4 Mueller matrices on an isotropic
Rusinkiewicz grid (phi_d, theta_d, theta_h) x wavelength bands. The
reference interpolates the 4x4 block multilinearly over the four
parameters (measured_polarized.cpp:99, 154-166); here each interpolation
corner gathers the whole 16-float block.

Sampling does not read the data: a fixed mixture of the cosine hemisphere
(weight 0.1) and GGX visible normals at the ``alpha_sample`` roughness
(measured_polarized.cpp:13, 183-204). ``eval_pdf`` returns M00 x cos
theta_o; ``eval_mueller`` rotates into the standard frame, looks the
matrix up and aligns its Stokes bases (measured_polarized.cpp:218-289).
Each slot's grid has its own size (the config's ``bsdf_static``).

Spectral variants read the lanes' wavelengths (clamped to the measured
range by the interpolation); rgb and mono read fixed primaries, as the
reference does (Mitsuba refuses them, measured_polarized.cpp:102-103). A
positive ``wavelength`` pins every channel to it
(measured_polarized.cpp:262-272).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import mueller as mu
from ..core import warp
from ..core.marginal2d import _interp_corners
from ..core.math import cross, dot, normalize
from ..render import microfacet as mf
from ..utils.tensorfile import read_tensor_file
from . import common

FLAGS = common.GlossyReflection | common.FrontSide

_COSINE_WEIGHT = 0.1  # measured_polarized.cpp:13
_RGB_REP_WAVELENGTHS = (612.0, 549.0, 465.0)


def build(props, builder):
    fields = (props["fields"] if "fields" in props
              else read_tensor_file(props["filename"]))
    theta_h = np.asarray(fields["theta_h"], np.float32).ravel()
    theta_d = np.asarray(fields["theta_d"], np.float32).ravel()
    phi_d = np.asarray(fields["phi_d"], np.float32).ravel()
    wvls = np.asarray(fields["wvls"], np.float32).ravel()
    m = np.asarray(fields["M"], np.float32)
    P, T, H, L = len(phi_d), len(theta_d), len(theta_h), len(wvls)
    if m.shape != (P, T, H, L, 4, 4):
        raise ValueError(f"measured_polarized: M {m.shape}, the grid "
                         f"wants {(P, T, H, L, 4, 4)}")
    return {
        "m": m, "phi_d": phi_d, "theta_d": theta_d, "theta_h": theta_h,
        "wvls": wvls,
        "alpha_sample": np.float32(props.get("alpha_sample", 0.1)),
        "wavelength": np.float32(props.get("wavelength", -1.0)),
        "twosided": builder.twosided_flag(props),
        "_static": (P, T, H, L),
    }


def _statics(scene):
    for kind, slots in scene.config.bsdf_static:
        if kind == "measured_polarized":
            return slots
    return ()


def _lane_wavelengths(params, s, si, nc):
    """(N, nc) wavelengths of slot s: its fixed one, else the lanes' own
    in spectral, else the rgb primaries'."""
    if si.wavelengths.shape[-1]:
        wl = si.wavelengths
    else:
        reps = (_RGB_REP_WAVELENGTHS[:nc] if nc <= 3
                else _RGB_REP_WAVELENGTHS + (550.0,) * (nc - 3))
        wl = torch.tensor(reps, dtype=si.t.dtype,
                          device=si.t.device).expand(si.t.shape[0], nc)
    fixed = params["wavelength"][s]
    return torch.where(fixed > 0, fixed, wl)


def _phi_positive(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0, p + 2 * math.pi, p)


def _rotate_z(v, angle):
    """A rotation about +z (measured_polarized.cpp:357-363)."""
    s, c = torch.sin(angle), torch.cos(angle)
    return torch.stack([v[..., 0] * c - v[..., 1] * s,
                        v[..., 0] * s + v[..., 1] * c, v[..., 2]], dim=-1)


def _safe_norm(v, fallback):
    n2 = dot(v, v, keepdims=True)
    ok = n2 > 1e-16
    v = torch.where(ok, v, 1.0)
    v = v / torch.sqrt(torch.where(ok, dot(v, v, keepdims=True), 1.0))
    return torch.where(ok, v, torch.tensor(fallback, dtype=v.dtype,
                                           device=v.device))


def _acos(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def _rusinkiewicz(i, o):
    """(phi_d, theta_h, theta_d) of the isotropic Rusinkiewicz
    parameterization (measured_polarized.cpp:365-384)."""
    h = normalize(i + o)
    n = torch.zeros_like(h)
    n[..., 2] = 1.0
    b = _safe_norm(cross(n, h), (1.0, 0.0, 0.0))
    t = _safe_norm(cross(b, h), (0.0, 1.0, 0.0))
    td = _acos(dot(h, i))
    th = _acos(h[..., 2])
    i_prj = _safe_norm(i - dot(i, h, keepdims=True) * h, (1.0, 0.0, 0.0))
    cos_pd = torch.clamp(dot(t, i_prj), -1.0, 1.0)
    sin_pd = torch.clamp(dot(b, i_prj), -1.0, 1.0)
    return torch.atan2(sin_pd, cos_pd), th, td


def _interp_mueller(params, st, s, phi_d, theta_d, theta_h, wl, active):
    """The parameter-interpolated 4x4 lookup, one 16-float gather per
    interpolation corner (measured_polarized.cpp:249-272) -> (N, 4, 4)."""
    P, T, H, L = st
    pv = (params["phi_d"][s][:P], params["theta_d"][s][:T],
          params["theta_h"][s][:H], params["wvls"][s][:L])
    offs, wts = _interp_corners(pv, (phi_d, theta_d, theta_h, wl))
    table = params["m"][s][:P, :T, :H, :L].reshape(-1, 16)
    out = None
    for o, w in zip(offs, wts):
        idx = torch.zeros_like(phi_d, dtype=torch.long) if o is None else o
        v = w[..., None] * table[idx]
        out = v if out is None else out + v
    out = out.reshape(out.shape[:-1] + (4, 4))
    return torch.where(active[..., None, None], out, 0.0)


def _std_params(wo, wi):
    """The standard-frame rotation of a configuration: (phi_std, wo_std,
    wi_std)."""
    phi_std = _phi_positive(wi)
    return phi_std, _rotate_z(wo, -phi_std), _rotate_z(wi, -phi_std)


def _mueller_per_channel(params, st, s, wi, wo, wl, active, mode):
    """The polarized eval: the per-channel stack (N, nc, 4, 4) in the
    implicit Stokes bases of -wo_hat and wi_hat
    (measured_polarized.cpp:218-289)."""
    wo, wi = common.mode_bases(wo, wi, mode)
    phi_std, wo_std, wi_std = _std_params(wo, wi)
    pd, th, td = _rusinkiewicz(wo_std, wi_std)
    m = torch.stack([_interp_mueller(params, st, s, pd, td, th, wl[..., c],
                                     active)
                     for c in range(wl.shape[-1])], dim=-3)
    # NaN-encoded invalid configurations -> 0
    # (measured_polarized.cpp:274-276)
    bad = torch.any(torch.isnan(m[..., 0, 0]), dim=-1)
    m = torch.nan_to_num(torch.where(bad[..., None, None, None], 0.0, m))
    m00 = torch.clamp(m[..., 0, 0], min=0.0)
    m = torch.cat([torch.cat([m00[..., None, None], m[..., :1, 1:]], -1),
                   m[..., 1:, :]], -2)
    # the Stokes frames of the standard configuration (Baek et al. fig. 4)
    zo = -wo_std
    to = _safe_norm(cross(wo_std - wi_std, zo), (1.0, 0.0, 0.0))
    xo = cross(_safe_norm(cross(to, zo), (0.0, 1.0, 0.0)), zo)
    zi = wi_std
    ti = _safe_norm(cross(wi_std - wo_std, zi), (1.0, 0.0, 0.0))
    xi = cross(_safe_norm(cross(ti, zi), (0.0, 1.0, 0.0)), zi)
    return mu.to_local_frames(m, wo, wi, _rotate_z(xo, phi_std),
                              _rotate_z(xi, phi_std), channels=True)


def _pdf(params, s, wi, wo, active):
    """The fixed cosine / GGX mixture (measured_polarized.cpp:315-338)."""
    alpha = params["alpha_sample"][s]
    h = normalize(wi + wo)
    pdf_micro = mf.pdf(mf.GGX, wi, h, alpha, alpha) \
        / torch.clamp(4.0 * dot(wo, h), min=1e-12)
    pdf = (_COSINE_WEIGHT * warp.square_to_cosine_hemisphere_pdf(wo)
           + (1.0 - _COSINE_WEIGHT) * pdf_micro)
    return torch.where(active & (wi[..., 2] > 0) & (wo[..., 2] > 0), pdf,
                       0.0)


def _slot_frame(params, s, si, wo):
    """(wi, wo, both above the surface) of slot s in its twosided
    frame."""
    wi, flip = common.twosided_frame(params["twosided"][s].expand(
        si.t.shape), si.wi)
    wo = torch.where(flip[..., None], common.flip_z(wo), wo)
    return wi, wo, (wi[..., 2] > 0) & (wo[..., 2] > 0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    nc = scene.config.variant.channels(si.wavelengths)
    value = si.t.new_zeros(si.t.shape[0], nc)
    pdf = torch.zeros_like(si.t)
    for s, st in enumerate(_statics(scene)):
        m = active & (slot == s)
        wi, wo_s, ok = _slot_frame(params, s, si, wo)
        act = m & ok
        wl = _lane_wavelengths(params, s, si, nc)
        _phi, wo_std, wi_std = _std_params(
            *common.mode_bases(wo_s, wi, mode))
        pd, th, td = _rusinkiewicz(wo_std, wi_std)
        v = torch.stack([
            _interp_mueller(params, st, s, pd, td, th, wl[..., c],
                            act)[..., 0, 0] for c in range(nc)], dim=-1)
        # value x cos theta_o (measured_polarized.cpp:312)
        v = torch.clamp(torch.nan_to_num(v), min=0.0) * wo_s[..., 2:3]
        value = torch.where(m[..., None], torch.where(act[..., None], v, 0.0),
                            value)
        pdf = torch.where(m, _pdf(params, s, wi, wo_s, act), pdf)
    return value, pdf


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    nc = scene.config.variant.channels(si.wavelengths)
    bs, weight = common.zero_bsdf_sample(si.t.shape[0], nc, si.t.device,
                                         si.t.dtype)
    for s, _st in enumerate(_statics(scene)):
        m = active & (slot == s)
        wi, flip = common.twosided_frame(params["twosided"][s].expand(
            si.t.shape), si.wi)
        act = m & (wi[..., 2] > 0)
        alpha = params["alpha_sample"][s].expand(si.t.shape)
        mh, _ = mf.sample(mf.GGX, wi, alpha, alpha, s2)
        wo = torch.where((s1 < _COSINE_WEIGHT)[..., None],
                         warp.square_to_cosine_hemisphere(s2),
                         2.0 * dot(mh, wi, keepdims=True) * mh - wi)
        wo_world = torch.where(flip[..., None], common.flip_z(wo), wo)
        v, p = eval_pdf(scene, params, torch.full_like(slot, s), si,
                        wo_world, m, mode)
        act_o = act & (wo[..., 2] > 0) & (p > 0)
        w = torch.where(act_o[..., None],
                        v / torch.clamp(p, min=1e-20)[..., None], 0.0)
        bs = dataclasses.replace(
            bs, wo=torch.where(m[..., None], wo_world, bs.wo),
            pdf=torch.where(m, torch.where(act_o, p, 0.0), bs.pdf),
            sampled_type=torch.where(m, FLAGS, bs.sampled_type).to(
                torch.int32))
        weight = torch.where(m[..., None], w, weight)
    return bs, weight


def eval_mueller(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    """The polarization-aware eval: the per-channel stack (N, nc, 4, 4)
    times cos theta_o, in the implicit Stokes bases of -wo and wi."""
    nc = scene.config.variant.channels(si.wavelengths)
    out = si.t.new_zeros(si.t.shape[0], nc, 4, 4)
    for s, st in enumerate(_statics(scene)):
        m = active & (slot == s)
        wi, wo_s, ok = _slot_frame(params, s, si, wo)
        act = m & ok
        mm = _mueller_per_channel(params, st, s, wi, wo_s,
                                  _lane_wavelengths(params, s, si, nc), act,
                                  mode)
        mm = mm * wo_s[..., 2, None, None, None]
        out = torch.where(m[..., None, None, None],
                          torch.where(act[..., None, None, None], mm, 0.0),
                          out)
    return out
