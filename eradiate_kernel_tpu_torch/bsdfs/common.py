"""BSDF flags, the transport modes, the sample record and shared helpers
(bsdfs/common.py counterpart). Every kind is a module of wavefront
functions:

  build(props, builder) -> row dict          (host side, scene build)
  sample(scene, params, slot, si, s1, s2, active, mode=RADIANCE)
      -> (BSDFSample, weight)
  eval_pdf(scene, params, slot, si, wo, active, mode=RADIANCE)
      -> (value, pdf)

``weight`` is value * cos / pdf; ``value`` includes the cosine. ``mode``
is the transport mode of Mitsuba's BSDFContext: RADIANCE (what every
integrator passes, by default) or IMPORTANCE (light traced from the
emitters). It changes the result of six kinds only, as in the reference:
an IMPORTANCE refraction drops the eta^2 radiance compression
(dielectric, roughdielectric), and the Mueller matrices of the polarized
entries swap their bases (wo_hat = wi, wi_hat = wo: conductor,
dielectric, roughconductor, roughdielectric, pplastic,
measured_polarized)."""

from __future__ import annotations

import dataclasses

import torch

from ..core.types import resolve_device

# BSDFFlags (bsdf.h:38-124)
Empty = 0x0
DiffuseReflection = 0x2
DiffuseTransmission = 0x4
GlossyReflection = 0x8
GlossyTransmission = 0x10
DeltaReflection = 0x20
DeltaTransmission = 0x40
Null = 0x1
Anisotropic = 0x1000
SpatiallyVarying = 0x2000
NonSymmetric = 0x4000
FrontSide = 0x8000
BackSide = 0x10000

Reflection = DiffuseReflection | GlossyReflection | DeltaReflection
Transmission = (DiffuseTransmission | GlossyTransmission | DeltaTransmission
                | Null)
All = Reflection | Transmission

Diffuse = DiffuseReflection | DiffuseTransmission
Glossy = GlossyReflection | GlossyTransmission
Smooth = Diffuse | Glossy
Delta = DeltaReflection | DeltaTransmission | Null

# transport modes (BSDFContext)
RADIANCE = "radiance"
IMPORTANCE = "importance"


@dataclasses.dataclass(frozen=True)
class BSDFSample:
    wo: torch.Tensor            # (N, 3) local frame
    pdf: torch.Tensor           # (N,)
    eta: torch.Tensor           # (N,) relative ior change
    sampled_type: torch.Tensor  # (N,) i32 lobe flags

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def mode_bases(wo, wi, mode):
    """(wo_hat, wi_hat): the directions whose implicit Stokes bases a
    polarized entry's Mueller matrix is expressed in. The light arrives
    along -wo_hat and leaves along wi_hat: (wo, wi) in RADIANCE, swapped
    in IMPORTANCE."""
    return (wo, wi) if mode == RADIANCE else (wi, wo)


def radiance_scale(eta_ti, mode):
    """A refraction's radiance compression eta_ti^2 in RADIANCE; 1 in
    IMPORTANCE, which carries no such factor (dielectric.cpp:165-170)."""
    return torch.square(eta_ti) if mode == RADIANCE \
        else torch.ones_like(eta_ti)


def zero_bsdf_sample(batch, nc, device=None, dtype=torch.float32):
    """The empty sample (wo = +z, pdf 0, eta 1, no lobe) and a zero weight
    (*batch, nc) over ``batch`` lanes (a count or a shape), on ``device``
    (resolved as the entry points resolve it: CUDA unless named)."""
    batch = tuple(batch) if isinstance(batch, (tuple, list)) \
        else (int(batch),)
    device = resolve_device(device)
    wo = torch.zeros(batch + (3,), dtype=dtype, device=device)
    wo[..., 2] = 1.0
    return BSDFSample(
        wo=wo, pdf=torch.zeros(batch, dtype=dtype, device=device),
        eta=torch.ones(batch, dtype=dtype, device=device),
        sampled_type=torch.zeros(batch, dtype=torch.int32, device=device),
    ), torch.zeros(batch + (nc,), dtype=dtype, device=device)


def zero_eval(scene, si):
    """A delta BSDF's eval_pdf: zero value (N, nc) and pdf (N,)."""
    n = si.t.shape[0]
    return (si.t.new_zeros(n, scene.config.variant.channels(si.wavelengths)),
            si.t.new_zeros(n))


def passthrough_sample(si, active, weight, flags):
    """The straight-through sample of a null interface or a
    delta-transmissive element: wo = -wi, pdf 1, ``weight`` (N, nc) on the
    active lanes."""
    n = si.t.shape[0]
    bs = BSDFSample(
        wo=-si.wi, pdf=torch.where(active, 1.0, 0.0), eta=si.t.new_ones(n),
        sampled_type=torch.full((n,), flags, dtype=torch.int32,
                                device=si.t.device))
    return bs, torch.where(active[..., None], weight, 0.0)


def flip_z(v):
    return torch.cat([v[..., :2], -v[..., 2:]], dim=-1)


def twosided_frame(twosided, wi):
    """Back-side hits of a twosided BSDF work in the flipped frame.
    Returns (wi', flip mask)."""
    flip = twosided & (wi[..., 2] < 0.0)
    return torch.where(flip[..., None], flip_z(wi), wi), flip


def tex(scene, index, si, mesh_attributes=False):
    """Texture ``index`` (N,) at the lanes' uv and wavelengths. Only the
    diffuse BSDF hands
    a mesh_attribute texture its primitive (``mesh_attributes``), as in the
    reference; elsewhere that texture reads 0 there too."""
    from ..render.texture import texture_eval

    if mesh_attributes:
        return texture_eval(scene, index, si.uv, si.wavelengths,
                            si_extra={"prim_index": si.prim_index,
                                      "prim_uv": si.prim_uv})
    return texture_eval(scene, index, si.uv, wavelengths=si.wavelengths)
