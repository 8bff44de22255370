"""BSDF flags, the sample record and shared helpers (bsdfs/common.py
counterpart). Every kind is a module of wavefront functions:

  build(props, builder) -> row dict          (host side, scene build)
  sample(scene, params, slot, si, s1, s2, active) -> (BSDFSample, weight)
  eval_pdf(scene, params, slot, si, wo, active)   -> (value, pdf)

``weight`` is value * cos / pdf; ``value`` includes the cosine. The port
carries the reference's RADIANCE transport mode only: its integrators
never pass IMPORTANCE (a grep of the JAX package finds it only inside
bsdfs/), so the kinds take no ``mode`` argument."""

from __future__ import annotations

import dataclasses

import torch

# BSDFFlags (bsdf.h:38-124)
DiffuseReflection = 0x2
DiffuseTransmission = 0x4
GlossyReflection = 0x8
GlossyTransmission = 0x10
DeltaReflection = 0x20
DeltaTransmission = 0x40
Null = 0x1
Anisotropic = 0x1000
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


@dataclasses.dataclass(frozen=True)
class BSDFSample:
    wo: torch.Tensor            # (N, 3) local frame
    pdf: torch.Tensor           # (N,)
    eta: torch.Tensor           # (N,) relative ior change
    sampled_type: torch.Tensor  # (N,) i32 lobe flags


def zero_bsdf_sample(n, nc, device, dtype=torch.float32):
    wo = torch.zeros(n, 3, dtype=dtype, device=device)
    wo[:, 2] = 1.0
    return BSDFSample(
        wo=wo, pdf=torch.zeros(n, dtype=dtype, device=device),
        eta=torch.ones(n, dtype=dtype, device=device),
        sampled_type=torch.zeros(n, dtype=torch.int32, device=device),
    ), torch.zeros(n, nc, dtype=dtype, device=device)


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
        return texture_eval(scene, index, si.uv, si.prim_index, si.prim_uv,
                            wavelengths=si.wavelengths)
    return texture_eval(scene, index, si.uv, wavelengths=si.wavelengths)
