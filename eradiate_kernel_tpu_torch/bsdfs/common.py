"""BSDF flags and the sample record (bsdfs/common.py counterpart)."""

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
FrontSide = 0x8000
BackSide = 0x10000

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


def zero_bsdf_sample(n, nc, device):
    wo = torch.zeros(n, 3, device=device)
    wo[:, 2] = 1.0
    return BSDFSample(
        wo=wo, pdf=torch.zeros(n, device=device),
        eta=torch.ones(n, device=device),
        sampled_type=torch.zeros(n, dtype=torch.int32, device=device),
    ), torch.zeros(n, nc, device=device)


def flip_z(v):
    return torch.cat([v[..., :2], -v[..., 2:]], dim=-1)


def twosided_frame(twosided, wi):
    """Back-side hits of a twosided BSDF work in the flipped frame.
    Returns (wi', flip mask)."""
    flip = twosided & (wi[..., 2] < 0.0)
    return torch.where(flip[..., None], flip_z(wi), wi), flip
