"""BSDF registry and wavefront dispatch (bsdfs/__init__.py counterpart):
a masked sweep over the BSDF kinds present in the scene; each kind
evaluates the whole wavefront and the results are selected by kind mask.
Lanes of other kinds read slot 0 of each kind's table (the reference's
gathers clamp their indices; torch's indexing raises), in the nested
dispatch too.

Wrapper kinds (mask, blendbsdf, normalmap, bumpmap) hold a nested global
BSDF index and dispatch it over the non-wrapper kinds: one nesting
level, as in the reference."""

from __future__ import annotations

import torch

from . import (bilambertian, blendbsdf, bumpmap, common, conductor,
               dielectric, diffuse, mask, measured, normalmap, null, plastic,
               roughconductor, roughdielectric, roughplastic, rpv,
               thindielectric)
from .common import BSDFSample, zero_bsdf_sample

REGISTRY = {
    "diffuse": diffuse,
    "null": null,
    "rpv": rpv,
    "bilambertian": bilambertian,
    "conductor": conductor,
    "roughconductor": roughconductor,
    "dielectric": dielectric,
    "roughdielectric": roughdielectric,
    "thindielectric": thindielectric,
    "plastic": plastic,
    "roughplastic": roughplastic,
    "measured": measured,
    "mask": mask,
    "blendbsdf": blendbsdf,
    "normalmap": normalmap,
    "bumpmap": bumpmap,
}

WRAPPER_KINDS = tuple(k for k, v in REGISTRY.items()
                      if getattr(v, "IS_WRAPPER", False))


def _kinds(scene, nested):
    """(k, kind) of the scene's kinds; the non-wrapper ones if
    ``nested``."""
    return [(k, kind) for k, kind in enumerate(scene.config.bsdf_kinds)
            if not (nested and kind in WRAPPER_KINDS)]


def _sample(scene, bsdf_index, si, s1, s2, active, nested):
    kind_id = scene.bsdf_kind[bsdf_index]
    slot = scene.bsdf_slot[bsdf_index]
    nc = scene.config.variant.channels(si.wavelengths)
    bs, weight = zero_bsdf_sample(si.t.shape[0], nc, si.t.device)
    for k, kind in _kinds(scene, nested):
        m = active & (kind_id == k)
        b, w = REGISTRY[kind].sample(scene, scene.bsdfs[kind],
                                     torch.where(kind_id == k, slot, 0), si,
                                     s1, s2, m)
        bs = BSDFSample(
            wo=torch.where(m[..., None], b.wo, bs.wo),
            pdf=torch.where(m, b.pdf, bs.pdf),
            eta=torch.where(m, b.eta, bs.eta),
            sampled_type=torch.where(m, b.sampled_type, bs.sampled_type))
        weight = torch.where(m[..., None], w, weight)
    return bs, weight


def _eval_pdf(scene, bsdf_index, si, wo, active, nested):
    kind_id = scene.bsdf_kind[bsdf_index]
    slot = scene.bsdf_slot[bsdf_index]
    nc = scene.config.variant.channels(si.wavelengths)
    value = torch.zeros(si.t.shape[0], nc, device=si.t.device)
    pdf = torch.zeros_like(si.t)
    for k, kind in _kinds(scene, nested):
        m = active & (kind_id == k)
        v, p = REGISTRY[kind].eval_pdf(scene, scene.bsdfs[kind],
                                       torch.where(kind_id == k, slot, 0),
                                       si, wo, m)
        value = torch.where(m[..., None], v, value)
        pdf = torch.where(m, p, pdf)
    return value, pdf


def bsdf_sample(scene, bsdf_index, si, s1, s2, active):
    """Dispatch sample() over the kinds present -> (BSDFSample, weight)."""
    return _sample(scene, bsdf_index, si, s1, s2, active, False)


def bsdf_eval_pdf(scene, bsdf_index, si, wo, active):
    """Dispatch eval_pdf() -> (value incl. cosine (N, nc), pdf (N,))."""
    return _eval_pdf(scene, bsdf_index, si, wo, active, False)


def dispatch_sample_nested(scene, bsdf_index, si, s1, s2, active):
    """sample() over the non-wrapper kinds: a wrapper's nested BSDF."""
    return _sample(scene, bsdf_index, si, s1, s2, active, True)


def dispatch_eval_pdf_nested(scene, bsdf_index, si, wo, active):
    return _eval_pdf(scene, bsdf_index, si, wo, active, True)


def eval_null_transmission(scene, bsdf_index, si, active):
    """The unscattered straight-through transmittance (N, nc) of the kinds
    that have one (bsdf.h eval_null_transmission)."""
    kind_id = scene.bsdf_kind[bsdf_index]
    slot = scene.bsdf_slot[bsdf_index]
    nc = scene.config.variant.channels(si.wavelengths)
    out = torch.zeros(si.t.shape[0], nc, device=si.t.device)
    for k, kind in enumerate(scene.config.bsdf_kinds):
        fn = getattr(REGISTRY[kind], "eval_null_transmission", None)
        if fn is not None:
            m = active & (kind_id == k)
            out = torch.where(m[..., None], fn(
                scene, scene.bsdfs[kind], torch.where(kind_id == k, slot, 0),
                si, m), out)
    return out


__all__ = ["REGISTRY", "WRAPPER_KINDS", "bsdf_sample", "bsdf_eval_pdf",
           "dispatch_sample_nested", "dispatch_eval_pdf_nested",
           "eval_null_transmission", "common"]
