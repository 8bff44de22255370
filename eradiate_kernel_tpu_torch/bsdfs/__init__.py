"""BSDF registry and wavefront dispatch (bsdfs/__init__.py:82-128
counterpart): a masked sweep over the BSDF kinds present in the scene;
each kind evaluates the whole wavefront and the results are selected by
kind mask. Lanes of other kinds read slot 0 of each kind's table (the
reference's gathers clamp their indices; torch's indexing raises)."""

from __future__ import annotations

import torch

from . import common, diffuse, null, rpv
from .common import BSDFSample, zero_bsdf_sample

REGISTRY = {
    "diffuse": diffuse,
    "null": null,
    "rpv": rpv,
}


def bsdf_sample(scene, bsdf_index, si, s1, s2, active):
    """Dispatch sample() over the kinds present -> (BSDFSample, weight)."""
    kind_id = scene.bsdf_kind[bsdf_index]
    slot = scene.bsdf_slot[bsdf_index]
    bs, weight = zero_bsdf_sample(si.t.shape[0], 3, si.t.device)
    for k, kind in enumerate(scene.config.bsdf_kinds):
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


def bsdf_eval_pdf(scene, bsdf_index, si, wo, active):
    """Dispatch eval_pdf() -> (value incl. cosine (N, 3), pdf (N,))."""
    kind_id = scene.bsdf_kind[bsdf_index]
    slot = scene.bsdf_slot[bsdf_index]
    value = torch.zeros(si.t.shape[0], 3, device=si.t.device)
    pdf = torch.zeros_like(si.t)
    for k, kind in enumerate(scene.config.bsdf_kinds):
        m = active & (kind_id == k)
        v, p = REGISTRY[kind].eval_pdf(scene, scene.bsdfs[kind],
                                       torch.where(kind_id == k, slot, 0),
                                       si, wo, m)
        value = torch.where(m[..., None], v, value)
        pdf = torch.where(m, p, pdf)
    return value, pdf


__all__ = ["REGISTRY", "bsdf_sample", "bsdf_eval_pdf", "common"]
