"""Null (passthrough) BSDF of medium boundaries (bsdfs/null.py
counterpart): a ray crossing it keeps its direction and weight, and the
crossing counts as no scattering event."""

from __future__ import annotations

import torch

from . import common

FLAGS = common.Null | common.FrontSide | common.BackSide


def build(props, builder):
    return {"twosided": builder.twosided_flag(props)}


def sample(scene, params, slot, si, s1, s2, active):
    n = si.t.shape[0]
    bs = common.BSDFSample(
        wo=-si.wi, pdf=torch.where(active, 1.0, 0.0),
        eta=si.t.new_ones(n),
        sampled_type=torch.full((n,), FLAGS, dtype=torch.int32,
                                device=si.t.device))
    nc = scene.config.variant.channels(si.wavelengths)
    return bs, torch.where(active[..., None],
                           si.t.new_ones(n, nc), 0.0)


def eval_pdf(scene, params, slot, si, wo, active):
    n = si.t.shape[0]
    return (si.t.new_zeros(n, scene.config.variant.channels(si.wavelengths)),
            si.t.new_zeros(n))
