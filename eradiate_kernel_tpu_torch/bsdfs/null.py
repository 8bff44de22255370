"""Null (passthrough) BSDF of medium boundaries (bsdfs/null.py
counterpart): a ray crossing it keeps its direction and weight, and the
crossing counts as no scattering event."""

from __future__ import annotations

import torch

from . import common

FLAGS = common.Null | common.FrontSide | common.BackSide


def build(props, builder):
    return {"twosided": builder.twosided_flag(props)}


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    nc = scene.config.variant.channels(si.wavelengths)
    return common.passthrough_sample(si, active,
                                     si.t.new_ones(si.t.shape[0], nc), FLAGS)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    return common.zero_eval(scene, si)


def eval_null_transmission(scene, params, slot, si, active):
    """The straight-through transmittance, 1 on the active lanes."""
    nc = scene.config.variant.channels(si.wavelengths)
    return torch.where(active[..., None], si.t.new_ones(si.t.shape[0], nc),
                       0.0)
