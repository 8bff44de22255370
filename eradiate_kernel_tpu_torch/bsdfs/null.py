"""Null (passthrough) BSDF of medium boundaries (bsdfs/null.py
counterpart): a ray crossing it keeps its direction and weight, and the
crossing counts as no scattering event."""

from __future__ import annotations

from . import common

FLAGS = common.Null | common.FrontSide | common.BackSide


def build(props, builder):
    return {"twosided": builder.twosided_flag(props)}


def sample(scene, params, slot, si, s1, s2, active):
    nc = scene.config.variant.channels(si.wavelengths)
    return common.passthrough_sample(si, active,
                                     si.t.new_ones(si.t.shape[0], nc), FLAGS)


def eval_pdf(scene, params, slot, si, wo, active):
    return common.zero_eval(scene, si)
