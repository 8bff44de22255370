"""Circular polarizer (bsdfs/circular.py counterpart; circular.cpp):
delta-transmissive; unpolarized transport sees it halve the light, the
stokes integrator composes the right (or, with ``left_handed``, the left)
circular polarizer's matrix."""

from __future__ import annotations

import numpy as np
import torch

from ..core import mueller as mu
from . import common

IS_POLARIZED_ELEMENT = True
FLAGS = common.Null | common.FrontSide | common.BackSide


def build(props, builder):
    return {
        "left_handed": np.bool_(props.get("left_handed", False)),
        "twosided": builder.twosided_flag(props),
    }


def _halves(scene, si):
    return si.t.new_full((si.t.shape[0],
                          scene.config.variant.channels(si.wavelengths)), 0.5)


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    return common.passthrough_sample(si, active, _halves(scene, si), FLAGS)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    return common.zero_eval(scene, si)


def eval_null_transmission(scene, params, slot, si, active):
    return torch.where(active[..., None], _halves(scene, si), 0.0)


def mueller(scene, params, slot, si, active):
    kw = dict(dtype=si.t.dtype, device=si.t.device)
    return torch.where(params["left_handed"][slot][..., None, None],
                       mu.left_circular_polarizer(**kw),
                       mu.right_circular_polarizer(**kw))

