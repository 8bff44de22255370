"""Linear retarder, a wave plate (bsdfs/retarder.py counterpart;
retarder.cpp): delta-transmissive; unpolarized transport sees a
transmittance of 1, the stokes integrator composes linear_retarder(delta)
rotated by theta. Params: theta (degrees), delta (the phase delay in
degrees: 90 a quarter-wave plate, 180 a half-wave plate)."""

from __future__ import annotations

import numpy as np
import torch

from ..core import mueller as mu
from . import common

IS_POLARIZED_ELEMENT = True
FLAGS = common.Null | common.FrontSide | common.BackSide


def build(props, builder):
    return {
        "theta": np.float32(np.deg2rad(float(props.get("theta", 0.0)))),
        "delta": np.float32(np.deg2rad(float(props.get("delta", 90.0)))),
        "twosided": builder.twosided_flag(props),
    }


def _ones(scene, si):
    return si.t.new_ones(si.t.shape[0],
                         scene.config.variant.channels(si.wavelengths))


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    return common.passthrough_sample(si, active, _ones(scene, si), FLAGS)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    return common.zero_eval(scene, si)


def eval_null_transmission(scene, params, slot, si, active):
    return torch.where(active[..., None], _ones(scene, si), 0.0)


def mueller(scene, params, slot, si, active):
    return mu.rotated_element(params["theta"][slot],
                              mu.linear_retarder(params["delta"][slot]))

