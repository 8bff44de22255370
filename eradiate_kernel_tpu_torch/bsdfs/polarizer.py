"""Linear polarizer (bsdfs/polarizer.py counterpart; polarizer.cpp): a
flat delta-transmissive optical element. Unpolarized transport sees it
attenuate by transmittance / 2 (what an ideal polarizer does to
unpolarized light); the stokes integrator composes its Mueller matrix
(mueller.h linear_polarizer, rotated_element). Params: theta (the
rotation about the normal, in degrees), transmittance (texture index)."""

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
        "transmittance": builder.texture(props.get("transmittance", 1.0)),
        "twosided": builder.twosided_flag(props),
    }


def _trans(scene, params, slot, si):
    return common.tex(scene, params["transmittance"][slot], si)


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    return common.passthrough_sample(
        si, active, 0.5 * _trans(scene, params, slot, si), FLAGS)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    return common.zero_eval(scene, si)


def eval_null_transmission(scene, params, slot, si, active):
    return torch.where(active[..., None],
                       0.5 * _trans(scene, params, slot, si), 0.0)


def mueller(scene, params, slot, si, active):
    """The element's Mueller matrix in its own frame (fast axis: the
    element's dp_du rotated by theta)."""
    v = torch.mean(_trans(scene, params, slot, si), dim=-1)
    return mu.rotated_element(params["theta"][slot], mu.linear_polarizer(v))
