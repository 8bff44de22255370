"""Bump map (bsdfs/bumpmap.py counterpart; bumpmap.cpp): a scalar
height texture tilts the shading normal by its uv gradient, differenced
at a fixed uv step as in the reference; the nested BSDF runs in the
tilted frame. Row: bumpmap (texture index), scale, nested (global BSDF
index)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.frame import Frame
from ..core.math import channel_mean, normalize
from . import common
from .normalmap import eval_pdf_in_frame, sample_in_frame

IS_WRAPPER = True
FLAGS = common.All | common.FrontSide | common.BackSide

_EPS = 1e-3  # the uv step of the finite differences


def build(props, builder):
    from ..scene.build_emitters import _build_bsdf

    child = [v for k, v in props.items()
             if isinstance(v, dict) and "type" in v and k != "bumpmap"]
    if len(child) != 1:
        raise ValueError("bumpmap needs exactly one nested bsdf")
    return {
        "bumpmap": builder.texture(props.get("bumpmap", 0.0)),
        "scale": np.float32(props.get("scale", 1.0)),
        "nested": _build_bsdf(builder, child[0]),
        "twosided": builder.twosided_flag(props),
    }


def _frame(scene, params, slot, si):
    from ..render.texture import texture_eval

    index = params["bumpmap"][slot]
    scale = params["scale"][slot]

    def height(uv):  # no prim_index: the reference reads none here
        return channel_mean(texture_eval(scene, index, uv,
                                         wavelengths=si.wavelengths))

    h0 = height(si.uv)
    step = lambda i: torch.tensor([_EPS, 0.0] if i == 0 else [0.0, _EPS],
                                  device=si.uv.device)
    du = (height(si.uv + step(0)) - h0) / _EPS * scale
    dv = (height(si.uv + step(1)) - h0) / _EPS * scale
    return Frame.from_normal(normalize(torch.stack(
        [-du, -dv, torch.ones_like(du)], dim=-1)))


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    return sample_in_frame(scene, params["nested"][slot],
                           _frame(scene, params, slot, si), si, s1, s2,
                           active, mode)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    return eval_pdf_in_frame(scene, params["nested"][slot],
                             _frame(scene, params, slot, si), si, wo, active,
                             mode)
