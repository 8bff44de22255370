"""Normal map (bsdfs/normalmap.py counterpart; normalmap.cpp): a
tangent-space normal texture (rgb in [0, 1], +z up) tilts the shading
frame, and the nested BSDF runs in the tilted frame. Row: normalmap
(texture index, raw rgb), nested (global BSDF index)."""

from __future__ import annotations

import dataclasses

import torch

from ..core.frame import Frame
from ..core.math import normalize
from . import common

IS_WRAPPER = True
FLAGS = common.All | common.FrontSide | common.BackSide


def build(props, builder):
    from ..scene.build_emitters import _build_bsdf

    child = [v for v in props.values()
             if isinstance(v, dict) and "type" in v
             and v["type"] != "bitmap"]
    if len(child) != 1:
        raise ValueError("normalmap needs exactly one nested bsdf")
    return {
        "normalmap": builder.texture(props.get("normalmap",
                                               [0.5, 0.5, 1.0])),
        "nested": _build_bsdf(builder, child[0]),
        "twosided": builder.twosided_flag(props),
    }


def _frame(scene, params, slot, si):
    rgb = common.tex(scene, params["normalmap"][slot], si)
    if rgb.shape[-1] < 3:  # mono: the one channel as x, flat y and z
        rgb = torch.cat([rgb[..., :1], rgb[..., :1] * 0 + 0.5,
                         rgb[..., :1] * 0 + 1.0], dim=-1)
    return Frame.from_normal(normalize(2.0 * rgb[..., :3] - 1.0))


def sample_in_frame(scene, nested, frame, si, s1, s2, active,
                    mode=common.RADIANCE):
    """The nested BSDF sampled in ``frame`` (local to the shading frame);
    a sample leaking through the true surface gets pdf and weight 0."""
    from . import dispatch_sample_nested

    si_p = dataclasses.replace(si, wi=frame.to_local(si.wi))
    bs, weight = dispatch_sample_nested(scene, nested, si_p, s1, s2, active,
                                        mode)
    wo = frame.to_world(bs.wo)
    ok = (wo[..., 2] * bs.wo[..., 2]) > 0.0
    bs = dataclasses.replace(bs, wo=wo, pdf=torch.where(ok, bs.pdf, 0.0))
    return bs, torch.where((active & ok)[..., None], weight, 0.0)


def eval_pdf_in_frame(scene, nested, frame, si, wo, active,
                      mode=common.RADIANCE):
    from . import dispatch_eval_pdf_nested

    si_p = dataclasses.replace(si, wi=frame.to_local(si.wi))
    wo_p = frame.to_local(wo)
    ok = active & ((wo[..., 2] * wo_p[..., 2]) > 0.0)
    v, p = dispatch_eval_pdf_nested(scene, nested, si_p, wo_p, ok, mode)
    return torch.where(ok[..., None], v, 0.0), torch.where(ok, p, 0.0)


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    return sample_in_frame(scene, params["nested"][slot],
                           _frame(scene, params, slot, si), si, s1, s2,
                           active, mode)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    return eval_pdf_in_frame(scene, params["nested"][slot],
                             _frame(scene, params, slot, si), si, wo, active,
                             mode)
