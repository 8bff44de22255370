"""Texture-weighted blend of two nested BSDFs (bsdfs/blendbsdf.py
counterpart; blendbsdf.cpp): weight 0 is the first, 1 the second. Row:
weight (texture index), nested0 and nested1 (global BSDF indices)."""

from __future__ import annotations

import torch

from ..core.math import channel_mean

from . import common

IS_WRAPPER = True
FLAGS = common.All | common.FrontSide | common.BackSide


def build(props, builder):
    from ..scene.build_emitters import _build_bsdf

    children = [v for k, v in props.items()
                if isinstance(v, dict) and "type" in v and k != "weight"]
    if len(children) != 2:
        raise ValueError("blendbsdf needs exactly two nested bsdfs")
    return {
        "weight": builder.texture(props.get("weight", 0.5)),
        "nested0": _build_bsdf(builder, children[0]),
        "nested1": _build_bsdf(builder, children[1]),
        "twosided": builder.twosided_flag(props),
    }


def _weight(scene, params, slot, si):
    w = common.tex(scene, params["weight"][slot], si)
    return torch.clamp(channel_mean(w), 0.0, 1.0)


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    from . import dispatch_sample_nested

    w = _weight(scene, params, slot, si)
    sel1 = s1 < w  # the second BSDF with probability w
    s1n = torch.where(sel1, s1 / torch.clamp(w, min=1e-12),
                      (s1 - w) / torch.clamp(1.0 - w, min=1e-12))
    bs0, w0 = dispatch_sample_nested(scene, params["nested0"][slot], si, s1n,
                                     s2, active & ~sel1, mode)
    bs1, w1 = dispatch_sample_nested(scene, params["nested1"][slot], si, s1n,
                                     s2, active & sel1, mode)
    bs = common.BSDFSample(
        wo=torch.where(sel1[..., None], bs1.wo, bs0.wo),
        pdf=torch.where(sel1, bs1.pdf * w, bs0.pdf * (1.0 - w)),
        eta=torch.where(sel1, bs1.eta, bs0.eta),
        sampled_type=torch.where(sel1, bs1.sampled_type, bs0.sampled_type))
    weight = torch.where(sel1[..., None], w1, w0)
    return bs, torch.where(active[..., None], weight, 0.0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    from . import dispatch_eval_pdf_nested

    w = _weight(scene, params, slot, si)
    v0, p0 = dispatch_eval_pdf_nested(scene, params["nested0"][slot], si, wo,
                                      active, mode)
    v1, p1 = dispatch_eval_pdf_nested(scene, params["nested1"][slot], si, wo,
                                      active, mode)
    return (v0 * (1.0 - w)[..., None] + v1 * w[..., None],
            p0 * (1.0 - w) + p1 * w)
