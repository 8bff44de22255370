"""Opacity mask (bsdfs/mask.py counterpart; mask.cpp): with probability
``opacity`` the nested BSDF scatters, else the ray passes through
unscattered (a null lobe). Row: opacity (texture index), nested (global
BSDF index)."""

from __future__ import annotations

import torch

from ..core.math import channel_mean

from . import common

IS_WRAPPER = True
FLAGS = common.All | common.Null | common.FrontSide | common.BackSide
PASS = common.Null | common.FrontSide | common.BackSide


def build(props, builder):
    from ..scene.build_emitters import _build_bsdf

    child = [v for k, v in props.items()
             if isinstance(v, dict) and "type" in v and k != "opacity"]
    if len(child) != 1:
        raise ValueError("mask needs exactly one nested bsdf")
    nested = _build_bsdf(builder, child[0])
    return {
        "opacity": builder.texture(props.get("opacity", 0.5)),
        "nested": nested,
        "twosided": builder.twosided_flag(props),
    }


def _opacity(scene, params, slot, si):
    op = common.tex(scene, params["opacity"][slot], si)
    return torch.clamp(channel_mean(op), 0.0, 1.0)


def sample(scene, params, slot, si, s1, s2, active, mode=common.RADIANCE):
    from . import dispatch_sample_nested

    op = _opacity(scene, params, slot, si)
    sel = s1 < op
    # the lobe-selection sample renormalised for the nested BSDF
    s1n = torch.where(sel, s1 / torch.clamp(op, min=1e-12),
                      (s1 - op) / torch.clamp(1.0 - op, min=1e-12))
    bs_n, w_n = dispatch_sample_nested(scene, params["nested"][slot], si,
                                       s1n, s2, active & sel, mode)
    bs = common.BSDFSample(
        wo=torch.where(sel[..., None], bs_n.wo, -si.wi),
        pdf=torch.where(sel, bs_n.pdf * op, 1.0 - op),
        eta=torch.where(sel, bs_n.eta, 1.0),
        sampled_type=torch.where(sel, bs_n.sampled_type, PASS).to(
            torch.int32))
    weight = torch.where(sel[..., None], w_n, 1.0)
    return bs, torch.where(active[..., None], weight, 0.0)


def eval_pdf(scene, params, slot, si, wo, active, mode=common.RADIANCE):
    from . import dispatch_eval_pdf_nested

    op = _opacity(scene, params, slot, si)
    v, p = dispatch_eval_pdf_nested(scene, params["nested"][slot], si, wo,
                                    active, mode)
    return v * op[..., None], p * op


def eval_null_transmission(scene, params, slot, si, active):
    op = _opacity(scene, params, slot, si)
    return torch.where(active[..., None], (1.0 - op)[..., None].expand(
        -1, scene.config.variant.channels(si.wavelengths)), 0.0)
