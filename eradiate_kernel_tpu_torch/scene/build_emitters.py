"""BSDF and emitter construction (scene/build_emitters.py counterpart)."""

from __future__ import annotations

import numpy as np

from ..core.hierarchical2d import build_hierarchical2d
from ..core.transform import as_transform
from ..utils.rgb2spec import fit_srgb_coeff_batch
from .build_spectra import _image_data

_EMITTER_SCENE_TYPES = ("constant", "point", "directional", "spot",
                        "projector", "envmap")


def _build_bsdf(builder, d, twosided=False):
    from .. import bsdfs as bsdf_pkg

    t = d["type"]
    if t == "ref":
        kind, idx = builder.named[d["id"]]
        if kind != "bsdf":
            raise ValueError(f"ref {d['id']!r} names a {kind}, not a bsdf")
        return idx
    if t == "twosided":
        child = [v for v in d.values() if isinstance(v, dict) and "type" in v]
        if len(child) != 1:
            raise ValueError("twosided needs exactly one nested bsdf")
        return _build_bsdf(builder, child[0], twosided=True)
    if t not in bsdf_pkg.REGISTRY:
        raise ValueError(f"unknown bsdf type {t!r}: register it with "
                         "bsdfs.register_bsdf")
    mod = bsdf_pkg.REGISTRY[t]
    props = dict(d)
    props["_twosided"] = twosided
    return builder.add_bsdf_row(t, mod.build(props, builder), mod.FLAGS)


def _build_emitter_for_shape(builder, d, shape_idx):
    """The area emitter of shape ``shape_idx``."""
    if d["type"] != "area":
        raise ValueError(f"a shape's emitter must be 'area', got {d['type']!r}")
    return builder.add_emitter_row("area", {
        "radiance": np.int32(builder.texture(d.get("radiance", 1.0),
                                             emitter=True)),
        "shape": np.int32(shape_idx)})


def _build_scene_emitter(builder, d):
    t = d["type"]
    if t == "constant":
        idx = builder.add_emitter_row("constant", {
            "radiance": np.int32(builder.texture(d.get("radiance", 1.0),
                                                 emitter=True))})
        builder.env_emitter = idx
        return idx
    if t == "point":
        return builder.add_emitter_row("point", {
            "position": np.asarray(d.get("position", [0, 0, 0]), np.float32),
            "intensity": np.int32(builder.texture(d.get("intensity", 1.0),
                                                  emitter=True))})
    if t == "directional":
        return builder.add_emitter_row("directional", {
            "direction": np.asarray(d.get("direction", [0, 0, -1]),
                                    np.float32),
            "irradiance": np.int32(builder.texture(d.get("irradiance", 1.0),
                                                   emitter=True))})
    if t == "spot":
        m = np.asarray(as_transform(d.get("to_world")).m)
        cutoff = float(d.get("cutoff_angle", 20.0))
        beam = float(d.get("beam_width", cutoff * 0.75))
        return builder.add_emitter_row("spot", {
            "position": np.asarray(d.get("position", m[:3, 3]), np.float32),
            "direction": np.asarray(d.get("direction", m[:3, 2]),
                                    np.float32),
            "cos_cutoff": np.float32(np.cos(np.deg2rad(cutoff))),
            "cos_beam": np.float32(np.cos(np.deg2rad(beam))),
            "intensity": np.int32(builder.texture(d.get("intensity", 1.0),
                                                  emitter=True))})
    if t == "projector":
        tw = as_transform(d.get("to_world"))
        w2l = tw.inverse()
        fov = float(d.get("fov", 45.0))
        irr = d.get("irradiance", 1.0)
        data = None
        if isinstance(irr, dict) and irr.get("type") == "bitmap":
            if "data" not in irr:  # the reference reads only inline data
                raise ValueError("projector: an irradiance bitmap takes "
                                 "inline 'data', not a 'filename'")
            data = np.asarray(irr["data"], np.float32)
        aspect = (data.shape[1] / data.shape[0]) if data is not None else 1.0
        return builder.add_emitter_row("projector", {
            "position": np.asarray(np.asarray(tw.m)[:3, 3], np.float32),
            "w2l_m": np.asarray(w2l.m, np.float32),
            "w2l_it": np.asarray(w2l.inv_t, np.float32),
            "tan_half_fov": np.float32(np.tan(np.deg2rad(fov) / 2)),
            "aspect": np.float32(aspect),
            "irradiance": np.int32(builder.texture(irr, emitter=True))})
    if t == "envmap":
        return _build_envmap(builder, d)
    from ..emitters import CUSTOM
    if t in CUSTOM:
        return builder.add_emitter_row(t, CUSTOM[t].build(d, builder))
    raise ValueError(f"unknown emitter type {t!r}: register it with "
                     "emitters.register_emitter")


def _build_envmap(builder, d):
    """A lat-long image with its Hierarchical2D sampling tables. Texels are
    bilinear vertex samples (rows 0 and H-1 the poles) and the stored image
    repeats its first column after the last to close the azimuth seam. In
    spectral the texels' rgb2spec coefficients and scales come too."""
    data = _image_data(d)
    if data.ndim == 2:
        data = data[..., None].repeat(3, -1)
    w2l = as_transform(d.get("to_world")).inverse()
    H = data.shape[0]
    img_p = np.concatenate([data, data[:, :1]], axis=1)  # (H, W+1, 3)
    lum = (0.212671 * img_p[..., 0] + 0.715160 * img_p[..., 1]
           + 0.072169 * img_p[..., 2]).astype(np.float64)
    theta_v = np.arange(H) / max(H - 1, 1) * np.pi
    h2d = build_hierarchical2d(lum * np.sin(theta_v)[:, None])
    row = {"image": img_p, "scale": np.float32(float(d.get("scale", 1.0))),
           "w2l_m": np.asarray(w2l.m, np.float32),
           "w2l_it": np.asarray(w2l.inv_t, np.float32)}
    row.update({f"h2d_{k}": v[0] for k, v in h2d.items()})
    if builder.variant.is_spectral:
        # every texel's rgb2spec fit (envmap.cpp:69-89): the fit reproduces
        # rgb / spec_scale, and eval multiplies the scale back
        sscale = np.maximum(2.0 * img_p.max(-1), 1e-8)
        row["spec_coeff"] = fit_srgb_coeff_batch(
            (img_p / sscale[..., None]).reshape(-1, 3)).reshape(img_p.shape)
        row["spec_scale"] = sscale.astype(np.float32)
    idx = builder.add_emitter_row("envmap", row)
    builder.env_emitter = idx
    return idx
