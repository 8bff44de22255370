"""BSDF and emitter construction (scene/build_emitters.py counterpart)."""

from __future__ import annotations

import numpy as np

# the scene-level emitter types of the port (spot, projector and envmap
# come with slice 5c-2)
_EMITTER_SCENE_TYPES = ("constant", "point", "directional")
# the reference's BSDFs that read core/mueller.py
_POLARIZED_BSDFS = ("pplastic", "polarizer", "retarder", "circular",
                    "measured_polarized")


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
        later = ("slice 6 (the polarized variant)" if t in _POLARIZED_BSDFS
                 else "slice 5c-2 (measured)")
        raise NotImplementedError(
            f"bsdf {t!r}: the port carries {sorted(bsdf_pkg.REGISTRY)}; "
            f"{t!r} comes with {later}")
    mod = bsdf_pkg.REGISTRY[t]
    props = dict(d)
    props["_twosided"] = twosided
    return builder.add_bsdf_row(t, mod.build(props, builder), mod.FLAGS)


def _build_emitter_for_shape(builder, d, shape_idx):
    """The area emitter of shape ``shape_idx``."""
    if d["type"] != "area":
        raise ValueError(f"a shape's emitter must be 'area', got {d['type']!r}")
    return builder.add_emitter_row("area", {
        "radiance": np.int32(builder.texture(d.get("radiance", 1.0))),
        "shape": np.int32(shape_idx)})


def _build_scene_emitter(builder, d):
    t = d["type"]
    if t == "constant":
        idx = builder.add_emitter_row("constant", {
            "radiance": np.int32(builder.texture(d.get("radiance", 1.0)))})
        builder.env_emitter = idx
        return idx
    if t == "point":
        return builder.add_emitter_row("point", {
            "position": np.asarray(d.get("position", [0, 0, 0]), np.float32),
            "intensity": np.int32(builder.texture(d.get("intensity", 1.0)))})
    return builder.add_emitter_row("directional", {
        "direction": np.asarray(d.get("direction", [0, 0, -1]), np.float32),
        "irradiance": np.int32(builder.texture(d.get("irradiance", 1.0)))})
