"""Shape construction (scene/build_shapes.py counterpart): triangle meshes
given as vertex/face arrays, and rectangles."""

from __future__ import annotations

import numpy as np

from ..core.transform import as_transform
from .build_emitters import _build_bsdf

_SHAPE_TYPES = ("mesh", "rectangle")


def _build_shape(builder, d):
    t = d["type"]
    for key in ("emitter", "interior", "exterior", "attributes"):
        if key in d:
            raise NotImplementedError(
                f"shape {key!r}: area emitters, media and mesh attributes "
                "come with later slices of the port")
    tw = as_transform(d.get("to_world"))
    if t == "rectangle":
        idx = builder.add_rectangle(tw)
    elif t == "mesh":
        verts = np.asarray(d["vertices"], np.float32)
        normals = d.get("normals")
        if "to_world" in d:
            m = np.asarray(tw.m)
            verts = verts @ m[:3, :3].T + m[:3, 3]
            if normals is not None:
                inv_t = np.linalg.inv(m[:3, :3]).T
                normals = np.asarray(normals, np.float32) @ inv_t.T
        idx = builder.add_mesh(verts, d["faces"], normals, d.get("uvs"))
    else:
        raise NotImplementedError(
            f"shape {t!r}: this slice of the port carries {_SHAPE_TYPES}")
    builder.shape_rows[idx]["bsdf"] = _build_bsdf(
        builder, d.get("bsdf", {"type": "diffuse"}))
    return idx
