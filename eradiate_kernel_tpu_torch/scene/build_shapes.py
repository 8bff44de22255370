"""Shape construction (scene/build_shapes.py counterpart): triangle meshes
given as vertex/face arrays or read from OBJ, PLY and Mitsuba serialized
files, cubes, spheres, rectangles, disks, cylinders, cones, two-level
instancing (shapegroups of meshes under instance transforms), the area
emitter a shape carries and the media a shape bounds
(interior/exterior)."""

from __future__ import annotations

import numpy as np

from ..core.transform import as_transform
from ..render.geometry import FAMILY_IMESH
from ..utils.meshio import load_obj, load_ply, load_serialized
from .build_emitters import _build_bsdf, _build_emitter_for_shape

_SHAPE_TYPES = ("rectangle", "disk", "sphere", "cylinder", "cone", "cube",
                "mesh", "obj", "ply", "serialized", "instance")

_CUBE_V = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
_CUBE_F = np.array(
    [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],   # -z, +z
     [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],   # -y, +y
     [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int32)  # +x, -x

# shapegroup children stored once in group-local pools
_GROUP_MESH_TYPES = ("mesh", "cube", "obj", "ply", "serialized")


def triangle_areas(verts, faces):
    """(F,) areas of the triangles ``faces`` of ``verts``."""
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)


def _read_mesh_file(d):
    """(verts, faces, normals or None, uvs or None) of an obj, ply or
    serialized dict's file, untransformed."""
    t = d["type"]
    if t == "obj":
        return load_obj(d["filename"])
    if t == "ply":
        return (*load_ply(d["filename"]), None, None)
    return load_serialized(d["filename"], int(d.get("shape_index", 0)))


def _load_mesh_arrays(d):
    """(verts, faces, normals, uvs) of a mesh-typed dict with its own
    to_world applied to the vertices."""
    m = np.asarray(as_transform(d.get("to_world")).m)

    def xf(verts, normals=None):
        verts = np.asarray(verts, np.float32) @ m[:3, :3].T + m[:3, 3]
        if normals is not None:
            inv_t = np.linalg.inv(m[:3, :3]).T
            normals = np.asarray(normals, np.float32) @ inv_t.T
        return verts.astype(np.float32), normals

    if d["type"] == "cube":
        v, _ = xf(_CUBE_V)
        return v, _CUBE_F.copy(), None, None
    if d["type"] == "mesh":
        v, n = xf(d["vertices"], d.get("normals"))
        return v, np.asarray(d["faces"], np.int32), n, d.get("uvs")
    verts, faces, normals, uvs = _read_mesh_file(d)
    v, n = xf(verts, normals)
    return v, faces, n, uvs


def shape_children(d, exclude=()):
    """The shape-typed dict entries of d (a shapegroup or an instance)."""
    return [v for v in d.values()
            if isinstance(v, dict) and v.get("type") in _SHAPE_TYPES
            and v["type"] not in exclude]


def _build_group_geom(builder, key, children):
    """Load a shapegroup's mesh children once into the shared group-local
    pools; other children are returned for flattening per instance."""
    if key in builder.group_records:
        return builder.group_records[key]
    mesh_children = [c for c in children if c["type"] in _GROUP_MESH_TYPES]
    other = [c for c in children if c["type"] not in _GROUP_MESH_TYPES]
    f_off = sum(len(f) for f in builder.ig_faces)
    subs = []
    lo = np.full(3, np.inf, np.float32)
    hi = np.full(3, -np.inf, np.float32)
    for sub_ord, c in enumerate(mesh_children):
        for bad in ("emitter", "interior", "exterior", "attributes"):
            if bad in c:
                raise ValueError(
                    f"shapegroup children cannot carry {bad!r}")
        verts, faces, normals, uvs = _load_mesh_arrays(c)
        v_off = sum(len(v) for v in builder.ig_vertices)
        builder.ig_vertices.append(verts)
        builder.ig_normals.append(
            np.zeros_like(verts) if normals is None
            else np.asarray(normals, np.float32))
        builder.ig_uvs.append(
            np.zeros((len(verts), 2), np.float32) if uvs is None
            else np.asarray(uvs, np.float32))
        builder.ig_faces.append(np.asarray(faces, np.int32) + v_off)
        builder.ig_face_sub.append(np.full(len(faces), sub_ord, np.int32))
        subs.append({"bsdf": c.get("bsdf"), "area": float(
            triangle_areas(verts, np.asarray(faces, np.int32)).sum())})
        lo = np.minimum(lo, verts.min(0))
        hi = np.maximum(hi, verts.max(0))
    rec = dict(f_off=f_off,
               f_count=sum(len(f) for f in builder.ig_faces) - f_off,
               subs=subs, lo=lo, hi=hi, flatten=other)
    builder.group_records[key] = rec
    return rec


def _build_instance(builder, d, tw):
    """An instance: its group's mesh children live once in the group-local
    pools and the instance is a (transform, face range, shape base) record;
    the group's other children are flattened under the instance transform.
    Returns the index of its first shape."""
    ref = d.get("shapegroup")
    if isinstance(ref, dict) and ref.get("type") == "ref":
        kind, children = builder.named[ref["id"]]
        if kind != "shapegroup":
            raise ValueError(f"instance of {ref['id']!r}, a {kind}")
        group_key = ref["id"]
    else:
        children = shape_children(d, exclude=("instance",))
        group_key = ("anon", id(d.get("shapegroup")) if ref else
                     tuple(sorted(str(c) for c in children)))
    rec = _build_group_geom(builder, group_key, children)

    idx = -1
    for child in rec["flatten"]:
        child = dict(child)
        child["to_world"] = tw @ as_transform(child.get("to_world"))
        idx = _build_shape(builder, child)
    if rec["f_count"] == 0:
        return idx

    inst_id = len(builder.instances)
    m = np.asarray(tw.m)
    # surface-area scale of the linear map (exact for a uniform scale)
    ascale = abs(np.linalg.det(m[:3, :3])) ** (2.0 / 3.0)
    shape_base = None
    for sub in rec["subs"]:
        sidx = builder._new_shape(FAMILY_IMESH, inst_id,
                                  sub["area"] * ascale)
        builder.shape_rows[sidx]["bsdf"] = _build_bsdf(
            builder, sub["bsdf"] or {"type": "diffuse"})
        if shape_base is None:
            shape_base = sidx
    # world AABB: the 8 local corners transformed
    corners = np.stack(np.meshgrid(*zip(rec["lo"], rec["hi"]),
                                   indexing="ij"), -1).reshape(-1, 3)
    wc = corners @ m[:3, :3].T + m[:3, 3]
    builder.instances.append(dict(
        l2w=tw, w2l=tw.inverse(), f_off=rec["f_off"],
        f_count=rec["f_count"], shape_base=shape_base,
        lo=wc.min(0).astype(np.float32), hi=wc.max(0).astype(np.float32)))
    return shape_base


def _build_shape(builder, d):
    t = d["type"]
    tw = as_transform(d.get("to_world"))
    if t == "instance":
        return _build_instance(builder, d, tw)
    if t == "rectangle":
        idx = builder.add_rectangle(tw)
    elif t == "disk":
        idx = builder.add_disk(tw)
    elif t == "sphere":
        # to_world applied to the analytic parameterization, its uniform
        # scale taken from the determinant (sphere.cpp:88-99)
        m = np.asarray(tw.m)
        center = m[:3, :3] @ np.asarray(d.get("center", [0, 0, 0]),
                                        np.float32) + m[:3, 3]
        scale = float(np.cbrt(abs(np.linalg.det(m[:3, :3]))))
        idx = builder.add_sphere(center, float(d.get("radius", 1.0)) * scale,
                                 d.get("flip_normals", False))
    elif t == "cube":
        m = np.asarray(tw.m)
        idx = builder.add_mesh(_CUBE_V @ m[:3, :3].T + m[:3, 3], _CUBE_F)
    elif t == "mesh":
        verts = np.asarray(d["vertices"], np.float32)
        normals = d.get("normals")
        if "to_world" in d:
            m = np.asarray(tw.m)
            verts = verts @ m[:3, :3].T + m[:3, 3]
            if normals is not None:
                inv_t = np.linalg.inv(m[:3, :3]).T
                normals = np.asarray(normals, np.float32) @ inv_t.T
        idx = builder.add_mesh(verts, d["faces"], normals, d.get("uvs"),
                               d.get("attributes"))
    elif t in ("obj", "ply", "serialized"):
        # the file's vertices under to_world (identity if absent)
        verts, faces, normals, uvs = _read_mesh_file(d)
        m = np.asarray(tw.m)
        verts = verts @ m[:3, :3].T + m[:3, 3]
        if normals is not None:
            inv_t = np.linalg.inv(m[:3, :3]).T
            normals = normals @ inv_t.T
        idx = builder.add_mesh(verts, faces, normals, uvs)
    elif t == "cylinder":
        idx = builder.add_cylinder(tw, d.get("length", 1.0),
                                   d.get("radius", 1.0))
    elif t == "cone":
        idx = builder.add_cone(tw, d.get("length", 1.0), d.get("radius", 1.0))
    else:
        raise ValueError(f"unknown shape type {t!r}")
    row = builder.shape_rows[idx]
    bsdf_d = d.get("bsdf")
    if bsdf_d is None:
        # shapes bounding a medium default to a null (passthrough) BSDF
        bsdf_d = {"type": "null"} if ("interior" in d or "exterior" in d) \
            else {"type": "diffuse"}
    row["bsdf"] = _build_bsdf(builder, bsdf_d)
    if "emitter" in d:
        row["emitter"] = _build_emitter_for_shape(builder, d["emitter"], idx)
    if "interior" in d:
        row["interior"] = builder.medium(d["interior"])
    if "exterior" in d:
        row["exterior"] = builder.medium(d["exterior"])
    return idx
