"""Shape surface sampling in area measure (render/shape_sampling.py
counterpart; Shape::sample_position / pdf_position, shape.h:52-109), for
area emitters. Dispatches over the mesh, sphere, rectangle and disk
families. A mesh picks its face with one searchsorted over the scene's
global face-area cumsum (strictly increasing, so one search serves every
mesh and the same sample picks the same face as in the reference)."""

from __future__ import annotations

import torch

from ..core import warp
from ..core.math import cross, normalize
from ..core.transform import Transform
from .geometry import FAMILY_DISK, FAMILY_MESH, FAMILY_RECT, FAMILY_SPHERE
from .records import PositionSample


def _unit_z(x):
    z = torch.zeros_like(x)
    z[..., 2] = 1.0
    return z


def sample_position(scene, shape_idx, s1, s2, active=True):
    """A point on shape ``shape_idx`` (N,) i32: ``s1`` (N,) picks a mesh's
    face, ``s2`` (N, 2) the point. pdf = 1 / the shape's area. Cylinders
    and cones have no branch, as in the reference: their lanes keep the
    origin, normal +z and uv 0. Every lane is sampled, ``active`` or not,
    as in the reference."""
    geo = scene.geo
    family = geo.shape_family[shape_idx]
    n_lanes = shape_idx.shape[0]
    dev = s2.device
    p = torch.zeros(n_lanes, 3, device=dev)
    n = _unit_z(p)
    uv = torch.zeros(n_lanes, 2, device=dev)

    # each family reads its pool at slot 0 on other families' lanes (the
    # reference's gathers clamp)
    def sel(mask, new, old):
        return torch.where(mask[:, None] if new.ndim > 1 else mask, new, old)

    if geo.faces.shape[0] > 0:
        m = family == FAMILY_MESH
        off = scene.shape_face_offset[shape_idx].long()
        cnt = torch.clamp(scene.shape_face_count[shape_idx], min=1).long()
        C = scene.face_area_cumsum
        lo = torch.where(off > 0, C[torch.clamp(off - 1, min=0)], 0.0)
        hi = C[off + cnt - 1]
        target = lo + s1 * (hi - lo)
        face = torch.clamp(torch.searchsorted(C, target, right=True), 0,
                           C.shape[0] - 1)
        face = torch.minimum(torch.maximum(face, off), off + cnt - 1)
        f = geo.faces[face].long()
        v0, v1, v2 = (geo.vertices[f[:, i]] for i in range(3))
        b = warp.square_to_uniform_triangle(s2)
        w = 1.0 - b[:, 0] - b[:, 1]
        pm = v0 * w[:, None] + v1 * b[:, 0:1] + v2 * b[:, 1:2]
        nm = normalize(cross(v1 - v0, v2 - v0))
        uv0, uv1, uv2 = (geo.uvs[f[:, i]] for i in range(3))
        uvm = uv0 * w[:, None] + uv1 * b[:, 0:1] + uv2 * b[:, 1:2]
        p, n, uv = sel(m, pm, p), sel(m, nm, n), sel(m, uvm, uv)

    if geo.sph_shape.shape[0] > 0:
        m = family == FAMILY_SPHERE
        slot = torch.where(m, scene.shape_prim_slot[shape_idx], 0).long()
        d = warp.square_to_uniform_sphere(s2)
        ps = geo.sph_center[slot] + d * geo.sph_radius[slot][:, None]
        p, n, uv = sel(m, ps, p), sel(m, d, n), sel(m, s2, uv)

    for fam, tws, planar in (
            (FAMILY_RECT, geo.rect_to_world,
             lambda s: torch.stack([2 * s[:, 0] - 1, 2 * s[:, 1] - 1],
                                   dim=-1)),
            (FAMILY_DISK, geo.disk_to_world,
             warp.square_to_uniform_disk_concentric)):
        if tws.m.shape[0] == 0:
            continue
        m = family == fam
        slot = torch.where(m, scene.shape_prim_slot[shape_idx], 0).long()
        tw = Transform(m=tws.m[slot], inv_t=tws.inv_t[slot])
        pl = torch.cat([planar(s2), torch.zeros_like(s2[:, :1])], dim=-1)
        pr = tw.transform_affine_point(pl)
        nr = normalize(tw.transform_normal(_unit_z(pl)))
        p, n, uv = sel(m, pr, p), sel(m, nr, n), sel(m, s2, uv)

    return PositionSample(p=p, n=n, uv=uv,
                          pdf=pdf_position(scene, shape_idx),
                          delta=torch.zeros(n_lanes, dtype=torch.bool,
                                            device=dev))


def pdf_position(scene, shape_idx):
    """Area-measure density of sample_position on shape ``shape_idx``."""
    return 1.0 / torch.clamp(scene.shape_area[shape_idx], min=1e-20)
