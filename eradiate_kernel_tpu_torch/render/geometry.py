"""Scene geometry and ray intersection (render/geometry.py counterpart).

Two phases as in the reference: ``ray_intersect_preliminary`` finds the
closest hit (triangle meshes and instances through a tile kernel of
ops/intersect.py; spheres, rectangles, disks, cylinders and cones by a
brute-force test) and
``compute_surface_interaction`` recomputes the hit from primitive data.

Accel policy of the port (``_accel_mode``): the reference's policy on its
TPU, on every device, since the port has no brute-force mesh path. A
non-instanced mesh of at most MAX_SWEEP_TILES tiles takes the flat tile
sweep; instanced scenes and larger meshes take the binary tile BVH, or the
8-wide one under ERT_BVH_WIDE=1. ERT_ACCEL=tiles|bvh|bvh8 overrides.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from ..core.frame import Frame
from ..core.math import INVALID_T, cross, dot, normalize, safe_sqrt, sqr
from ..core.ray import Ray
from ..core.transform import Transform
from ..core.types import resolve_device
from ..ops.intersect import (intersect_bvh, intersect_bvh8, intersect_tiles,
                             root_box, row_views, tile_rows)
from ..utils.runtime import scoped_phase
from .records import PreliminaryIntersection, SurfaceInteraction

FAMILY_MESH = 0
FAMILY_SPHERE = 1
FAMILY_RECT = 2
FAMILY_DISK = 3
FAMILY_CYLINDER = 4
FAMILY_CONE = 5
FAMILY_IMESH = 6  # instanced mesh (two-level: shared group geometry)

# above this tile count the policy switches from the sweep to the BVH (the
# reference's crossover, measured on its TPU)
MAX_SWEEP_TILES = 2048

_QUERIES = {"tiles": intersect_tiles, "bvh": intersect_bvh,
            "bvh8": intersect_bvh8}
# the pack_tiles fields that are views of Geometry.tiles_rows
_TILE_FIELDS = ("tiles_v0", "tiles_e1", "tiles_e2", "tiles_prim",
                "tiles_shape")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Mesh, sphere, rectangle, disk, cylinder, cone and instancing pools
    plus the triangle-tile accelerators."""

    vertices: torch.Tensor      # (V, 3)
    normals: torch.Tensor       # (V, 3) zero rows -> face normal
    uvs: torch.Tensor           # (V, 2)
    faces: torch.Tensor         # (F, 3) i32
    face_shape: torch.Tensor    # (F,) i32 global shape index
    sph_center: torch.Tensor    # (S, 3)
    sph_radius: torch.Tensor    # (S,)
    sph_shape: torch.Tensor     # (S,) i32
    sph_flip: torch.Tensor      # (S,) bool: normals point inward
    rect_to_world: Transform    # (R, 4, 4) canonical [-1,1]^2 in z=0
    rect_shape: torch.Tensor    # (R,) i32
    disk_to_world: Transform    # (D, 4, 4) canonical unit disk in z=0
    disk_shape: torch.Tensor    # (D,) i32
    # cylinders: along +z, z in [0, length], in the local frame
    cyl_to_world: Transform     # (C, 4, 4)
    cyl_length: torch.Tensor    # (C,)
    cyl_radius: torch.Tensor    # (C,)
    cyl_shape: torch.Tensor     # (C,) i32
    # cones: base radius at z=0, apex at z=length, in the local frame
    cone_to_world: Transform    # (K, 4, 4)
    cone_length: torch.Tensor   # (K,)
    cone_radius: torch.Tensor   # (K,)
    cone_shape: torch.Tensor    # (K,) i32
    shape_family: torch.Tensor  # (n_shapes,) i32
    tiles_v0: torch.Tensor      # (T, K, 3)
    tiles_e1: torch.Tensor      # (T, K, 3)
    tiles_e2: torch.Tensor      # (T, K, 3)
    tiles_prim: torch.Tensor    # (T, K) i32 face index (-1 padding)
    tiles_shape: torch.Tensor   # (T, K) i32
    tiles_lo: torch.Tensor      # (T, 3)
    tiles_hi: torch.Tensor      # (T, 3)
    bvh_box: torch.Tensor       # (2L-1, 1, 8) node AABBs (ops/bvh.py)
    bvh_meta: torch.Tensor      # (2L-1, 4) i32 [left, right, tile, inst]
    bvh8_box: torch.Tensor      # (N8, 8, 8) wide nodes (empty: none)
    bvh8_meta: torch.Tensor     # (N8, 8, 4) i32 [child, tile, inst, 0]
    tiles_xf: torch.Tensor      # (I+1, 12) w2l affine rows, row 0 identity
    tiles_sbase: torch.Tensor   # (I+1,) i32 shape bases, 0 in row 0
    # two-level instancing: group meshes stored once in local space;
    # instances are (transform, group face range, shape base) records
    ig_vertices: torch.Tensor   # (Vg, 3) group-local
    ig_normals: torch.Tensor    # (Vg, 3)
    ig_uvs: torch.Tensor        # (Vg, 2)
    ig_faces: torch.Tensor      # (Fg, 3) i32
    ig_face_sub: torch.Tensor   # (Fg,) i32 sub-shape ordinal in its group
    inst_l2w: Transform         # (I, 4, 4)
    inst_w2l: Transform         # (I, 4, 4)
    inst_f_off: torch.Tensor    # (I,) i32
    inst_f_count: torch.Tensor  # (I,) i32
    inst_shape_base: torch.Tensor  # (I,) i32
    inst_lo: torch.Tensor       # (I, 3) world AABB
    inst_hi: torch.Tensor       # (I, 3)
    shape_inst: torch.Tensor    # (n_shapes,) i32 instance of a shape, or -1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        # the tile kernels' per-scene tables, built once rather than per
        # query: the root box of all tiles (ops/intersect.py::sweep_tables)
        # and the packed triangle rows every tile kernel reads
        # (tiles_rows). The scene keeps one copy of its triangles: the
        # tiles_v0 .. tiles_shape fields become views of the rows
        # (intersect.row_views), which the plain versions read.
        root = rows = None
        if self.has_tiles:
            root = root_box(self.tiles_lo, self.tiles_hi)
            rows = tile_rows(self.tiles_v0, self.tiles_e1, self.tiles_e2,
                             self.tiles_prim, self.tiles_shape)
            for name, view in zip(_TILE_FIELDS, row_views(rows)):
                object.__setattr__(self, name, view)
        object.__setattr__(self, "tiles_root", root)
        object.__setattr__(self, "tiles_rows", rows)

    @property
    def n_shapes(self):
        return self.shape_family.shape[0]

    @property
    def has_tiles(self):
        return self.tiles_v0.shape[0] > 0

    @property
    def n_instances(self):
        return self.inst_f_off.shape[0]

    def tiles(self):
        """The tile kernels' arrays, the packed rows and root box included
        (the sweep and both BVH kernels read the rows)."""
        tiles = {"v0": self.tiles_v0, "e1": self.tiles_e1,
                 "e2": self.tiles_e2, "prim": self.tiles_prim,
                 "shape": self.tiles_shape, "lo": self.tiles_lo,
                 "hi": self.tiles_hi, "root": self.tiles_root,
                 "nbox": self.bvh_box, "nmeta": self.bvh_meta,
                 "cbox": self.bvh8_box, "cmeta": self.bvh8_meta,
                 "xf": self.tiles_xf, "sbase": self.tiles_sbase}
        if self.has_tiles:
            tiles["rows"] = self.tiles_rows
        return tiles


def empty_geometry(n_shapes=0, device=None, dtype=torch.float32):
    """A Geometry of ``n_shapes`` shapes and no primitives, on ``device``
    (CUDA unless named, as the entry points resolve it)."""
    device = resolve_device(device)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    none = lambda: Transform(m=z(0, 4, 4), inv_t=z(0, 4, 4))
    return Geometry(
        vertices=z(0, 3), normals=z(0, 3), uvs=z(0, 2), faces=zi(0, 3),
        face_shape=zi(0), sph_center=z(0, 3), sph_radius=z(0),
        sph_shape=zi(0), sph_flip=torch.zeros(0, dtype=torch.bool,
                                              device=device),
        rect_to_world=none(), rect_shape=zi(0), disk_to_world=none(),
        disk_shape=zi(0), cyl_to_world=none(), cyl_length=z(0),
        cyl_radius=z(0), cyl_shape=zi(0), cone_to_world=none(),
        cone_length=z(0), cone_radius=z(0), cone_shape=zi(0),
        shape_family=zi(n_shapes), tiles_v0=z(0, 128, 3),
        tiles_e1=z(0, 128, 3), tiles_e2=z(0, 128, 3),
        tiles_prim=zi(0, 128), tiles_shape=zi(0, 128), tiles_lo=z(0, 3),
        tiles_hi=z(0, 3), bvh_box=z(0, 1, 8), bvh_meta=zi(0, 4),
        bvh8_box=z(0, 8, 8), bvh8_meta=zi(0, 8, 4),
        tiles_xf=torch.tensor([[1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]],
                              dtype=dtype, device=device),
        tiles_sbase=zi(1), ig_vertices=z(0, 3), ig_normals=z(0, 3),
        ig_uvs=z(0, 2), ig_faces=zi(0, 3), ig_face_sub=zi(0),
        inst_l2w=none(), inst_w2l=none(), inst_f_off=zi(0),
        inst_f_count=zi(0), inst_shape_base=zi(0), inst_lo=z(0, 3),
        inst_hi=z(0, 3), shape_inst=zi(0))


def _accel_mode(geo: Geometry) -> str:
    """The tile kernel of a scene's mesh queries: 'tiles' | 'bvh' | 'bvh8'
    (render/geometry.py:465-510 of the reference, its TPU branch).

    ERT_ACCEL=tiles|bvh|bvh8 overrides, except that instanced leaves exist
    only in the BVHs ('tiles' with instances gives 'bvh') and 'bvh8'
    without BVH8 arrays gives 'bvh'."""
    mode = os.environ.get("ERT_ACCEL", "auto")
    if mode in _QUERIES:
        if geo.n_instances > 0 and mode == "tiles":
            return "bvh"
        if mode == "bvh8" and geo.bvh8_box.shape[0] == 0:
            return "bvh"
        return mode
    if mode != "auto":
        raise ValueError(
            f"ERT_ACCEL={mode!r}: the port has {sorted(_QUERIES)} (it has "
            "no brute-force mesh path)")
    if geo.n_instances == 0 and geo.tiles_v0.shape[0] <= MAX_SWEEP_TILES:
        return "tiles"
    if (geo.bvh8_box.shape[0] > 0
            and os.environ.get("ERT_BVH_WIDE", "0") == "1"):
        return "bvh8"
    return "bvh"


def moller_trumbore(o, d, v0, v1, v2):
    """Moller-Trumbore; returns (t, u, v, valid) without t bounds."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    tvec = o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    valid = (torch.abs(det) >= 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1.0)
    return t, u, v, valid


def _plane_hit_local(to_world: Transform, ray: Ray):
    """Rays in each rectangle's frame hitting z=0: (t, p_local, ok) of
    shapes (N, R), (N, R, 3), (N, R)."""
    inv = to_world.inverse()
    o = inv.transform_affine_point(ray.o[:, None, :])
    d = inv.transform_vector(ray.d[:, None, :])
    dz = torch.where(torch.abs(d[..., 2]) < 1e-12, 1e-12, d[..., 2])
    t = -o[..., 2] / dz
    p = o + d * t[..., None]
    return t, p, torch.abs(d[..., 2]) >= 1e-12


def _sphere_roots(center, radius, o, d):
    """(valid, near, far) of the stable quadratic (sphere.cpp:272-349)."""
    L = o - center
    a = dot(d, d)
    b = 2.0 * dot(d, L)
    c = dot(L, L) - sqr(radius)
    disc = sqr(b) - 4.0 * a * c
    sqrt_d = safe_sqrt(disc)
    q = -0.5 * (b + torch.where(b >= 0, sqrt_d, -sqrt_d))
    t0 = q / a
    t1 = c / torch.where(torch.abs(q) < 1e-20, 1e-20, q)
    return disc >= 0.0, torch.minimum(t0, t1), torch.maximum(t0, t1)


def _intersect_spheres(geo: Geometry, ray: Ray):
    valid, near, far = _sphere_roots(geo.sph_center, geo.sph_radius,
                                     ray.o[:, None, :], ray.d[:, None, :])
    mint, maxt = ray.mint[:, None], ray.maxt[:, None]
    t = torch.where((near >= mint) & (near <= maxt), near,
                    torch.where((far >= mint) & (far <= maxt), far,
                                float("inf")))
    t = torch.where(valid, t, float("inf"))
    tb, best = torch.min(t, dim=-1)
    return (tb, torch.zeros(tb.shape[0], 2, device=tb.device),
            best.to(torch.int32), geo.sph_shape[best])


def _intersect_rects(geo: Geometry, ray: Ray):
    t, p, ok = _plane_hit_local(geo.rect_to_world, ray)
    inside = (torch.abs(p[..., 0]) <= 1.0) & (torch.abs(p[..., 1]) <= 1.0)
    valid = (ok & inside & (t >= ray.mint[:, None])
             & (t <= ray.maxt[:, None]))
    t = torch.where(valid, t, float("inf"))
    tb, best = torch.min(t, dim=-1)
    pb = torch.gather(p[..., :2], 1,
                      best[:, None, None].expand(-1, 1, 2))[:, 0]
    return (tb, 0.5 * (pb + 1.0), best.to(torch.int32),
            geo.rect_shape[best])


def _intersect_disks(geo: Geometry, ray: Ray):
    t, p, ok = _plane_hit_local(geo.disk_to_world, ray)
    valid = (ok & (sqr(p[..., 0]) + sqr(p[..., 1]) <= 1.0)
             & (t >= ray.mint[:, None]) & (t <= ray.maxt[:, None]))
    t = torch.where(valid, t, float("inf"))
    tb, best = torch.min(t, dim=-1)
    pb = torch.gather(p[..., :2], 1,
                      best[:, None, None].expand(-1, 1, 2))[:, 0]
    r = safe_sqrt(sqr(pb[:, 0]) + sqr(pb[:, 1]))
    phi = torch.atan2(pb[:, 1], pb[:, 0])
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
    return (tb, torch.stack([r, phi / (2 * math.pi)], dim=-1),
            best.to(torch.int32), geo.disk_shape[best])


def _quadric_roots(a, b, c):
    """(ok, t0 <= t1) of a x^2 + b x + c by the stable form, with the
    reference's guards against a zero a or q."""
    disc = sqr(b) - 4.0 * a * c
    sq = safe_sqrt(disc)
    a_s = torch.where(torch.abs(a) < 1e-20, 1e-20, a)
    q = -0.5 * (b + torch.where(b >= 0, sq, -sq))
    r0 = q / a_s
    r1 = c / torch.where(torch.abs(q) < 1e-20, 1e-20, q)
    return disc >= 0, torch.minimum(r0, r1), torch.maximum(r0, r1)


def _closest_quadric(ok, t0, t1, o, d, length, ray, shapes):
    """The nearest root within [mint, maxt] and z in [0, length] of each
    (lane, primitive) pair, reduced over the primitives."""
    z0 = o[..., 2] + d[..., 2] * t0
    z1 = o[..., 2] + d[..., 2] * t1
    mint, maxt = ray.mint[:, None], ray.maxt[:, None]
    v0 = ok & (t0 >= mint) & (t0 <= maxt) & (z0 >= 0) & (z0 <= length)
    v1 = ok & (t1 >= mint) & (t1 <= maxt) & (z1 >= 0) & (z1 <= length)
    t = torch.where(v0, t0, torch.where(v1, t1, float("inf")))
    tb, best = torch.min(t, dim=-1)
    return (tb, torch.zeros(tb.shape[0], 2, device=tb.device),
            best.to(torch.int32), shapes[best])


def _local_rays(to_world: Transform, ray: Ray):
    """Ray origins and directions in each primitive's frame (N, P, 3)."""
    inv = to_world.inverse()
    return (inv.transform_affine_point(ray.o[:, None, :]),
            inv.transform_vector(ray.d[:, None, :]))


def _intersect_cylinders(geo: Geometry, ray: Ray):
    o, d = _local_rays(geo.cyl_to_world, ray)
    a = sqr(d[..., 0]) + sqr(d[..., 1])
    b = 2.0 * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1])
    c = sqr(o[..., 0]) + sqr(o[..., 1]) - sqr(geo.cyl_radius)
    ok, t0, t1 = _quadric_roots(a, b, c)
    return _closest_quadric(ok, t0, t1, o, d, geo.cyl_length, ray,
                            geo.cyl_shape)


def _cone_coeffs(geo: Geometry, o, d):
    """Quadratic coefficients of the cone x^2 + y^2 = (r (1 - z/L))^2 for
    local-frame rays: (a, b, c, slope r/L)."""
    r = geo.cone_radius
    k = r / torch.clamp(geo.cone_length, min=1e-9)
    c0 = r - k * o[..., 2]
    c1 = -k * d[..., 2]
    a = sqr(d[..., 0]) + sqr(d[..., 1]) - sqr(c1)
    b = 2.0 * (o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1]) - 2.0 * c0 * c1
    c = sqr(o[..., 0]) + sqr(o[..., 1]) - sqr(c0)
    return a, b, c, k


def _intersect_cones(geo: Geometry, ray: Ray):
    o, d = _local_rays(geo.cone_to_world, ray)
    a, b, c, _k = _cone_coeffs(geo, o, d)
    ok, t0, t1 = _quadric_roots(a, b, c)
    return _closest_quadric(ok, t0, t1, o, d, geo.cone_length, ray,
                            geo.cone_shape)


@scoped_phase("ert::query")
def ray_intersect_preliminary(geo: Geometry, ray: Ray,
                              active=None) -> PreliminaryIntersection:
    """Closest hit over meshes, instances, spheres, rectangles, disks,
    cylinders and cones (in the reference's order, so ties resolve alike). ``active``
    (optional bool (N,)) marks the lanes whose hits are wanted; the tile
    kernel sees the others as dead rays (maxt = mint), which cannot hit.
    One tile kernel serves every mesh leaf, instanced or not."""
    n = ray.o.shape[0]
    dev = ray.o.device
    t = torch.full((n,), float("inf"), dtype=ray.o.dtype, device=dev)
    uv = ray.o.new_zeros(n, 2)
    prim = torch.zeros(n, dtype=torch.int32, device=dev)
    shape = torch.full((n,), -1, dtype=torch.int32, device=dev)

    def merge(tf, uvf, primf, shapef):
        nonlocal t, uv, prim, shape
        closer = tf < t
        t = torch.where(closer, tf, t)
        uv = torch.where(closer[:, None], uvf, uv)
        prim = torch.where(closer, primf, prim)
        shape = torch.where(closer, shapef, shape)

    if geo.has_tiles:
        tile_ray = ray
        if active is not None:
            tile_ray = dataclasses.replace(
                ray, maxt=torch.where(active, ray.maxt, ray.mint))
        merge(*_QUERIES[_accel_mode(geo)](geo.tiles(), tile_ray))
    if geo.sph_shape.shape[0] > 0:
        merge(*_intersect_spheres(geo, ray))
    if geo.rect_shape.shape[0] > 0:
        merge(*_intersect_rects(geo, ray))
    if geo.disk_shape.shape[0] > 0:
        merge(*_intersect_disks(geo, ray))
    if geo.cyl_shape.shape[0] > 0:
        merge(*_intersect_cylinders(geo, ray))
    if geo.cone_shape.shape[0] > 0:
        merge(*_intersect_cones(geo, ray))
    shape = torch.where(torch.isfinite(t), shape, -1)
    return PreliminaryIntersection(t=t, prim_uv=uv, prim_index=prim,
                                   shape_index=shape)


def ray_test(geo: Geometry, ray: Ray, active=None):
    """Occlusion query: any hit within [mint, maxt)."""
    return ray_intersect_preliminary(geo, ray, active).is_valid


def compute_surface_interaction(geo: Geometry, ray: Ray,
                                pi: PreliminaryIntersection):
    """Recompute the hit per family of the hit shape (mesh.cpp, sphere.cpp,
    rectangle.cpp, disk.cpp, cylinder.cpp and cone.cpp formulas),
    differentiably in the ray and the primitive
    data; the preliminary hit's distance is detached and clamped before
    any use (a miss's inf would make a zero cotangent NaN)."""
    n_lanes = ray.o.shape[0]
    dev = ray.o.device
    valid = pi.is_valid
    family = geo.shape_family[torch.clamp(pi.shape_index, min=0)]
    pit = torch.where(valid, torch.clamp(pi.t.detach(), max=INVALID_T), 0.0)
    t = torch.where(valid, pit, INVALID_T)
    p = ray.at(pit)
    axis = lambda i: torch.nn.functional.one_hot(
        torch.full((n_lanes,), i, device=dev), 3).to(ray.o.dtype)
    n = axis(2)
    sh_n = n
    uv = pi.prim_uv
    dp_du = axis(0)
    dp_dv = axis(1)

    def sel(mask, new, old):
        if new.ndim > mask.ndim:
            mask = mask[..., None]
        return torch.where(mask, new, old)

    F = geo.faces.shape[0]
    if F > 0:
        m = (family == FAMILY_MESH) & valid
        f = geo.faces[torch.clamp(pi.prim_index, 0, F - 1)].long()
        v0, v1, v2 = (geo.vertices[f[:, i]] for i in range(3))
        tm, u, v, _ok = moller_trumbore(ray.o, ray.d, v0, v1, v2)
        w = 1.0 - u - v
        pm = v0 * w[:, None] + v1 * u[:, None] + v2 * v[:, None]
        ng = normalize(cross(v1 - v0, v2 - v0))
        vn0, vn1, vn2 = (geo.normals[f[:, i]] for i in range(3))
        has_vn = torch.sum(sqr(vn0), dim=-1) > 1e-12
        vn_interp = vn0 * w[:, None] + vn1 * u[:, None] + vn2 * v[:, None]
        ns = normalize(torch.where(has_vn[:, None], vn_interp, ng))
        ns = sel(has_vn, ns, ng)
        uv0, uv1, uv2 = (geo.uvs[f[:, i]] for i in range(3))
        uvm = uv0 * w[:, None] + uv1 * u[:, None] + uv2 * v[:, None]
        t = sel(m, tm, t)
        p = sel(m, pm, p)
        n = sel(m, ng, n)
        sh_n = sel(m, ns, sh_n)
        uv = sel(m, uvm, uv)
        dp_du = sel(m, v1 - v0, dp_du)
        dp_dv = sel(m, v2 - v0, dp_dv)

    if geo.n_instances > 0:
        m = (family == FAMILY_IMESH) & valid
        inst = torch.clamp(geo.shape_inst[torch.clamp(pi.shape_index, min=0)],
                           min=0).long()
        w2l = Transform(m=geo.inst_w2l.m[inst], inv_t=geo.inst_w2l.inv_t[inst])
        l2w = Transform(m=geo.inst_l2w.m[inst], inv_t=geo.inst_l2w.inv_t[inst])
        f = geo.ig_faces[torch.clamp(pi.prim_index, 0,
                                     geo.ig_faces.shape[0] - 1)].long()
        v0, v1, v2 = (geo.ig_vertices[f[:, i]] for i in range(3))
        # re-intersection in instance space (an affine map keeps t)
        o_l = w2l.transform_affine_point(ray.o)
        d_l = w2l.transform_vector(ray.d)
        tm, u, v, _ok = moller_trumbore(o_l, d_l, v0, v1, v2)
        w = 1.0 - u - v
        pm = l2w.transform_affine_point(
            v0 * w[:, None] + v1 * u[:, None] + v2 * v[:, None])
        ng = normalize(l2w.transform_normal(cross(v1 - v0, v2 - v0)))
        vn0, vn1, vn2 = (geo.ig_normals[f[:, i]] for i in range(3))
        has_vn = torch.sum(sqr(vn0), dim=-1) > 1e-12
        vn_interp = vn0 * w[:, None] + vn1 * u[:, None] + vn2 * v[:, None]
        ns_l = torch.where(has_vn[:, None], vn_interp,
                           cross(v1 - v0, v2 - v0))
        ns = normalize(l2w.transform_normal(torch.where(
            torch.sum(sqr(ns_l), dim=-1, keepdim=True) > 1e-20, ns_l,
            torch.ones_like(ns_l))))
        ns = sel(has_vn, ns, ng)
        uv0, uv1, uv2 = (geo.ig_uvs[f[:, i]] for i in range(3))
        uvm = uv0 * w[:, None] + uv1 * u[:, None] + uv2 * v[:, None]
        t = sel(m, tm, t)
        p = sel(m, pm, p)
        n = sel(m, ng, n)
        sh_n = sel(m, ns, sh_n)
        uv = sel(m, uvm, uv)
        dp_du = sel(m, l2w.transform_vector(v1 - v0), dp_du)
        dp_dv = sel(m, l2w.transform_vector(v2 - v0), dp_dv)

    S = geo.sph_shape.shape[0]
    if S > 0:
        m = (family == FAMILY_SPHERE) & valid
        k = torch.clamp(pi.prim_index, 0, S - 1).long()
        c, r, flip = geo.sph_center[k], geo.sph_radius[k], geo.sph_flip[k]
        _v, near, far = _sphere_roots(c, r, ray.o, ray.d)
        # which root was hit is a sampling decision (a bool: no gradient)
        use_far = torch.abs(pit - far) < torch.abs(pit - near)
        ts = torch.where(use_far, far, near)
        # re-projected onto the sphere for robustness (sphere.cpp)
        ns = normalize(ray.at(ts) - c)
        ps = c + ns * r[:, None]
        nss = torch.where(flip[:, None], -ns, ns)
        theta = torch.acos(torch.clamp(ns[:, 2], -1, 1))
        phi = torch.atan2(ns[:, 1], ns[:, 0])
        phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
        du = torch.stack([-ns[:, 1], ns[:, 0], torch.zeros_like(theta)],
                         dim=-1)
        t = sel(m, ts, t)
        p = sel(m, ps, p)
        n = sel(m, nss, n)
        sh_n = sel(m, nss, sh_n)
        uv = sel(m, torch.stack([phi / (2 * math.pi), theta / math.pi],
                                dim=-1), uv)
        dp_du = sel(m, du, dp_du)
        dp_dv = sel(m, cross(nss, du), dp_dv)

    R = geo.rect_shape.shape[0]
    if R > 0:
        m = (family == FAMILY_RECT) & valid
        r = torch.clamp(pi.prim_index, 0, R - 1).long()
        tw = Transform(m=geo.rect_to_world.m[r],
                       inv_t=geo.rect_to_world.inv_t[r])
        inv = tw.inverse()
        o_l = inv.transform_affine_point(ray.o)
        d_l = inv.transform_vector(ray.d)
        dz = torch.where(torch.abs(d_l[:, 2]) < 1e-12, 1e-12, d_l[:, 2])
        tr = -o_l[:, 2] / dz
        p_l = o_l + d_l * tr[:, None]
        pr = tw.transform_affine_point(
            torch.cat([p_l[:, :2], torch.zeros_like(p_l[:, :1])], dim=-1))
        nr = normalize(tw.transform_normal(axis(2)))
        t = sel(m, tr, t)
        p = sel(m, pr, p)
        n = sel(m, nr, n)
        sh_n = sel(m, nr, sh_n)
        uv = sel(m, 0.5 * (p_l[:, :2] + 1.0), uv)
        dp_du = sel(m, tw.transform_vector(2.0 * axis(0)), dp_du)
        dp_dv = sel(m, tw.transform_vector(2.0 * axis(1)), dp_dv)

    D = geo.disk_shape.shape[0]
    if D > 0:
        m = (family == FAMILY_DISK) & valid
        k = torch.clamp(pi.prim_index, 0, D - 1).long()
        tw = Transform(m=geo.disk_to_world.m[k],
                       inv_t=geo.disk_to_world.inv_t[k])
        inv = tw.inverse()
        o_l = inv.transform_affine_point(ray.o)
        d_l = inv.transform_vector(ray.d)
        dz = torch.where(torch.abs(d_l[:, 2]) < 1e-12, 1e-12, d_l[:, 2])
        td = -o_l[:, 2] / dz
        p_l = o_l + d_l * td[:, None]
        pd = tw.transform_affine_point(
            torch.cat([p_l[:, :2], torch.zeros_like(p_l[:, :1])], dim=-1))
        nd = normalize(tw.transform_normal(axis(2)))
        t = sel(m, td, t)
        p = sel(m, pd, p)
        n = sel(m, nd, n)
        sh_n = sel(m, nd, sh_n)
        uv = sel(m, pi.prim_uv, uv)
        dp_du = sel(m, tw.transform_vector(axis(0)), dp_du)
        dp_dv = sel(m, tw.transform_vector(axis(1)), dp_dv)

    for fam, pool in ((FAMILY_CYLINDER, "cyl"), (FAMILY_CONE, "cone")):
        P = getattr(geo, f"{pool}_shape").shape[0]
        if P == 0:
            continue
        m = (family == fam) & valid
        k = torch.clamp(pi.prim_index, 0, P - 1).long()
        to_world = getattr(geo, f"{pool}_to_world")
        tw = Transform(m=to_world.m[k], inv_t=to_world.inv_t[k])
        pq = ray.at(pit)
        p_l = tw.inverse().transform_affine_point(pq)
        L = getattr(geo, f"{pool}_length")[k]
        if fam == FAMILY_CYLINDER:
            n_l = torch.cat([p_l[:, :2], torch.zeros_like(p_l[:, :1])],
                            dim=-1)
        else:
            slope = geo.cone_radius[k] / torch.clamp(L, min=1e-9)
            rho = safe_sqrt(sqr(p_l[:, 0]) + sqr(p_l[:, 1]))
            n_l = torch.stack([p_l[:, 0], p_l[:, 1], slope * rho], dim=-1)
        nq = normalize(tw.transform_normal(n_l))
        phi = torch.atan2(p_l[:, 1], p_l[:, 0])
        phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
        uvq = torch.stack([phi / (2 * math.pi),
                           p_l[:, 2] / torch.clamp(L, min=1e-9)], dim=-1)
        du = tw.transform_vector(torch.stack(
            [-torch.sin(phi), torch.cos(phi), torch.zeros_like(phi)], dim=-1))
        t = sel(m, pit, t)
        p = sel(m, pq, p)
        n = sel(m, nq, n)
        sh_n = sel(m, nq, sh_n)
        uv = sel(m, uvq, uv)
        dp_du = sel(m, du, dp_du)
        dp_dv = sel(m, cross(nq, du), dp_dv)

    sh_frame = Frame.from_normal(sh_n)
    si = SurfaceInteraction(
        t=t, p=p, n=n, sh_frame=sh_frame, uv=uv, prim_uv=pi.prim_uv,
        dp_du=dp_du, dp_dv=dp_dv, wi=sh_frame.to_local(-ray.d),
        time=ray.time, prim_index=pi.prim_index,
        shape_index=pi.shape_index, wavelengths=ray.wavelengths)
    # every float field in the ray's precision, as the reference pins them
    # (render/geometry.py:830-832): a double variant's float32 hero
    # wavelengths become float64 at the hit
    return _pinned(si, ray.o.dtype)


def _pinned(rec, dtype):
    """A record (nested dataclasses of tensors) with its floating tensors
    in ``dtype`` (the same tensors where they are already)."""
    if dataclasses.is_dataclass(rec):
        return type(rec)(**{f.name: _pinned(getattr(rec, f.name), dtype)
                            for f in dataclasses.fields(rec)})
    return rec.to(dtype) if rec.is_floating_point() else rec


def ray_intersect(geo: Geometry, ray: Ray, active=None):
    """The closest hit. The preliminary intersection is a sampling decision
    (which primitive, how far): it is found with autograd off, so it comes
    out detached as a whole, as the reference's ray_intersect detaches it;
    only the recomputed surface interaction carries gradients."""
    with torch.no_grad():
        pi = ray_intersect_preliminary(geo, ray, active)
    return compute_surface_interaction(geo, ray, pi)
