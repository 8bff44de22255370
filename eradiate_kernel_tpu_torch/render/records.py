"""Interaction and sampling records (render/records.py counterpart).

SoA dataclasses over the wavefront. The two-phase hit is kept: the
accelerator fills a ``PreliminaryIntersection``; ``SurfaceInteraction`` is
recomputed from primitive data by ``geometry.compute_surface_interaction``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.frame import Frame
from ..core.math import INVALID_T, RayEpsilon, ShadowEpsilon, dot, normalize
from ..core.ray import Ray
from ..core.types import resolve_device


def merge(new, old, mask):
    """Per lane ``new`` where ``mask`` else ``old``, over every tensor field
    of two records of the same type (nested dataclasses included)."""
    if dataclasses.is_dataclass(new):
        return type(new)(**{
            f.name: merge(getattr(new, f.name), getattr(old, f.name), mask)
            for f in dataclasses.fields(new)})
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)


@dataclasses.dataclass(frozen=True)
class PreliminaryIntersection:
    t: torch.Tensor            # (N,) inf on a miss
    prim_uv: torch.Tensor      # (N, 2)
    prim_index: torch.Tensor   # (N,) i32 index into the family's pool
    shape_index: torch.Tensor  # (N,) i32, -1 on a miss

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def is_valid(self):
        return torch.isfinite(self.t) & (self.shape_index >= 0)


@dataclasses.dataclass(frozen=True)
class SurfaceInteraction:
    t: torch.Tensor
    p: torch.Tensor            # (N, 3)
    n: torch.Tensor            # (N, 3) geometric normal
    sh_frame: Frame            # shading frame
    uv: torch.Tensor           # (N, 2)
    prim_uv: torch.Tensor      # (N, 2)
    dp_du: torch.Tensor        # (N, 3)
    dp_dv: torch.Tensor        # (N, 3)
    wi: torch.Tensor           # (N, 3) incident direction, local frame
    time: torch.Tensor         # (N,)
    prim_index: torch.Tensor   # (N,) i32
    shape_index: torch.Tensor  # (N,) i32, -1 if invalid
    wavelengths: torch.Tensor = None  # (N, nw) the ray's; None: (N, 0)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if self.wavelengths is None:
            object.__setattr__(self, "wavelengths",
                               self.t.new_zeros(self.t.shape + (0,)))

    @property
    def is_valid(self):
        return self.shape_index >= 0

    def to_world(self, v):
        return self.sh_frame.to_world(v)

    def to_local(self, v):
        return self.sh_frame.to_local(v)

    def _offset_origin(self, d):
        scale = 1.0 + torch.amax(torch.abs(self.p), dim=-1)
        sgn = torch.where(dot(self.n, d) >= 0.0, 1.0, -1.0)
        return self.p + (RayEpsilon * scale * sgn)[..., None] * self.n

    def spawn_ray(self, d, maxt=None):
        """Ray leaving along d, offset along the geometric normal; maxt
        defaults to INVALID_T."""
        o = self._offset_origin(d)
        return Ray(o=o, d=d, mint=torch.zeros_like(self.t),
                   maxt=torch.full_like(self.t, INVALID_T) if maxt is None
                   else maxt, time=self.time, wavelengths=self.wavelengths)

    def spawn_ray_to(self, target):
        """Shadow ray toward ``target`` with an epsilon gap at both ends;
        the distance is taken from the offset origin."""
        o = self._offset_origin(normalize(target - self.p))
        delta = target - o
        dist = torch.sqrt(torch.clamp(torch.sum(delta * delta, dim=-1),
                                      min=1e-30))
        d = delta / dist[..., None]
        return Ray(o=o, d=d, mint=torch.zeros_like(dist),
                   maxt=dist * (1.0 - ShadowEpsilon), time=self.time,
                   wavelengths=self.wavelengths), dist


def invalid_si(batch_shape, n_wavelengths, dtype=torch.float32,
               device=None, wavelengths=None):
    """An invalid interaction (shape -1) over ``batch_shape`` lanes (a
    shape or a count) in ``dtype``, carrying zero wavelengths (*batch,
    n_wavelengths), or the lanes' own ``wavelengths``. ``device``: that of
    ``wavelengths``, else CUDA unless named (as the entry points resolve
    it)."""
    batch = tuple(batch_shape) if isinstance(batch_shape, (tuple, list)) \
        else (int(batch_shape),)
    if device is None and wavelengths is not None:
        device = wavelengths.device
    device = resolve_device(device)
    z = lambda *shape: torch.zeros(batch + shape, dtype=dtype, device=device)
    z3 = z(3)
    unit = lambda i: torch.nn.functional.one_hot(
        torch.full(batch, i, device=device), 3).to(dtype)
    return SurfaceInteraction(
        t=torch.full(batch, INVALID_T, dtype=dtype, device=device), p=z3,
        n=unit(2), sh_frame=Frame(s=unit(0), t=unit(1), n=unit(2)),
        uv=z(2), prim_uv=z(2), dp_du=z3, dp_dv=z3, wi=unit(2), time=z(),
        prim_index=torch.zeros(batch, dtype=torch.int32, device=device),
        shape_index=torch.full(batch, -1, dtype=torch.int32, device=device),
        wavelengths=z(n_wavelengths) if wavelengths is None
        else wavelengths)


@dataclasses.dataclass(frozen=True)
class RayDifferential:
    """Offset-ray differentials (ray.h:21-44 RayDifferential3f): the camera
    ray re-sampled one film pixel over in x and y, pre-scaled by the
    sample-density factor 1/sqrt(spp) (Ray::scale_differential with
    integrator.cpp:257-261's diff_scale_factor)."""

    o_x: torch.Tensor  # (N, 3)
    d_x: torch.Tensor  # (N, 3)
    o_y: torch.Tensor  # (N, 3)
    d_y: torch.Tensor  # (N, 3)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def compute_uv_partials(si, rd):
    """SurfaceInteraction::compute_uv_partials (interaction.h:217-249):
    intersect both offset rays with the hit's tangent plane and solve the
    2x2 least-squares system projecting dp_dx and dp_dy onto (dp_du,
    dp_dv). Returns (duv_dx, duv_dy) (N, 2) each, zero where dp_du and
    dp_dv are degenerate."""
    d = dot(si.n, si.p)
    t_x = (d - dot(si.n, rd.o_x)) / dot(si.n, rd.d_x)
    t_y = (d - dot(si.n, rd.o_y)) / dot(si.n, rd.d_y)
    dp_dx = rd.o_x + rd.d_x * t_x[..., None] - si.p
    dp_dy = rd.o_y + rd.d_y * t_y[..., None] - si.p

    a00 = dot(si.dp_du, si.dp_du)
    a01 = dot(si.dp_du, si.dp_dv)
    a11 = dot(si.dp_dv, si.dp_dv)
    inv_det = 1.0 / (a00 * a11 - a01 * a01)
    inv_det = torch.where(torch.isfinite(inv_det), inv_det, 0.0)

    b0x = dot(si.dp_du, dp_dx)
    b1x = dot(si.dp_dv, dp_dx)
    b0y = dot(si.dp_du, dp_dy)
    b1y = dot(si.dp_dv, dp_dy)
    duv_dx = torch.stack([a11 * b0x - a01 * b1x,
                          a00 * b1x - a01 * b0x], -1) * inv_det[..., None]
    duv_dy = torch.stack([a11 * b0y - a01 * b1y,
                          a00 * b1y - a01 * b0y], -1) * inv_det[..., None]
    return duv_dx, duv_dy


@dataclasses.dataclass(frozen=True)
class PositionSample:
    """A point sampled on a shape's surface (area-measure pdf)."""

    p: torch.Tensor            # (N, 3)
    n: torch.Tensor            # (N, 3)
    uv: torch.Tensor           # (N, 2)
    pdf: torch.Tensor          # (N,)
    delta: torch.Tensor        # (N,) bool

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DirectionSample:
    """A position sample seen from a reference point (solid-angle pdf)."""

    p: torch.Tensor
    n: torch.Tensor
    uv: torch.Tensor           # (N, 2)
    d: torch.Tensor            # (N, 3) reference -> target
    dist: torch.Tensor
    pdf: torch.Tensor
    delta: torch.Tensor        # bool
    emitter_index: torch.Tensor

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
