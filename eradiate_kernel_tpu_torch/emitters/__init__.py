"""Emitters and scene-level emitter sampling (emitters/__init__.py
counterpart; Scene::sample_emitter_direction, scene.cpp:169-215): area
emitters on shapes, the constant environment, point and directional
lights. Each kind's ``*_sample_direction`` returns (DirectionSample,
value) with the value already divided by the kind's pdf where it has one
(the area kind's division happens in sample_emitter_direction, as in the
reference)."""

from __future__ import annotations

import dataclasses

import torch

from ..core import warp
from ..core.math import dot, normalize
from ..render import shape_sampling
from ..render.geometry import ray_test
from ..render.records import DirectionSample, merge
from ..render.texture import texture_eval


def _zeros_like_batch(x, *shape, dtype=torch.float32):
    return torch.zeros(x.shape[0], *shape, dtype=dtype, device=x.device)


def area_eval(scene, params, slot, si, active):
    """Radiance of an area emitter seen along si.wi (front side only)."""
    front = si.wi[:, 2] > 0.0
    v = texture_eval(scene, params["radiance"][slot], si.uv)
    return torch.where((active & front)[:, None], v, 0.0)


def area_sample_direction(scene, params, slot, ref_p, s1, s2, active):
    """A point on the emitter's shape, seen from ``ref_p``: solid-angle
    pdf dist^2 / (area cos), zero from behind."""
    ps = shape_sampling.sample_position(scene, params["shape"][slot], s1, s2)
    delta = ps.p - ref_p
    dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-20)
    dist = torch.sqrt(dist2)
    d = delta / dist[:, None]
    cos_em = dot(ps.n, -d)
    front = cos_em > 1e-7
    pdf_sa = ps.pdf * dist2 / torch.clamp(torch.abs(cos_em), min=1e-20)
    value = texture_eval(scene, params["radiance"][slot], ps.uv)
    value = torch.where((active & front)[:, None], value, 0.0)
    ds = DirectionSample(
        p=ps.p, n=ps.n, uv=ps.uv, d=d, dist=dist,
        pdf=torch.where(front, pdf_sa, 0.0),
        delta=torch.zeros_like(front),
        emitter_index=_zeros_like_batch(dist, dtype=torch.int32))
    return ds, value


def area_pdf_direction(scene, params, slot, ref_p, ds_p, ds_n, active):
    """Solid-angle pdf of area_sample_direction choosing ``ds_p``."""
    delta = ds_p - ref_p
    dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-20)
    d = delta / torch.sqrt(dist2)[:, None]
    cos_em = torch.abs(dot(ds_n, -d))
    pdf = (shape_sampling.pdf_position(scene, params["shape"][slot]) * dist2
           / torch.clamp(cos_em, min=1e-20))
    return torch.where(active & (cos_em > 1e-7), pdf, 0.0)


def constant_eval(scene, params, slot, active):
    return torch.where(active[:, None],
                       texture_eval(scene, params["radiance"][slot]), 0.0)


def constant_sample_direction(scene, params, slot, ref_p, s1, s2, active):
    """A uniform direction on the sphere, from a point two bounding radii
    away; value / pdf."""
    d = warp.square_to_uniform_sphere(s2)
    pdf = warp.square_to_uniform_sphere_pdf(d)
    r = 2.0 * scene.bsphere_radius
    value = texture_eval(scene, params["radiance"][slot], s2)
    ds = DirectionSample(
        p=ref_p + d * r, n=-d, uv=s2, d=d, dist=r.expand(pdf.shape[0]),
        pdf=pdf, delta=torch.zeros_like(active),
        emitter_index=_zeros_like_batch(pdf, dtype=torch.int32))
    return ds, value / pdf[:, None]


def point_sample_direction(scene, params, slot, ref_p, s1, s2, active):
    """point.cpp: the delta position, intensity over dist^2."""
    p = params["position"][slot]
    delta = p - ref_p
    dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-20)
    dist = torch.sqrt(dist2)
    d = delta / dist[:, None]
    value = texture_eval(scene, params["intensity"][slot]) / dist2[:, None]
    ds = DirectionSample(
        p=p, n=-d, uv=_zeros_like_batch(dist, 2), d=d, dist=dist,
        pdf=torch.ones_like(dist), delta=torch.ones_like(active),
        emitter_index=_zeros_like_batch(dist, dtype=torch.int32))
    return ds, value


def directional_sample_direction(scene, params, slot, ref_p, s1, s2, active):
    """directional.cpp:64-132: delta direction against the travel
    direction, from a point two bounding radii away."""
    d_emit = normalize(params["direction"][slot])
    d = -d_emit
    r = 2.0 * scene.bsphere_radius
    value = texture_eval(scene, params["irradiance"][slot])
    ds = DirectionSample(
        p=ref_p + d * r, n=d_emit, uv=_zeros_like_batch(d, 2), d=d,
        dist=r.expand(d.shape[0]), pdf=torch.ones_like(d[:, 0]),
        delta=torch.ones_like(active),
        emitter_index=_zeros_like_batch(d, dtype=torch.int32))
    return ds, value


KIND_SAMPLERS = {"area": area_sample_direction,
                 "constant": constant_sample_direction,
                 "point": point_sample_direction,
                 "directional": directional_sample_direction}


def sample_emitter_direction(scene, si, s_pick, s1, s2, active,
                             test_visibility=True):
    """Uniform emitter pick, per-kind direction sample, shadow ray.
    Returns (ds, weight) with the pick pmf folded in (weight = value /
    (ds.pdf * pmf) for non-delta kinds). Without ``test_visibility`` (the
    volumetric NEE, which walks the connection itself) no shadow ray is
    traced, and ``si`` needs only ``p`` and ``t``."""
    cfg = scene.config
    n_em = cfg.n_emitters
    dev = si.t.device
    z3 = _zeros_like_batch(si.t, 3)
    z = _zeros_like_batch(si.t)
    ds = DirectionSample(
        p=z3, n=z3, uv=_zeros_like_batch(si.t, 2), d=z3, dist=z, pdf=z,
        delta=torch.zeros_like(active),
        emitter_index=torch.full_like(si.t, -1, dtype=torch.int32))
    zc = _zeros_like_batch(si.t, cfg.variant.n_channels)
    if n_em == 0:
        return ds, zc

    idx = torch.clamp((s_pick * n_em).to(torch.int32), max=n_em - 1)
    kind_id = scene.emitter_kind[idx]
    slot = scene.emitter_slot[idx]
    value = zc
    for k, kind in enumerate(cfg.emitter_kinds):
        m = active & (kind_id == k)
        # other kinds' lanes read slot 0 (the reference's gathers clamp)
        d_k, v_k = KIND_SAMPLERS[kind](scene, scene.emitters[kind],
                                       torch.where(kind_id == k, slot, 0),
                                       si.p, s1, s2, m)
        if kind == "area":  # weight = value / pdf
            v_k = torch.where(d_k.pdf[:, None] > 0,
                              v_k / torch.clamp(d_k.pdf[:, None], min=1e-20),
                              0.0)
        ds = merge(d_k, ds, m)
        value = torch.where(m[:, None], v_k, value)

    ds = dataclasses.replace(ds, pdf=ds.pdf * (1.0 / n_em),
                             emitter_index=idx)
    value = value * n_em
    if not test_visibility:
        return ds, torch.where(active[:, None], value, 0.0)
    shadow_ray, _dist = si.spawn_ray_to(ds.p)
    occluded = ray_test(scene.geo, shadow_ray, active)
    return ds, torch.where((active & ~occluded)[:, None], value, 0.0)


def pdf_emitter_direction(scene, ref_p, si_hit, escaped, active):
    """Solid-angle pdf of emitter sampling choosing the direction that hit
    ``si_hit`` (an area emitter) or escaped (the constant environment):
    the MIS weight of BSDF-sampled rays (scene.cpp pdf_emitter_direction)."""
    cfg = scene.config
    pdf = torch.zeros(ref_p.shape[0], device=ref_p.device)
    if cfg.n_emitters == 0:
        return pdf
    if "area" in cfg.emitter_kinds:
        em_idx = scene.shape_emitter[torch.clamp(si_hit.shape_index, min=0)]
        has = active & si_hit.is_valid & (em_idx >= 0)
        slot = torch.where(has, scene.emitter_slot[torch.clamp(em_idx, min=0)],
                           0)
        p_area = area_pdf_direction(scene, scene.emitters["area"], slot,
                                    ref_p, si_hit.p, si_hit.n, has)
        pdf = torch.where(has, p_area, pdf)
    if cfg.env_emitter >= 0:
        pdf = torch.where(active & escaped, warp.INV_FOUR_PI, pdf)
    return pdf / cfg.n_emitters


def eval_emitter_hit(scene, si, active):
    """Radiance emitted toward the viewer at a surface hit (area
    emitters)."""
    out = _zeros_like_batch(si.t, scene.config.variant.n_channels)
    if "area" not in scene.config.emitter_kinds:
        return out
    em_idx = scene.shape_emitter[torch.clamp(si.shape_index, min=0)]
    has = active & si.is_valid & (em_idx >= 0)
    slot = torch.where(has, scene.emitter_slot[torch.clamp(em_idx, min=0)],
                       0)
    v = area_eval(scene, scene.emitters["area"], slot, si, has)
    return torch.where(has[:, None], v, out)


def eval_environment(scene, ray, escaped, active):
    """Radiance of escaped rays (the constant environment)."""
    cfg = scene.config
    out = _zeros_like_batch(ray.o, cfg.variant.n_channels)
    if cfg.env_emitter < 0:
        return out
    slot = scene.emitter_slot[cfg.env_emitter].expand(ray.o.shape[0])
    m = active & escaped
    v = constant_eval(scene, scene.emitters["constant"], slot, m)
    return torch.where(m[:, None], v, out)
