"""Emitters and scene-level emitter sampling (emitters/__init__.py
counterpart). The slice carries the ``directional`` emitter; the scene
builder refuses the other kinds, so a scene has no area or environment
emitter and the hit/environment terms are zero."""

from __future__ import annotations

import dataclasses

import torch

from ..core.math import normalize
from ..render.geometry import ray_test
from ..render.records import DirectionSample, merge
from ..render.texture import texture_eval


def directional_sample_direction(scene, params, slot, ref_p):
    """directional.cpp:64-132: delta direction against the travel
    direction, from a point two bounding radii away."""
    d_emit = normalize(params["direction"][slot])
    d = -d_emit
    n = d.shape[0]
    dev = d.device
    r = 2.0 * scene.bsphere_radius
    value = texture_eval(scene, params["irradiance"][slot])
    ds = DirectionSample(
        p=ref_p + d * r, n=d_emit, d=d, dist=r.expand(n),
        pdf=torch.ones(n, device=dev),
        delta=torch.ones(n, dtype=torch.bool, device=dev),
        emitter_index=torch.zeros(n, dtype=torch.int32, device=dev))
    return ds, value


KIND_SAMPLERS = {"directional": directional_sample_direction}


def sample_emitter_direction(scene, si, s_pick, s1, s2, active,
                             test_visibility=True):
    """Scene::sample_emitter_direction (scene.cpp:169-215): uniform pick,
    per-kind direction sample, shadow ray. Returns (ds, weight) with the
    pick pmf folded in. ``s1``/``s2`` are drawn for every kind and unused
    by the delta kinds of this slice. Without ``test_visibility`` (the
    volumetric NEE, which walks the connection itself) no shadow ray is
    traced, and ``si`` needs only ``p`` and ``t``."""
    cfg = scene.config
    n_em = cfg.n_emitters
    n = si.t.shape[0]
    dev = si.t.device
    z3 = torch.zeros(n, 3, device=dev)
    z = torch.zeros(n, device=dev)
    ds = DirectionSample(
        p=z3, n=z3, d=z3, dist=z, pdf=z,
        delta=torch.zeros(n, dtype=torch.bool, device=dev),
        emitter_index=torch.full((n,), -1, dtype=torch.int32, device=dev))
    if n_em == 0:
        return ds, z3

    idx = torch.clamp((s_pick * n_em).to(torch.int32), max=n_em - 1)
    kind_id = scene.emitter_kind[idx]
    slot = scene.emitter_slot[idx]
    value = z3
    for k, kind in enumerate(cfg.emitter_kinds):
        m = active & (kind_id == k)
        d_k, v_k = KIND_SAMPLERS[kind](scene, scene.emitters[kind], slot,
                                       si.p)
        ds = merge(d_k, ds, m)
        value = torch.where(m[..., None], v_k, value)

    ds = dataclasses.replace(ds, pdf=ds.pdf * (1.0 / n_em),
                             emitter_index=idx)
    value = value * n_em
    if not test_visibility:
        return ds, torch.where(active[..., None], value, 0.0)
    shadow_ray, _dist = si.spawn_ray_to(ds.p)
    occluded = ray_test(scene.geo, shadow_ray, active)
    return ds, torch.where((active & ~occluded)[..., None], value, 0.0)


def pdf_emitter_direction(scene, ref_p, si_hit, escaped, active):
    """Solid-angle pdf of sampling the direction that hit ``si_hit`` by
    emitter sampling. Only area and environment emitters have one; the
    slice has neither, so it is zero."""
    return torch.zeros(ref_p.shape[0], device=ref_p.device)


def eval_emitter_hit(scene, si, active):
    """Radiance emitted at a surface hit: no area emitters in the slice."""
    return torch.zeros(si.t.shape[0], 3, device=si.t.device)


def eval_environment(scene, ray, escaped, active):
    """Radiance of escaped rays: no environment emitter in the slice."""
    return torch.zeros(ray.o.shape[0], 3, device=ray.o.device)
