"""Wavefront MIS path tracer (integrators/path.py counterpart).

One masked bounce per loop iteration over SoA path state. The intersection
is deferred to the top of the bounce, and the emitter-hit MIS weight is
computed from the previous bounce's carried (bsdf_pdf, hit point, delta
flag). Depth is per lane, so the bounce also drives the regenerating lane
pool (integrators.render_wavefront_regen) and its path-replay backward
(integrators/replay.py). A site whose lanes are all dead is skipped:
``if any_lane(mask):`` (one counted host sync per site) stands in for the
reference's ``lax.cond``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import bsdfs, emitters
from ..bsdfs import common as bsdf_flags
from ..core.ray import Ray
from ..core.rng import Sampler
from ..render.geometry import ray_intersect
from ..render.records import SurfaceInteraction, invalid_si, merge
from ..utils.runtime import scoped_phase
from .common import any_lane, mis_weight


@dataclasses.dataclass(frozen=True)
class _PathState:
    sampler: Sampler
    ray: Ray
    si: SurfaceInteraction
    needs_intersection: torch.Tensor  # (N,) bool
    throughput: torch.Tensor          # (N, 3)
    result: torch.Tensor              # (N, 3)
    eta: torch.Tensor                 # (N,)
    prev_bsdf_pdf: torch.Tensor       # (N,) pdf of the bounce that spawned ray
    prev_p: torch.Tensor              # (N, 3) previous hit point
    prev_delta: torch.Tensor          # (N,) bool: last lobe was delta
    valid_ray: torch.Tensor           # (N,) bool
    depth: torch.Tensor               # (N,) i32
    active: torch.Tensor              # (N,) bool
    n_rays: torch.Tensor              # () rays traced


# the path-replay backward (integrators/replay.py) may differentiate this
# integrator: `result` and `throughput` carry the replay's cotangents.
# prev_bsdf_pdf's cross-bounce cotangent is dropped, the detached-MIS
# approximation (exact for value-class parameters, whose pdfs do not
# depend on them)
_REPLAY_OK = True


def _knobs(scene):
    """(max_iterations, bounce kwargs): the lane pool's contract."""
    cfg = scene.config.integrator
    return cfg.max_depth, dict(max_depth=cfg.max_depth,
                               rr_depth=cfg.rr_depth)


def _init_state(scene, sampler: Sampler, ray: Ray, active=None):
    """Fresh per-lane path state; a ray with a non-finite origin starts
    dead."""
    n = ray.o.shape[0]
    dev = ray.o.device
    ones = ray.o.new_ones(n)
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    ok = (0.0 * ray.o[:, 0]) == 0.0
    nc = scene.config.variant.channels(ray.wavelengths)
    return _PathState(
        sampler=sampler, ray=ray,
        si=invalid_si(n, ray.wavelengths.shape[-1], ray.o.dtype, dev,
                      ray.wavelengths),
        needs_intersection=ok.clone(),
        throughput=ray.o.new_ones(n, nc),
        result=ray.o.new_zeros(n, nc), eta=ones,
        # prev_delta=True gives em_pdf=0 at the first hit -> weight 1
        prev_bsdf_pdf=ones, prev_p=ray.o.new_zeros(n, 3),
        prev_delta=torch.ones(n, dtype=torch.bool, device=dev),
        valid_ray=torch.zeros(n, dtype=torch.bool, device=dev),
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        active=active & ok, n_rays=ray.o.new_zeros(()))


@scoped_phase("ert::bounce")
def _bounce(scene, s: _PathState, *, max_depth, rr_depth):
    """One masked wavefront bounce (the loop body of path.cpp:100-227)."""
    n = s.ray.o.shape[0]
    dev = s.ray.o.device
    active = s.active

    # ---- deferred intersection for this bounce's hit ------------------------
    do_isect = s.needs_intersection & active
    si = s.si
    if any_lane(do_isect):
        si = merge(ray_intersect(scene.geo, s.ray, do_isect), s.si, do_isect)
    n_rays = s.n_rays + do_isect.sum()
    needs_intersection = s.needs_intersection & ~do_isect
    first = do_isect & (s.depth == 0)
    valid_ray = torch.where(first, si.is_valid, s.valid_ray)

    # ---- emitter hit / environment with the carried MIS weight --------------
    escaped = ~si.is_valid
    mis_lanes = active & ~s.prev_delta
    em_pdf = si.t.new_zeros(n)
    if any_lane(mis_lanes):
        em_pdf = emitters.pdf_emitter_direction(scene, s.prev_p, si, escaped,
                                                mis_lanes, d=s.ray.d)
    em_pdf = torch.where(s.prev_delta, 0.0, em_pdf)
    emission_weight = mis_weight(s.prev_bsdf_pdf, em_pdf)
    hit_emit = active
    if scene.config.integrator.hide_emitters:
        hit_emit = active & (s.depth != 0)
    emit = torch.zeros_like(s.result)
    if any_lane(hit_emit):
        emit = (emitters.eval_emitter_hit(scene, si, hit_emit)
                + emitters.eval_environment(scene, s.ray, escaped, hit_emit))
    result = s.result + emission_weight[:, None] * s.throughput * emit

    active = active & si.is_valid & (s.depth + 1 < max_depth)

    # ---- russian roulette (path.cpp:137-141) --------------------------------
    smp, rr_sample = s.sampler.next_1d()
    q = torch.clamp(torch.amax(s.throughput, dim=-1) * s.eta ** 2,
                    max=0.95).detach()
    do_rr = s.depth >= rr_depth
    survive = ~do_rr | (rr_sample < q)
    throughput = torch.where(do_rr[:, None],
                             s.throughput / torch.clamp(q, min=1e-6)[:, None],
                             s.throughput)
    active = active & survive

    # ---- next-event estimation (path.cpp:151-172) ---------------------------
    smp, s_pick = smp.next_1d()
    smp, s1 = smp.next_1d()
    smp, s2 = smp.next_2d()
    bsdf_idx = scene.shape_bsdf[torch.clamp(si.shape_index, min=0)]
    is_smooth = (scene.bsdf_flags[bsdf_idx] & bsdf_flags.Smooth) != 0
    nee_active = active & is_smooth & (scene.config.n_emitters > 0)
    with scoped_phase("ert::nee"):
        if any_lane(nee_active):
            ds, emitter_weight = emitters.sample_emitter_direction(
                scene, si, s_pick, s1, s2, nee_active)
            bsdf_val, bsdf_pdf = bsdfs.bsdf_eval_pdf(
                scene, bsdf_idx, si, si.to_local(ds.d), nee_active)
            mis_pdf = torch.where(ds.delta, 0.0, bsdf_pdf)
            mis = torch.where(ds.pdf > 0, mis_weight(ds.pdf, mis_pdf), 0.0)
            result = result + torch.where(
                nee_active[:, None],
                mis[:, None] * throughput * bsdf_val * emitter_weight, 0.0)
    n_rays = n_rays + nee_active.sum()

    # ---- BSDF sampling (path.cpp:177-205) -----------------------------------
    smp, sb1 = smp.next_1d()
    smp, sb2 = smp.next_2d()
    if any_lane(active):
        bs, bsdf_weight = bsdfs.bsdf_sample(scene, bsdf_idx, si, sb1, sb2,
                                            active)
    else:
        bs, bsdf_weight = bsdf_flags.zero_bsdf_sample(
            n, s.throughput.shape[-1], dev, si.t.dtype)
    throughput = throughput * torch.where(active[:, None], bsdf_weight, 1.0)
    eta = torch.where(active, s.eta * bs.eta, s.eta)
    active = active & torch.any(throughput > 0, dim=-1) & (bs.pdf > 0)

    new_ray = si.spawn_ray(si.to_world(bs.wo))
    delta_lobe = (bs.sampled_type & bsdf_flags.Delta) != 0
    keep = lambda new, old: merge(new, old, active)
    ray_out = Ray(o=keep(new_ray.o, s.ray.o), d=keep(new_ray.d, s.ray.d),
                  mint=keep(new_ray.mint, s.ray.mint),
                  maxt=keep(new_ray.maxt, s.ray.maxt), time=s.ray.time,
                  wavelengths=s.ray.wavelengths)
    return _PathState(
        sampler=smp, ray=ray_out, si=si,
        needs_intersection=needs_intersection | active,
        throughput=keep(throughput, s.throughput),
        result=result, eta=eta,
        prev_bsdf_pdf=torch.where(active, bs.pdf, s.prev_bsdf_pdf),
        prev_p=keep(si.p, s.prev_p),
        prev_delta=torch.where(active, delta_lobe, s.prev_delta),
        valid_ray=valid_ray,
        depth=s.depth + s.active.to(torch.int32),
        active=active, n_rays=n_rays)


def _trace(scene, sampler: Sampler, ray: Ray, active=None):
    """Run up to max_depth bounces; returns (final state, bounces run).

    The reference scans a fixed max_depth bounces. Once every lane is dead
    a bounce changes nothing but the sampler's counter, which no later
    draw reads, so the loop stops there."""
    max_iterations, bkw = _knobs(scene)
    state = _init_state(scene, sampler, ray, active)
    bounces = 0
    while bounces < max_iterations and any_lane(state.active):
        state = _bounce(scene, state, **bkw)
        bounces += 1
    return state, bounces


def sample(scene, sampler: Sampler, ray: Ray, active=None):
    """Incident radiance along ``ray`` (on the ``active`` lanes, default
    all) -> (spec (N, 3), valid, sampler)."""
    final, _ = _trace(scene, sampler, ray, active)
    return final.result, final.valid_ray, final.sampler


def sample_counted(scene, sampler, ray, active=None):
    """sample() and the number of rays traced, a 0-d tensor (the bench's
    ray count)."""
    final, _ = _trace(scene, sampler, ray, active)
    return final.result, final.valid_ray, final.sampler, final.n_rays
