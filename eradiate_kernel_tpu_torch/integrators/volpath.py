"""Wavefront volumetric path tracer with null scattering (integrators/
volpath.py counterpart; volpath.cpp as a masked wavefront program).

- hero-channel distance sampling (volpath.cpp:63-67) against the media's
  profile majorants, null/real event classification (volpath.cpp:105-151);
- next-event estimation toward the emitters through media and null
  boundaries with the integrator's ``nee_transmittance`` walk: residual
  ratio tracking ("residual", the default; for plane-parallel media its
  residual is zero and the walk is the exact closed form), ratio tracking
  against the majorant ("track", volpath.cpp:282-365) or Gauss-Legendre
  quadrature with ``nee_quad_points`` nodes ("quadrature"); free flights
  fly against the media's local profile majorant or, under
  ``ff_majorant="segment"``, the segment's one majorant;
- BSDF sampling at surfaces, and for scenes with area or environment
  emitters the MIS walk of ``evaluate_direct_light`` (volpath.cpp:370-465):
  the BSDF-sampled ray is walked through media and null boundaries (the
  residual estimator under "residual", ratio tracking under the others)
  until it finds an emitter, and its contribution is weighted against the
  emitter-sampling pdf. For scenes whose emitters are all delta emitters
  the walk is dead code and is skipped, as in the reference.

Detach discipline (volpath.cpp:83): every sampling decision is cut from
the gradient as the reference cuts it with stop_gradient: the RR
probability, the null/real probability, the sigma_n and sigma_t divisors
of the null and real event weights, the residual walks' collision rates
(the NEE walk's and the MIS walk's), the tracked walks' flight pdfs,
the media's majorants and rate profiles (media/__init__.py) and the
preliminary intersection (render/geometry.py). Gradients of value-class
parameters then flow only through the carried throughput and result.

A site whose lanes are all dead is skipped when gating is on: the
reference's ``lax.cond(jnp.any(mask), ...)`` is ``if any_lane(mask):``
here, one host sync each. The regenerating driver turns the bounce-level
gates off (its occupancy is near 100 %) and keeps the walk gates. A walk
ends once every lane is done (``while_walks``) and the sampler's counter
is then pinned to where the fixed-trip walk leaves it, so both give the
same samples.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import bsdfs, emitters, media, phase
from ..bsdfs import common as bsdf_flags
from ..core.math import INVALID_T, RayEpsilon, dot
from ..core.ray import Ray
from ..core.rng import Sampler
from ..render.geometry import ray_intersect
from ..render.records import SurfaceInteraction, invalid_si, merge
from ..utils.runtime import scoped_phase
from .common import any_lane, mis_weight

_DELTA_EMITTERS = ("point", "directional", "spot", "projector")


def _all_emitters_delta(cfg):
    """No emitter can be hit by a sampled ray (delta positions and
    directions only, no environment): the MIS walk is dead code."""
    return cfg.env_emitter < 0 and all(k in _DELTA_EMITTERS
                                       for k in cfg.emitter_kinds)


def _gate(on):
    """The site gate: run fn() only if a lane of mask is live (else build
    the fallback), or always run it."""
    if on:
        return lambda mask, fn, fallback: fn() if any_lane(mask) \
            else fallback()
    return lambda mask, fn, fallback: fn()


def _index_ch(spec, channel):
    ch = torch.clamp(channel, 0, spec.shape[-1] - 1).long()
    return torch.gather(spec, -1, ch[..., None])[..., 0]


def _shape_of(si):
    return torch.clamp(si.shape_index, min=0)


def _medium_phase(scene, medium_idx):
    if scene.medium_phase.shape[0] == 0:  # medium-free scene
        return torch.zeros_like(medium_idx)
    return scene.medium_phase[torch.clamp(medium_idx, min=0)]


def _target_medium(scene, si, d):
    """Medium on the far side of an interface (shape.h target_medium)."""
    sh = _shape_of(si)
    outward = dot(d, si.n) > 0
    return torch.where(outward, scene.shape_exterior[sh],
                       scene.shape_interior[sh])


def _is_medium_transition(scene, si):
    sh = _shape_of(si)
    return (scene.shape_interior[sh] >= 0) | (scene.shape_exterior[sh] >= 0)


def _eval_null_transmission(scene, si, active, nc):
    """Only 'null' BSDFs pass light through (bsdf.h:408) -> (N, nc)."""
    kind_id = scene.bsdf_kind[scene.shape_bsdf[_shape_of(si)]]
    out = si.t.new_zeros(si.t.shape[0], nc)
    for k, kind in enumerate(scene.config.bsdf_kinds):
        if kind == "null":
            out = torch.where((active & (kind_id == k))[..., None], 1.0, out)
    return out


# =============================================================================
# NEE with residual ratio-tracked transmittance (volpath.cpp:261-367)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class _WalkHit:
    """The hit fields the transmittance walks read."""

    t: torch.Tensor            # (N,)
    p: torch.Tensor            # (N, 3)
    n: torch.Tensor            # (N, 3) geometric normal
    shape_index: torch.Tensor  # (N,) i32, -1 invalid
    uv: torch.Tensor           # (N, 2) surface uv (emitter textures)
    wi: torch.Tensor           # (N, 3) local incident direction
    wavelengths: torch.Tensor  # (N, nw) the walk ray's

    @property
    def is_valid(self):
        return torch.isfinite(self.t) & (self.shape_index >= 0)

    def offset_origin(self, d):
        """spawn_ray's origin offset (interaction.h spawn_ray)."""
        scale = 1.0 + torch.amax(torch.abs(self.p), dim=-1)
        sgn = torch.where(dot(self.n, d) >= 0.0, 1.0, -1.0)
        return self.p + (RayEpsilon * scale * sgn)[..., None] * self.n


def _walk_hit(si):
    return _WalkHit(t=si.t, p=si.p, n=si.n, shape_index=si.shape_index,
                    uv=si.uv, wi=si.wi, wavelengths=si.wavelengths)


def _invalid_walk_hit(n, dev, wavelengths, dtype):
    up = torch.zeros(n, 3, dtype=dtype, device=dev)
    up[:, 2] = 1.0
    return _WalkHit(t=torch.full((n,), INVALID_T, dtype=dtype, device=dev),
                    p=torch.zeros(n, 3, dtype=dtype, device=dev), n=up,
                    shape_index=torch.full((n,), -1, dtype=torch.int32,
                                           device=dev),
                    uv=torch.zeros(n, 2, dtype=dtype, device=dev), wi=up,
                    wavelengths=wavelengths)


@dataclasses.dataclass(frozen=True)
class _WalkState:
    sampler: Sampler
    ray: Ray
    si: _WalkHit
    needs_intersection: torch.Tensor
    medium_idx: torch.Tensor
    transmittance: torch.Tensor
    total_dist: torch.Tensor
    active: torch.Tensor
    n_rays: torch.Tensor  # () rays traced


@dataclasses.dataclass(frozen=True)
class _RefPoint:
    """The reference point of an emitter sample (what
    sample_emitter_direction reads without a visibility test)."""

    p: torch.Tensor
    t: torch.Tensor
    wavelengths: torch.Tensor


def _run_walk(body, state, nee_steps, use_while):
    """Run a bounded transmittance walk: nee_steps steps, or with
    ``use_while`` until every lane is done. Step k draws dimension dim0 + k
    wherever it draws, so the sampler is pinned to dim0 + nee_steps
    afterwards in both forms."""
    dim0 = state.sampler.dim
    for _ in range(nee_steps):
        if use_while and not any_lane(state.active):
            break
        state = body(state)
    return dataclasses.replace(state, sampler=dataclasses.replace(
        state.sampler, dim=dim0 + nee_steps))


def _walk_prelude(scene, s, ds, ca):
    """The part both walk bodies share: the remaining distance, the merged
    intersection of the lanes that need one, and the segment end."""
    remaining = torch.clamp(ds.dist * (1.0 - 1e-4) - s.total_dist, 0.0,
                            INVALID_T)
    ray = dataclasses.replace(s.ray, maxt=remaining)
    active = s.active & (remaining > 0)
    do_isect = s.needs_intersection & active
    si = ca(do_isect,
            lambda: merge(_walk_hit(ray_intersect(scene.geo, ray, do_isect)),
                          s.si, do_isect),
            lambda: s.si)
    seg_end = torch.clamp(torch.minimum(si.t, remaining), max=INVALID_T)
    return (remaining, ray, active, si, s.needs_intersection & ~do_isect,
            s.n_rays + do_isect.sum(), seg_end)


def _medium_segment(scene, med, ray, in_medium, seg_end):
    """[a, b]: the medium's bounds along the ray, clipped to the segment."""
    seg_ok, mint_m, maxt_m = media.medium_intersect_bounds(scene, med, ray,
                                                           in_medium)
    clip = lambda x: torch.minimum(torch.clamp(x, min=0.0), seg_end)
    a = torch.where(seg_ok, clip(mint_m), 0.0)
    b = torch.where(seg_ok, clip(maxt_m), 0.0)
    return a, b


def _walk_cross(scene, s, ray, si, remaining, passed, transmittance,
                needs_intersection, total_dist, n_rays, sampler, hit_res):
    """The end of a walk step: lanes that passed their segment either
    reached the emitter (done) or cross the surface bounding it (null
    transmission, a step past it, a medium transition)."""
    reached = passed & (~si.is_valid | (si.t > remaining))
    active_surface = passed & si.is_valid & (si.t <= remaining) & ~reached
    transmittance = torch.where(
        active_surface[..., None],
        transmittance * _eval_null_transmission(scene, si, active_surface,
                                                transmittance.shape[-1]),
        transmittance)
    ray = Ray(o=torch.where(active_surface[..., None],
                            si.offset_origin(ray.d), ray.o),
              d=ray.d, mint=torch.where(active_surface, 0.0, ray.mint),
              maxt=remaining, time=ray.time, wavelengths=ray.wavelengths)
    nonzero = torch.any(transmittance != 0.0, dim=-1)
    active = (hit_res | active_surface) & nonzero
    has_trans = active_surface & _is_medium_transition(scene, si)
    medium_idx = torch.where(has_trans, _target_medium(scene, si, ray.d),
                             s.medium_idx)
    return _WalkState(sampler=sampler, ray=ray, si=si,
                      needs_intersection=needs_intersection | active_surface,
                      medium_idx=medium_idx, transmittance=transmittance,
                      total_dist=total_dist, active=active, n_rays=n_rays)


def _walk_step_quadrature(scene, s, ds, ca, quad_points=8):
    """One deterministic walk step: the optical depth of the medium
    segment up to the next surface (media.medium_tau_segment: the exact
    closed form for plane-parallel media, Gauss-Legendre with
    ``quad_points`` nodes for 3D grids), then the crossing. It draws
    nothing. The residual walk takes it for plane-parallel media (their
    residual is zero), and ``nee_transmittance="quadrature"`` for all."""
    (remaining, ray, active, si, needs_intersection, n_rays,
     seg_end) = _walk_prelude(scene, s, ds, ca)
    in_medium = active & (s.medium_idx >= 0)

    def tau():
        med = torch.clamp(s.medium_idx, min=0)
        a, b = _medium_segment(scene, med, ray, in_medium, seg_end)
        return media.medium_tau_segment(scene, med, ray, a, b,
                                        ray.wavelengths, quad_points)

    tau = ca(in_medium, tau, lambda: torch.zeros_like(s.transmittance))
    transmittance = torch.where(in_medium[..., None],
                                s.transmittance * torch.exp(-tau),
                                s.transmittance)
    total_dist = s.total_dist + torch.where(active, seg_end, 0.0)
    no_hit = torch.zeros_like(active)
    return _walk_cross(scene, s, ray, si, remaining, active, transmittance,
                       needs_intersection, total_dist, n_rays, s.sampler,
                       no_hit)


def _tracked_segment(scene, s, ray, active, remaining, channel, ca):
    """The opening of a ratio-tracking step (volpath.cpp:282-312), shared
    by the NEE walk and the MIS walk: one free-flight draw against the
    majorant (dimension dim0 + k, drawn before the step's intersection),
    the merged intersection of the medium and surface lanes, and the
    transmittance ratio tr / pdf of the flight (its pdf detached, ref
    volpath.py:544, :988). ``remaining`` caps the flight (the NEE walk's
    distance left to the emitter; None: the hit). Returns (sampler, mi,
    si, the medium and surface lanes, needs_intersection, n_rays, the
    transmittance)."""
    n = ray.o.shape[0]
    nc = s.transmittance.shape[-1]
    active_medium = active & (s.medium_idx >= 0)
    active_surface = active & ~active_medium
    med = torch.clamp(s.medium_idx, min=0)
    smp, xi = s.sampler.next_1d()
    mi = ca(active_medium,
            lambda: media.sample_interaction(scene, med, ray, xi, channel,
                                             active_medium),
            lambda: media.invalid_mi(n, nc, ray.o.device, ray.o.dtype))
    do_isect = s.needs_intersection & (active_medium | active_surface)
    si = ca(do_isect,
            lambda: merge(_walk_hit(ray_intersect(scene.geo, ray, do_isect)),
                          s.si, do_isect),
            lambda: s.si)
    mi = dataclasses.replace(mi, t=torch.where(
        active_medium & (si.t < mi.t), INVALID_T, mi.t))
    t_end = si.t if remaining is None else torch.minimum(si.t, remaining)
    tr, ff_pdf = media.eval_tr_and_pdf(mi, t_end)
    tr_pdf = _index_ch(ff_pdf, channel)
    ok_pdf = tr_pdf > 1e-15
    den = torch.where(ok_pdf, tr_pdf, 1.0).detach()[..., None]
    ratio = torch.where(ok_pdf[..., None], tr / den, 0.0)
    transmittance = torch.where(active_medium[..., None],
                                s.transmittance * ratio, s.transmittance)
    return (smp, mi, si, active_medium, active_surface,
            s.needs_intersection & ~do_isect, s.n_rays + do_isect.sum(),
            transmittance)


def _walk_step_tracked(scene, s, ds, channel, ca):
    """One ratio-tracking step of the NEE walk (volpath.cpp:282-365): a
    free flight to a null collision (transmittance times sigma_n) or
    through the segment to the surface bounding it (null transmission and
    a medium transition); ``nee_transmittance="track"``."""
    remaining = torch.clamp(ds.dist * (1.0 - 1e-4) - s.total_dist, 0.0,
                            INVALID_T)
    ray = dataclasses.replace(s.ray, maxt=remaining)
    active = s.active & (remaining > 0)
    (smp, mi, si, active_medium, active_surface, needs_intersection, n_rays,
     transmittance) = _tracked_segment(scene, s, ray, active, remaining,
                                       channel, ca)
    # a flight past the remaining distance is done
    total_dist = torch.where(
        active_medium & (mi.t > remaining) & mi.is_valid, ds.dist,
        s.total_dist)
    mi = dataclasses.replace(mi, t=torch.where(
        active_medium & (mi.t > remaining), INVALID_T, mi.t))
    escaped_medium = active_medium & ~mi.is_valid
    active_medium = active_medium & mi.is_valid
    total_dist = torch.where(active_medium, total_dist + mi.t, total_dist)
    # null collision: advance, times sigma_n
    ray = dataclasses.replace(
        ray, o=torch.where(active_medium[..., None], mi.p, ray.o),
        mint=torch.where(active_medium, 0.0, ray.mint))
    si = dataclasses.replace(si, t=torch.where(active_medium, si.t - mi.t,
                                               si.t))
    transmittance = torch.where(active_medium[..., None],
                                transmittance * mi.sigma_n, transmittance)
    active_surface = active_surface | escaped_medium
    total_dist = torch.where(active_surface, total_dist + si.t, total_dist)
    active_surface = active_surface & si.is_valid & active & ~active_medium
    transmittance = torch.where(
        active_surface[..., None],
        transmittance * _eval_null_transmission(scene, si, active_surface,
                                                transmittance.shape[-1]),
        transmittance)
    ray = Ray(o=torch.where(active_surface[..., None],
                            si.offset_origin(ray.d), ray.o),
              d=ray.d, mint=torch.where(active_surface, 0.0, ray.mint),
              maxt=remaining, time=ray.time, wavelengths=ray.wavelengths)
    nonzero = torch.any(transmittance > 0, dim=-1)
    has_trans = active_surface & _is_medium_transition(scene, si)
    return _WalkState(
        sampler=smp, ray=ray, si=si,
        needs_intersection=needs_intersection | active_surface,
        medium_idx=torch.where(has_trans, _target_medium(scene, si, ray.d),
                               s.medium_idx),
        transmittance=transmittance, total_dist=total_dist,
        active=(active_medium | active_surface) & nonzero, n_rays=n_rays)


def _residual_segment(scene, s, ray, si, active, seg_end, ca):
    """The medium part of a residual-ratio-tracking step (Novak et al.
    2014), shared by the NEE walk and the MIS walk: over the medium segment
    up to ``seg_end``,
      T_seg = exp(-int sigma_c) * prod_collisions (1 - (sigma - sigma_c)/R)
    with collisions at the residual rate R >= |sigma - sigma_c|. Returns
    (sampler, collided, the collision distance (0 elsewhere), the
    transmittance, the ray and the hit moved to a collision)."""
    in_medium = active & (s.medium_idx >= 0)
    med = torch.clamp(s.medium_idx, min=0)
    smp, xi = s.sampler.next_1d()

    def med_block():
        a, b = _medium_segment(scene, med, ray, in_medium, seg_end)
        b = torch.maximum(a, b)
        hit_m, dt, rate = media.medium_residual_sample(scene, med, ray, a, b,
                                                       xi)
        hit = in_medium & hit_m
        tau_c = media.medium_ctrl_tau_segment(
            scene, med, ray, a, torch.where(hit, dt, b), ray.wavelengths)
        return hit, torch.where(hit, dt, 0.0), rate, tau_c

    z = torch.zeros_like(seg_end)
    hit_res, dt, rate, tau_c = ca(
        in_medium, med_block,
        lambda: (torch.zeros_like(active), z, z,
                 torch.zeros_like(s.transmittance)))
    transmittance = torch.where(in_medium[..., None],
                                s.transmittance * torch.exp(-tau_c),
                                s.transmittance)

    def col_block():
        p_col = ray.at(dt)
        st = media.medium_sigma_t(scene, med, p_col, ray.wavelengths)
        sc = media.medium_ctrl_sigma(scene, med, p_col, ray.wavelengths)
        # the collision rate is a sampling parameter (ref volpath.py:739,
        # :875); it arrives detached from the rate profile already
        den = torch.clamp(rate, min=1e-20).detach()[..., None]
        return 1.0 - (st - sc) / den

    w_col = ca(hit_res, col_block,
               lambda: torch.ones_like(s.transmittance))
    transmittance = torch.where(hit_res[..., None], transmittance * w_col,
                                transmittance)
    ray = dataclasses.replace(
        ray, o=torch.where(hit_res[..., None], ray.at(dt), ray.o),
        mint=torch.where(hit_res, 0.0, ray.mint))
    si = dataclasses.replace(si, t=torch.where(hit_res, si.t - dt, si.t))
    return smp, hit_res, dt, transmittance, ray, si


def _walk_step_residual(scene, s, ds, ca):
    """One residual walk step of the NEE walk: it either collides inside
    the medium (_residual_segment) or crosses the surface bounding the
    segment."""
    (remaining, ray, active, si, needs_intersection, n_rays,
     seg_end) = _walk_prelude(scene, s, ds, ca)
    smp, hit_res, dt, transmittance, ray, si = _residual_segment(
        scene, s, ray, si, active, seg_end, ca)
    total_dist = s.total_dist + torch.where(
        active, torch.where(hit_res, dt, seg_end), 0.0)
    return _walk_cross(scene, s, ray, si, remaining, active & ~hit_res,
                       transmittance, needs_intersection, total_dist, n_rays,
                       smp, hit_res)


def _nee_mode(scene):
    return dict(scene.config.integrator.extra).get("nee_transmittance",
                                                   "residual")


@scoped_phase("ert::nee")
def _sample_emitter(scene, ref_p, ref_n, is_medium_ref, wavelengths, time,
                    medium_idx, channel, sampler, active, nee_steps,
                    use_while, ca):
    """Emitter radiance attenuated by the walked transmittance along the
    connection -> (contribution (N, nc), ds, sampler, rays traced). The
    walk is the integrator's ``nee_transmittance``: 'residual' (residual
    ratio tracking; for plane-parallel media the exact closed form),
    'quadrature' (Gauss-Legendre with ``nee_quad_points`` nodes) or
    'track' (ratio tracking against the majorant)."""
    n = ref_p.shape[0]
    dev = ref_p.device
    sampler, s_pick = sampler.next_1d()
    sampler, s1 = sampler.next_1d()
    sampler, s2 = sampler.next_2d()
    ds, emitter_val = emitters.sample_emitter_direction(
        scene, _RefPoint(p=ref_p, t=ref_p.new_zeros(n),
                         wavelengths=wavelengths),
        s_pick, s1, s2, active, test_visibility=False)
    active = active & (ds.pdf > 0)
    emitter_val = torch.where(active[..., None], emitter_val, 0.0)

    # connection ray; medium references start inside the medium
    eps_n = torch.where(is_medium_ref[..., None], 0.0, 1.0)
    scale = 1.0 + torch.amax(torch.abs(ref_p), dim=-1)
    sgn = torch.where(dot(ref_n, ds.d) >= 0, 1.0, -1.0)
    o = ref_p + eps_n * (RayEpsilon * scale * sgn)[..., None] * ref_n
    ray = Ray(o=o, d=ds.d, mint=o.new_zeros(n),
              maxt=o.new_full((n,), INVALID_T), time=time,
              wavelengths=wavelengths)
    state = _WalkState(
        sampler=sampler, ray=ray,
        si=_invalid_walk_hit(n, dev, wavelengths, o.dtype),
        needs_intersection=torch.ones(n, dtype=torch.bool, device=dev),
        medium_idx=medium_idx,
        transmittance=torch.where(active[..., None], o.new_ones(
            n, scene.config.variant.channels(wavelengths)), 0.0),
        total_dist=o.new_zeros(n), active=active,
        n_rays=o.new_zeros(()))
    mode = _nee_mode(scene)
    if mode == "track":
        step = lambda s: _walk_step_tracked(scene, s, ds, channel, ca)
    elif mode == "quadrature":
        K = int(dict(scene.config.integrator.extra).get("nee_quad_points",
                                                        8))
        step = lambda s: _walk_step_quadrature(scene, s, ds, ca, K)
    elif scene.config.het_profile1d:
        # plane-parallel media: the residual is identically zero, so the
        # walk is the deterministic closed form (no rate, draw or
        # collision site)
        step = lambda s: _walk_step_quadrature(scene, s, ds, ca)
    else:
        step = lambda s: _walk_step_residual(scene, s, ds, ca)
    final = _run_walk(step, state, nee_steps, use_while)
    # lanes still walking after the cap contribute nothing
    contrib = torch.where(final.active[..., None], 0.0,
                          final.transmittance) * emitter_val
    return contrib, ds, final.sampler, final.n_rays


# =============================================================================
# evaluate_direct_light (volpath.cpp:370-465): walk a BSDF-sampled ray
# through media and null boundaries until it finds an emitter
# =============================================================================

@dataclasses.dataclass(frozen=True)
class _DirectState:
    sampler: Sampler
    ray: Ray
    si: _WalkHit
    needs_intersection: torch.Tensor
    medium_idx: torch.Tensor
    transmittance: torch.Tensor
    emitter_val: torch.Tensor  # (N, nc) transmittance x emitted radiance
    emitter_pdf: torch.Tensor  # (N,) emitter sampling's pdf of the hit
    active: torch.Tensor
    n_rays: torch.Tensor       # () rays traced


def _direct_emitter(scene, s, si, ray, ref_p, transmittance, passed, ca):
    """The emitter test of a MIS walk step at the end of its segment:
    ``passed`` lanes that find an area emitter (or escape to the
    environment) end the walk with transmittance x emitted radiance and
    emitter sampling's pdf of the direction. Returns (emitter_val,
    emitter_pdf, the lanes that found one)."""
    em_idx = scene.shape_emitter[_shape_of(si)]
    hit_area = passed & si.is_valid & (em_idx >= 0)
    hit_env = passed & ~si.is_valid & (scene.config.env_emitter >= 0)
    emitter_hit = hit_area | hit_env

    def emitter_block():
        e_val = (emitters.eval_emitter_hit(scene, si, hit_area)
                 + emitters.eval_environment(scene, ray, ~si.is_valid,
                                             hit_env))
        epdf = emitters.pdf_emitter_direction(scene, ref_p, si,
                                              ~si.is_valid, emitter_hit,
                                              d=ray.d)
        return (torch.where(emitter_hit[..., None], transmittance * e_val,
                            s.emitter_val),
                torch.where(emitter_hit, epdf, s.emitter_pdf))

    emitter_val, emitter_pdf = ca(emitter_hit, emitter_block,
                                  lambda: (s.emitter_val, s.emitter_pdf))
    return emitter_val, emitter_pdf, emitter_hit


def _direct_end(scene, s, ray, si, active_surface, transmittance,
                needs_intersection, emitter_val, emitter_pdf, still, n_rays,
                smp, nonzero_of):
    """The end of a MIS walk step: ``active_surface`` lanes cross their
    null boundary (null transmission, a step past it, a medium
    transition); the walk goes on for them and for ``still``, the lanes
    inside the medium."""
    transmittance = torch.where(
        active_surface[..., None],
        transmittance * _eval_null_transmission(scene, si, active_surface,
                                                transmittance.shape[-1]),
        transmittance)
    ray = Ray(o=torch.where(active_surface[..., None],
                            si.offset_origin(ray.d), ray.o),
              d=ray.d, mint=torch.where(active_surface, 0.0, ray.mint),
              maxt=ray.maxt, time=ray.time, wavelengths=ray.wavelengths)
    has_trans = active_surface & _is_medium_transition(scene, si)
    return _DirectState(
        sampler=smp, ray=ray, si=si,
        needs_intersection=needs_intersection | active_surface,
        medium_idx=torch.where(has_trans, _target_medium(scene, si, ray.d),
                               s.medium_idx),
        transmittance=transmittance, emitter_val=emitter_val,
        emitter_pdf=emitter_pdf,
        active=(still | active_surface) & nonzero_of(transmittance),
        n_rays=n_rays)


def _direct_step_residual(scene, s, ref_p, ca):
    """One residual step of the MIS walk: it collides inside the medium
    (_residual_segment) or reaches the surface ending its segment, where it
    either finds an emitter (the walk ends with its value and pdf) or
    crosses a null boundary."""
    active = s.active
    ray = s.ray
    do_isect = s.needs_intersection & active
    si = ca(do_isect,
            lambda: merge(_walk_hit(ray_intersect(scene.geo, ray, do_isect)),
                          s.si, do_isect),
            lambda: s.si)
    needs_intersection = s.needs_intersection & ~do_isect
    n_rays = s.n_rays + do_isect.sum()
    smp, hit_res, _dt, transmittance, ray, si = _residual_segment(
        scene, s, ray, si, active, torch.clamp(si.t, max=INVALID_T), ca)
    passed = active & ~hit_res
    emitter_val, emitter_pdf, emitter_hit = _direct_emitter(
        scene, s, si, ray, ref_p, transmittance, passed, ca)
    active = active & ~emitter_hit
    return _direct_end(scene, s, ray, si, passed & active & si.is_valid,
                       transmittance, needs_intersection, emitter_val,
                       emitter_pdf, hit_res & active, n_rays, smp,
                       lambda t: torch.any(t != 0.0, dim=-1))


def _direct_step_tracked(scene, s, ref_p, channel, ca):
    """One ratio-tracking step of the MIS walk (volpath.cpp:370-465): a
    free flight to a null collision, or through the segment to its
    surface, where the walk finds an emitter or crosses a null
    boundary."""
    ray = s.ray
    (smp, mi, si, active_medium, active_surface, needs_intersection, n_rays,
     transmittance) = _tracked_segment(scene, s, ray, s.active, None,
                                       channel, ca)
    escaped_medium = active_medium & ~mi.is_valid
    active_medium = active_medium & mi.is_valid
    ray = dataclasses.replace(
        ray, o=torch.where(active_medium[..., None], mi.p, ray.o),
        mint=torch.where(active_medium, 0.0, ray.mint))
    si = dataclasses.replace(si, t=torch.where(active_medium, si.t - mi.t,
                                               si.t))
    transmittance = torch.where(active_medium[..., None],
                                transmittance * mi.sigma_n, transmittance)
    active_surface = active_surface | escaped_medium
    emitter_val, emitter_pdf, emitter_hit = _direct_emitter(
        scene, s, si, ray, ref_p, transmittance, active_surface, ca)
    active = s.active & ~emitter_hit
    active_medium = active_medium & active
    active_surface = active_surface & active & si.is_valid & ~active_medium
    return _direct_end(scene, s, ray, si, active_surface, transmittance,
                       needs_intersection, emitter_val, emitter_pdf,
                       active_medium, n_rays, smp,
                       lambda t: torch.any(t > 0, dim=-1))


@scoped_phase("ert::nee")
def _evaluate_direct_light(scene, ref_p, ray, si_ray, medium_idx, channel,
                           sampler, active, nee_steps, use_while, ca):
    """The MIS walk of the BSDF-sampled ``ray`` (its first hit ``si_ray``
    already found) -> (transmittance x emitted radiance (N, nc), emitter
    sampling's pdf of that direction, sampler, rays traced). Under
    ``nee_transmittance="residual"`` it takes the residual estimator
    (under plane-parallel media the residual tables are zero, so the walk
    is the closed form with a dead collision site, as in the reference);
    under "track" and "quadrature" it ratio-tracks."""
    n = ref_p.shape[0]
    dev = ref_p.device
    nc = scene.config.variant.channels(ray.wavelengths)
    state = _DirectState(
        sampler=sampler, ray=ray, si=_walk_hit(si_ray),
        needs_intersection=torch.zeros(n, dtype=torch.bool, device=dev),
        medium_idx=medium_idx,
        transmittance=torch.where(active[..., None], ref_p.new_ones(
            n, nc), 0.0),
        emitter_val=ref_p.new_zeros(n, nc),
        emitter_pdf=ref_p.new_zeros(n), active=active,
        n_rays=ref_p.new_zeros(()))
    if _nee_mode(scene) == "residual":
        step = lambda s: _direct_step_residual(scene, s, ref_p, ca)
    else:
        step = lambda s: _direct_step_tracked(scene, s, ref_p, channel, ca)
    final = _run_walk(step, state, nee_steps, use_while)
    return final.emitter_val, final.emitter_pdf, final.sampler, final.n_rays


# =============================================================================
# the main loop (volpath.cpp:38-258)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class _VolPathState:
    sampler: Sampler
    ray: Ray
    si: SurfaceInteraction
    needs_intersection: torch.Tensor
    medium_idx: torch.Tensor
    throughput: torch.Tensor
    result: torch.Tensor
    eta: torch.Tensor
    depth: torch.Tensor          # (N,) i32
    channel: torch.Tensor        # (N,) i32 hero channel
    specular_chain: torch.Tensor
    valid_ray: torch.Tensor
    active: torch.Tensor
    n_rays: torch.Tensor         # () rays traced


@scoped_phase("ert::bounce")
def _bounce(scene, s: _VolPathState, *, nee_steps, max_depth, rr_depth,
            while_walks=False, gate_sites=True, gate_walks=None):
    """One masked wavefront bounce (the loop body of volpath.cpp:38-258),
    driven by the scan driver (``sample``) and the lane pool."""
    cfg = scene.config
    n = s.ray.o.shape[0]
    dev = s.ray.o.device
    nc = s.throughput.shape[-1]
    ca = _gate(gate_sites)
    ca_walk = _gate(gate_sites if gate_walks is None else gate_walks)
    smp = s.sampler
    active = s.active & torch.any(s.throughput != 0.0, dim=-1)
    ray = s.ray
    si = s.si

    # --- russian roulette (volpath.cpp:79-87) ------------------------------
    q = torch.clamp(torch.amax(s.throughput, dim=-1) * s.eta ** 2, max=0.95)
    q = torch.clamp(q, min=1e-6).detach()
    perform_rr = s.depth > rr_depth
    smp, xi_rr = smp.next_1d()
    active = active & ((xi_rr < q) | ~perform_rr)
    throughput = torch.where(perform_rr[..., None],
                             s.throughput / q[..., None], s.throughput)

    active_medium = active & (s.medium_idx >= 0)
    active_surface = active & ~active_medium

    # --- medium sampling (volpath.cpp:105-151) -----------------------------
    med = torch.clamp(s.medium_idx, min=0)
    smp, xi_m = smp.next_1d()
    mi = ca(active_medium,
            lambda: media.sample_interaction(scene, med, ray, xi_m, s.channel,
                                             active_medium),
            lambda: media.invalid_mi(n, nc, dev, ray.o.dtype))
    # ONE intersection serves the (disjoint) medium and surface lanes
    do_isect = s.needs_intersection & (active_medium | active_surface)
    si = ca(do_isect,
            lambda: merge(ray_intersect(scene.geo, ray, do_isect), si,
                          do_isect),
            lambda: si)
    n_rays = s.n_rays + do_isect.sum()
    needs_intersection = s.needs_intersection & ~do_isect
    mi = dataclasses.replace(mi, t=torch.where(
        active_medium & (si.t < mi.t), INVALID_T, mi.t))

    tr, ff_pdf = media.eval_tr_and_pdf(mi, si.t)
    tr_pdf = _index_ch(ff_pdf, s.channel)
    ok_pdf = tr_pdf > 1e-15
    den = torch.where(ok_pdf, tr_pdf, 1.0)[..., None]
    ratio = torch.where(ok_pdf[..., None], tr / den, 0.0)
    throughput = torch.where(active_medium[..., None], throughput * ratio,
                             throughput)

    escaped_medium = active_medium & ~mi.is_valid
    active_medium = active_medium & mi.is_valid

    # null vs real collision
    smp, xi_n = smp.next_1d()
    ext_ch = _index_ch(mi.combined_extinction, s.channel)
    p_real = (_index_ch(mi.sigma_t, s.channel)
              / torch.clamp(ext_ch, min=1e-30)).detach()
    null_scatter = xi_n >= p_real
    act_null = null_scatter & active_medium
    act_scatter = ~null_scatter & active_medium

    sn_ch = _index_ch(mi.sigma_n, s.channel)
    sn_ok = act_null & (sn_ch > 1e-15)
    sn_den = torch.where(sn_ok, sn_ch, 1.0).detach()[..., None]
    throughput = torch.where(
        sn_ok[..., None],
        throughput * mi.sigma_n * ext_ch[..., None] / sn_den, throughput)
    depth = s.depth + act_scatter.to(torch.int32)
    active = active & (depth < max_depth)
    act_scatter = act_scatter & active

    # null: advance (volpath.cpp:128-144)
    ray = dataclasses.replace(
        ray, o=torch.where(act_null[..., None], mi.p, ray.o),
        mint=torch.where(act_null, 0.0, ray.mint))
    si = dataclasses.replace(si, t=torch.where(act_null, si.t - mi.t, si.t))

    # real scatter (volpath.cpp:146-175)
    st_ch = _index_ch(mi.sigma_t, s.channel)
    st_ok = act_scatter & (st_ch > 1e-15)
    st_den = torch.where(st_ok, st_ch, 1.0).detach()[..., None]
    throughput = torch.where(
        st_ok[..., None],
        throughput * mi.sigma_s * ext_ch[..., None] / st_den, throughput)
    valid_ray = s.valid_ray | act_scatter
    specular_chain = s.specular_chain & ~act_scatter

    phase_idx = _medium_phase(scene, s.medium_idx)
    nee_medium_p = mi.p
    nee_medium_d_in = ray.d  # the pre-phase-sample direction

    # phase sampling
    smp, xi_p1 = smp.next_1d()
    smp, xi_p2 = smp.next_2d()
    wo_m, _ppdf = ca(act_scatter,
                     lambda: phase.phase_sample(scene, phase_idx, ray.d,
                                                xi_p1, xi_p2, act_scatter),
                     lambda: (ray.d, ray.d.new_zeros(n)))
    ray = Ray(o=torch.where(act_scatter[..., None], mi.p, ray.o),
              d=torch.where(act_scatter[..., None], wo_m, ray.d),
              mint=torch.where(act_scatter, 0.0, ray.mint),
              maxt=torch.where(act_scatter, INVALID_T, ray.maxt),
              time=ray.time, wavelengths=ray.wavelengths)
    needs_intersection = needs_intersection | act_scatter

    # --- surface interactions (volpath.cpp:180-252) ------------------------
    active_surface = active_surface | escaped_medium
    # emitter hits on specular chains only
    em_idx = scene.shape_emitter[_shape_of(si)]
    hit_area = active_surface & si.is_valid & (em_idx >= 0)
    hit_env = active_surface & ~si.is_valid & (cfg.env_emitter >= 0)
    use_emit = (hit_area | hit_env) & specular_chain
    e_val = ca(use_emit,
               lambda: emitters.eval_emitter_hit(scene, si,
                                                 use_emit & hit_area)
               + emitters.eval_environment(scene, ray, ~si.is_valid,
                                           use_emit & hit_env),
               lambda: ray.o.new_zeros(n, nc))
    result = s.result + torch.where(use_emit[..., None], throughput * e_val,
                                    0.0)

    active_surface = active_surface & si.is_valid
    bsdf_idx = scene.shape_bsdf[_shape_of(si)]
    is_smooth = (scene.bsdf_flags[bsdf_idx] & bsdf_flags.Smooth) != 0

    # merged NEE: one walk serves the (disjoint) medium and surface lanes
    active_e = active_surface & is_smooth & (depth + 1 < max_depth) & \
        (cfg.n_emitters > 0)
    nee_ref_p = torch.where(act_scatter[..., None], nee_medium_p, si.p)
    nee_ref_n = torch.where(act_scatter[..., None], -nee_medium_d_in, si.n)
    nee_active = act_scatter | active_e

    def nee_block():
        emitted, ds, smp2, nr = _sample_emitter(
            scene, nee_ref_p, nee_ref_n, act_scatter, ray.wavelengths,
            ray.time, s.medium_idx, s.channel, smp, nee_active, nee_steps,
            while_walks, ca_walk)
        # medium lanes: phase x emitted
        phase_val = phase.phase_eval(scene, phase_idx, -nee_medium_d_in,
                                     ds.d, act_scatter)
        delta_m = torch.where(act_scatter[..., None],
                              throughput * phase_val[..., None] * emitted, 0.0)
        bsdf_val, bsdf_pdf = bsdfs.bsdf_eval_pdf(scene, bsdf_idx, si,
                                                 si.to_local(ds.d), active_e)
        mis_pdf = torch.where(ds.delta, 0.0, bsdf_pdf)
        w_nee = torch.where(ds.pdf > 0, mis_weight(ds.pdf, mis_pdf), 0.0)
        delta_s = torch.where(active_e[..., None],
                              throughput * bsdf_val * w_nee[..., None]
                              * emitted, 0.0)
        return delta_m + delta_s, smp2, nr

    def nee_skip():
        # keep the stream aligned with the taken branch: the walk consumes
        # exactly 3 + nee_steps dimensions (pick, s1, s2, one per step)
        return (ray.o.new_zeros(n, nc),
                dataclasses.replace(smp, dim=smp.dim + 3 + nee_steps),
                ray.o.new_zeros(()))

    nee_delta, smp, nr_s = ca(nee_active, nee_block, nee_skip)
    result = result + nee_delta
    n_rays = n_rays + nr_s

    # bsdf sampling
    smp, xb1 = smp.next_1d()
    smp, xb2 = smp.next_2d()
    bs, bsdf_weight = ca(
        active_surface,
        lambda: bsdfs.bsdf_sample(scene, bsdf_idx, si, xb1, xb2,
                                  active_surface),
        lambda: bsdf_flags.zero_bsdf_sample(n, nc, dev, si.t.dtype))
    throughput = torch.where(active_surface[..., None],
                             throughput * bsdf_weight, throughput)
    eta = torch.where(active_surface, s.eta * bs.eta, s.eta)

    new_ray = si.spawn_ray(si.to_world(bs.wo))
    ray = Ray(o=torch.where(active_surface[..., None], new_ray.o, ray.o),
              d=torch.where(active_surface[..., None], new_ray.d, ray.d),
              mint=torch.where(active_surface, new_ray.mint, ray.mint),
              maxt=torch.where(active_surface, INVALID_T, ray.maxt),
              time=ray.time, wavelengths=ray.wavelengths)

    sampled_null = (bs.sampled_type & bsdf_flags.Null) != 0
    sampled_delta = (bs.sampled_type & bsdf_flags.Delta) != 0
    sampled_smooth = (bs.sampled_type & bsdf_flags.Smooth) != 0
    non_null = active_surface & ~sampled_null
    depth = depth + non_null.to(torch.int32)
    valid_ray = valid_ray | non_null
    specular_chain = specular_chain | (non_null & sampled_delta)
    specular_chain = specular_chain & ~(active_surface & sampled_smooth)

    add_emitter = (active_surface & ~sampled_delta & ~sampled_null
                   & torch.any(throughput != 0, dim=-1) & (depth < max_depth)
                   & (cfg.n_emitters > 0))
    si_new = ca(active_surface,
                lambda: merge(ray_intersect(scene.geo, ray, active_surface),
                              si, active_surface),
                lambda: si)
    n_rays = n_rays + active_surface.sum()
    needs_intersection = needs_intersection & ~active_surface

    # medium transition before walking the next segment
    has_trans = active_surface & _is_medium_transition(scene, si)
    medium_next = torch.where(has_trans, _target_medium(scene, si, ray.d),
                              s.medium_idx)

    if not _all_emitters_delta(cfg):
        # the MIS walk of the BSDF-sampled ray; the skipped branch advances
        # the sampler as the walk does: nee_steps dimensions
        def direct_skip():
            return (ray.o.new_zeros(n, nc), ray.o.new_zeros(n),
                    dataclasses.replace(smp, dim=smp.dim + nee_steps),
                    ray.o.new_zeros(()))

        emitted_d, emitter_pdf, smp, nr_d = ca(
            add_emitter,
            lambda: _evaluate_direct_light(
                scene, si.p, ray, si_new, medium_next, s.channel, smp,
                add_emitter, nee_steps, while_walks, ca_walk),
            direct_skip)
        n_rays = n_rays + nr_d
        w_dir = mis_weight(bs.pdf, emitter_pdf)
        result = result + torch.where(
            (add_emitter & (emitter_pdf > 0))[..., None],
            throughput * w_dir[..., None] * emitted_d, 0.0)

    return _VolPathState(
        sampler=smp, ray=ray, si=merge(si_new, si, active_surface),
        needs_intersection=needs_intersection, medium_idx=medium_next,
        throughput=throughput, result=result, eta=eta, depth=depth,
        channel=s.channel, specular_chain=specular_chain,
        valid_ray=valid_ray,
        active=active & (active_surface | active_medium), n_rays=n_rays)


# the lane pool's path-replay backward (integrators/replay.py) may
# differentiate this integrator: its state carries the additive `result`
# and the multiplicative `throughput` the replay's cotangents are for, and
# every other float field (eta: feeds only the detached RR probability; the
# ray and the hit: trajectory-class) has a zero cotangent under the detach
# discipline
_REPLAY_OK = True

# bounce kwargs of the replay's adjoint sweep: walks end early (autograd
# differentiates the steps they ran, replay.py's docstring), the site and
# walk gates are on (a skipped site records no graph); the reference's
# choice off its TPU
_REPLAY_BOUNCE_KWARGS = {"while_walks": True, "gate_sites": True,
                         "gate_walks": True}

# bounce kwargs the regenerating (primal) driver adds to _knobs': walks
# end early; the bounce-level gates are off (occupancy near 100 %), the
# walk-step gates on (most lanes finish their walk in 1-3 steps)
_PRIMAL_BOUNCE_KWARGS = {"while_walks": True, "gate_sites": False,
                         "gate_walks": True}


def _knobs(scene):
    """(max_iterations, bounce kwargs): the lane pool's contract, from the
    integrator's extra properties."""
    cfg = scene.config.integrator
    extra = dict(cfg.extra)
    max_iterations = int(extra.get("max_iterations", cfg.max_depth + 8))
    return max_iterations, dict(nee_steps=int(extra.get("nee_steps", 8)),
                                max_depth=cfg.max_depth,
                                rr_depth=cfg.rr_depth)


def _init_state(scene, sampler: Sampler, ray: Ray, active=None,
                medium_idx=None):
    """Fresh per-lane path state (the pre-loop part of volpath.cpp:38-77);
    ``medium_idx`` (N,) the medium each ray starts in (default the
    sensor's)."""
    cfg = scene.config
    n = ray.o.shape[0]
    dev = ray.o.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    v0 = 0.0 * ray.o[:, 0]
    ok = v0 == 0.0
    active = active & ok
    # hero channel selection (volpath.cpp:63-67): rgb draws one; mono and
    # spectral (whose hero wavelength is channel 0) draw nothing
    nc = scene.config.variant.channels(ray.wavelengths)
    if cfg.variant.mode == "rgb":
        sampler, cs = sampler.next_1d()
        channel = torch.clamp((cs * 3).to(torch.int32), max=2)
    else:
        channel = torch.zeros(n, dtype=torch.int32, device=dev)
    hide = cfg.integrator.hide_emitters
    return _VolPathState(
        sampler=sampler, ray=ray,
        si=invalid_si(n, ray.wavelengths.shape[-1], ray.o.dtype, dev,
                      ray.wavelengths),
        needs_intersection=ok.clone(),
        medium_idx=(torch.full((n,), cfg.sensor_medium, dtype=torch.int32,
                               device=dev) if medium_idx is None
                    else medium_idx.to(torch.int32)),
        throughput=ray.o.new_ones(n, nc) + v0[:, None],
        result=ray.o.new_zeros(n, nc),
        eta=ray.o.new_ones(n) + v0,
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        channel=channel, specular_chain=active & (not hide),
        valid_ray=torch.full((n,), (not hide) and cfg.env_emitter >= 0,
                             dtype=torch.bool, device=dev),
        active=active, n_rays=ray.o.new_zeros(()))


def _trace(scene, sampler: Sampler, ray: Ray, active=None, medium_idx=None):
    """The scan driver's trace: up to max_iterations bounces over one
    wavefront; stops once every lane is dead (a bounce then changes only
    the sampler's counter, which nothing reads)."""
    max_iterations, bkw = _knobs(scene)
    state = _init_state(scene, sampler, ray, active, medium_idx)
    for _ in range(max_iterations):
        if not any_lane(state.active):
            break
        state = _bounce(scene, state, **bkw)
    return state


def sample(scene, sampler: Sampler, ray: Ray, active=None, medium_idx=None):
    """Incident radiance along ``ray`` (on the ``active`` lanes, from
    ``medium_idx``; defaults: all lanes, the sensor's medium) -> (spec
    (N, nc), valid, sampler)."""
    final = _trace(scene, sampler, ray, active, medium_idx)
    return final.result, final.valid_ray, final.sampler


def sample_counted(scene, sampler: Sampler, ray: Ray, active=None,
                   medium_idx=None):
    """sample() and the number of rays traced, a 0-d tensor (the bench's
    ray count: every closest-hit query a lane issues, the NEE
    transmittance walks' included)."""
    final = _trace(scene, sampler, ray, active, medium_idx)
    return final.result, final.valid_ray, final.sampler, final.n_rays
