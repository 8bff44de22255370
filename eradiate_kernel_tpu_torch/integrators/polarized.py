"""Polarized wavefront MIS path tracer (integrators/polarized.py
counterpart).

Mitsuba's ``*_polarized`` variants compile the same path tracer with
Spectrum = MuellerMatrix (path.cpp:100-227, interaction.h:275
to_world_mueller at every scattering event). Here the Mueller axis is
explicit: the throughput is a per-channel (N, nc, 4, 4) stack composed in
the implicit world-space Stokes bases, and the result an (N, nc, 4)
Stokes vector in the camera ray's basis (stokes_basis(-ray.d),
stokes.cpp:95).

At vertex k, hit by ray k, light leaves toward the camera along -ray_k.d;
the BSDF's Mueller matrix maps stokes_basis(-wo_world) to
stokes_basis(-ray_k.d), so the throughput composes by right
multiplication, and emitted light enters as a depolarized Stokes vector
(Mitsuba's emitters return unpolarized<Spectrum>). The polarimetry of each
scatterer comes from bsdfs.bsdf_eval_mueller and bsdf_sample_mueller.

The bounce drives the lane pool too (_init_state, _bounce, _knobs), the
sensor-basis rotation premultiplied into the initial throughput at refill
(polarized_vol's reason). Fresh lanes trace their camera ray at entry;
every bounce ends with the next vertex's intersection (its MIS weight
needs it). Depth counts scattering events only: optical elements and
null interfaces pass without using up path budget.
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
from .common import any_lane, mis_weight
from .polarized_vol import _sensor_basis_rotation, _stokes0
from .volpath import _gate, _shape_of


@dataclasses.dataclass(frozen=True)
class _PolPathState:
    sampler: Sampler
    ray: Ray
    si: SurfaceInteraction
    needs_intersection: torch.Tensor
    throughput_m: torch.Tensor     # (N, nc, 4, 4) Mueller toward the camera
    stokes: torch.Tensor           # (N, nc, 4) the accumulated Stokes vector
    eta: torch.Tensor
    emission_weight: torch.Tensor
    valid_ray: torch.Tensor
    active: torch.Tensor
    depth: torch.Tensor            # (N,) i32 non-null bounces
    n_rays: torch.Tensor           # () rays traced

    @property
    def result(self):
        """S0, the radiance (N, nc) the film splats."""
        return self.stokes[..., 0]


def _n_channels(scene, ray):
    """The lanes' channels: the variant's, or 4 hero wavelengths in
    spectral."""
    return scene.config.variant.channels(ray.wavelengths)


# the lane pool's bounce kwargs on top of _knobs': no site gates (its
# occupancy is near 100 %)
_PRIMAL_BOUNCE_KWARGS = {"gate_sites": False}


def _knobs(scene):
    """(max_iterations, bounce kwargs): the lane pool's contract. The
    iterations beyond max_depth cover the depth-free null and element
    crossings (an optical bench of up to 8 elements)."""
    cfg = scene.config.integrator
    return cfg.max_depth + 8, dict(max_depth=cfg.max_depth,
                                   rr_depth=cfg.rr_depth)


def _init_state(scene, sampler: Sampler, ray: Ray, active=None,
                premultiply_rotation=True):
    """A fresh Mueller lane state; for the lane pool the sensor-basis
    rotation (stokes.cpp:89-100) is premultiplied into the throughput."""
    n = ray.o.shape[0]
    dev = ray.o.device
    nc = _n_channels(scene, ray)
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    v0 = 0.0 * ray.o[:, 0]
    ok = v0 == 0.0
    if premultiply_rotation:
        tp0 = _sensor_basis_rotation(scene, ray)[:, None]
    else:
        tp0 = torch.eye(4, dtype=ray.o.dtype, device=dev)
    return _PolPathState(
        sampler=sampler, ray=ray,
        si=invalid_si(n, ray.wavelengths.shape[-1], ray.o.dtype, dev,
                      ray.wavelengths),
        needs_intersection=ok.clone(),
        throughput_m=tp0.expand(n, nc, 4, 4) + v0[:, None, None, None],
        stokes=ray.o.new_zeros(n, nc, 4), eta=ray.o.new_ones(n) + v0,
        emission_weight=ray.o.new_ones(n) + v0,
        valid_ray=torch.zeros(n, dtype=torch.bool, device=dev),
        active=active & ok,
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        n_rays=ray.o.new_zeros(()))


def _bounce(scene, s: _PolPathState, *, max_depth, rr_depth,
            gate_sites=True):
    """One masked wavefront bounce (path.cpp:100-227 under a polarized
    variant); the same random numbers in the same order on both
    drivers."""
    n = s.ray.o.shape[0]
    ca = _gate(gate_sites)
    # ---- the camera ray's intersection of freshly refilled lanes -----------
    do_isect = s.needs_intersection & s.active
    si = ca(do_isect,
            lambda: merge(ray_intersect(scene.geo, s.ray, do_isect), s.si,
                          do_isect),
            lambda: s.si)
    n_rays = s.n_rays + do_isect.sum()
    valid_ray = s.valid_ray | (do_isect & si.is_valid & (s.depth == 0))
    active = s.active

    # ---- emitter hit or environment: a depolarized source ------------------
    escaped = ~si.is_valid
    hide = scene.config.integrator.hide_emitters & (s.depth == 0)
    emit = emitters.eval_emitter_hit(scene, si, active & ~hide)
    emit = emit + emitters.eval_environment(scene, s.ray, escaped,
                                            active & ~hide)
    result = s.stokes + s.emission_weight[..., None, None] * \
        _stokes0(s.throughput_m, emit)

    active = active & si.is_valid & (s.depth + 1 < max_depth)

    # ---- russian roulette on the S0 gain (detached) -------------------------
    smp, rr_sample = s.sampler.next_1d()
    q = torch.clamp(torch.amax(s.throughput_m[..., 0, 0], dim=-1)
                    * s.eta ** 2, max=0.95).detach()
    do_rr = s.depth >= rr_depth
    throughput_m = torch.where(
        do_rr[..., None, None, None],
        s.throughput_m / torch.clamp(q, min=1e-6)[..., None, None, None],
        s.throughput_m)
    active = active & (~do_rr | (rr_sample < q))

    # ---- next-event estimation ----------------------------------------------
    smp, s_pick = smp.next_1d()
    smp, s1 = smp.next_1d()
    smp, s2 = smp.next_2d()
    bsdf_idx = scene.shape_bsdf[_shape_of(si)]
    is_smooth = (scene.bsdf_flags[bsdf_idx] & bsdf_flags.Smooth) != 0
    nee_active = active & is_smooth & (scene.config.n_emitters > 0)
    ds, emitter_weight = emitters.sample_emitter_direction(
        scene, si, s_pick, s1, s2, nee_active)
    bsdf_m, bsdf_pdf = bsdfs.bsdf_eval_mueller(scene, bsdf_idx, si,
                                               si.to_local(ds.d), nee_active)
    mis_pdf = torch.where(ds.delta, 0.0, bsdf_pdf)
    mis = torch.where(ds.pdf > 0, mis_weight(ds.pdf, mis_pdf), 0.0)
    result = result + torch.where(
        nee_active[..., None, None],
        mis[..., None, None] * _stokes0(throughput_m @ bsdf_m,
                                        emitter_weight), 0.0)

    # ---- BSDF sampling -------------------------------------------------------
    smp, sb1 = smp.next_1d()
    smp, sb2 = smp.next_2d()
    bs, weight_m = bsdfs.bsdf_sample_mueller(scene, bsdf_idx, si, sb1, sb2,
                                             active)
    throughput_m = throughput_m @ weight_m
    eta = s.eta * bs.eta
    active = active & (torch.amax(throughput_m[..., 0, 0], dim=-1) > 0) \
        & (bs.pdf > 0)
    null_event = (bs.sampled_type & bsdf_flags.Null) != 0

    wo_world = si.to_world(bs.wo)
    new_ray = si.spawn_ray(wo_world)
    si_next = ca(active,
                 lambda: merge(ray_intersect(scene.geo, new_ray, active), si,
                               active),
                 lambda: si)
    n_rays = n_rays + active.sum()

    delta_lobe = (bs.sampled_type & bsdf_flags.Delta) != 0
    em_pdf = emitters.pdf_emitter_direction(
        scene, si.p, si_next, ~si_next.is_valid, active & ~delta_lobe,
        d=wo_world)
    em_pdf = torch.where(delta_lobe, 0.0, em_pdf)
    emission_weight = mis_weight(bs.pdf, em_pdf)

    keep = lambda new, old: merge(new, old, active)
    return _PolPathState(
        sampler=smp,
        ray=Ray(o=keep(new_ray.o, s.ray.o), d=keep(new_ray.d, s.ray.d),
                mint=keep(new_ray.mint, s.ray.mint),
                maxt=keep(new_ray.maxt, s.ray.maxt), time=s.ray.time,
                wavelengths=s.ray.wavelengths),
        si=keep(si_next, si),
        needs_intersection=s.needs_intersection & ~do_isect,
        throughput_m=keep(throughput_m, s.throughput_m),
        stokes=result, eta=keep(eta, s.eta),
        emission_weight=keep(emission_weight, s.emission_weight),
        valid_ray=valid_ray, active=active,
        depth=s.depth + (active & ~null_event).to(torch.int32),
        n_rays=n_rays)


def sample_stokes(scene, sampler: Sampler, ray: Ray, active=None):
    """The polarized transport on the scan driver -> (stokes (N, nc, 4) in
    the RAY's implicit basis, valid, sampler); stokes[..., 0] is the
    radiance. The stokes wrapper applies the sensor-basis rotation. The
    bounces stop once every lane is dead (a bounce then changes only the
    sampler's counter, which nothing reads)."""
    max_iterations, bkw = _knobs(scene)
    state = _init_state(scene, sampler, ray, active,
                        premultiply_rotation=False)
    for _ in range(max_iterations):
        if not any_lane(state.active):
            break
        state = _bounce(scene, state, **bkw)
    return state.stokes, state.valid_ray, state.sampler
