"""Polarized volumetric path tracer, the Mueller-matrix volpath
(integrators/polarized_vol.py counterpart).

Mitsuba compiles volpath.cpp under its ``*_polarized`` variants with
Spectrum = MuellerMatrix: every scalar medium factor (the free-flight
ratio, the sigma_n and sigma_s products, the walked transmittance)
scales the Mueller throughput, phase values are scalar and surface BSDFs
contribute full Mueller matrices. Here the Mueller axis is explicit: the
throughput is an (N, nc, 4, 4) stack composed in the implicit world-space
Stokes bases (the convention of integrators/polarized.py and
bsdfs.bsdf_eval_mueller), and the result an (N, nc, 4) Stokes vector in
the camera ray's basis. ``rayleigh`` media scatter with the Rayleigh
matrix (phase.phase_mueller), beyond Mitsuba, as in the reference.

The bounce mirrors volpath._bounce site for site and draws the same
random numbers in the same order, so S0 equals volpath's radiance sample
for sample wherever every Mueller factor has the scalar [0, 0] entry.

The lane pool drives the bounce through the hooks _init_state, _bounce
and _knobs: the lane carries the Mueller throughput and the Stokes
vector, and the sensor-basis rotation (stokes.cpp:89-100) is
premultiplied into the initial throughput. The rotation is a constant
linear map of each lane, so the harvested vector is already in the
sensor's basis.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import bsdfs, emitters, media, phase
from ..bsdfs import common as bsdf_flags
from ..core import mueller as mu
from ..core.math import INVALID_T, cross
from ..core.ray import Ray
from ..core.rng import Sampler
from ..render.geometry import ray_intersect
from ..render.records import SurfaceInteraction, merge
from .common import any_lane, mis_weight
from .volpath import (_PRIMAL_BOUNCE_KWARGS, _all_emitters_delta,  # noqa: F401
                      _evaluate_direct_light, _gate, _index_ch,
                      _is_medium_transition, _knobs, _medium_phase,
                      _sample_emitter, _shape_of, _target_medium)
from .volpath import _init_state as _init_state_scalar


@dataclasses.dataclass(frozen=True)
class _PolVolState:
    sampler: Sampler
    ray: Ray
    si: SurfaceInteraction
    needs_intersection: torch.Tensor
    medium_idx: torch.Tensor
    throughput_m: torch.Tensor   # (N, nc, 4, 4) Mueller toward the camera
    stokes: torch.Tensor         # (N, nc, 4) the accumulated Stokes vector
    eta: torch.Tensor
    depth: torch.Tensor          # (N,) i32
    channel: torch.Tensor        # (N,) i32 hero channel
    specular_chain: torch.Tensor
    valid_ray: torch.Tensor
    active: torch.Tensor
    n_rays: torch.Tensor         # () rays traced

    @property
    def result(self):
        """S0, the radiance (N, nc) the film splats; every Stokes rotation
        has first row (1, 0, 0, 0), so it does not depend on the basis."""
        return self.stokes[..., 0]


def _sensor_basis_rotation(scene, ray):
    """The rotation from the ray's implicit Stokes basis to the sensor's
    (stokes.cpp:93-100: the target basis is cross(ray.d, sensor up))."""
    up = scene.sensor["to_world"].m[:3, 1].to(ray.d.dtype)
    target = cross(ray.d, up.expand(ray.d.shape))
    t_len = torch.linalg.norm(target, dim=-1, keepdim=True)
    current = mu.stokes_basis(-ray.d)
    target = torch.where(t_len > 1e-8, target / torch.clamp(t_len, min=1e-12),
                         current)
    return mu.rotate_stokes_basis(-ray.d, current, target)


def _stokes0(m, spec):
    """A Mueller stack applied to a depolarized source, m @ (spec, 0, 0, 0):
    m (N, nc, 4, 4), spec (N, nc) -> (N, nc, 4)."""
    return m[..., :, 0] * spec[..., None]


def _scale(m, f, mask):
    """A per-channel scalar factor f (N, nc) on the Mueller stack where
    ``mask`` (the polarization-preserving medium events)."""
    return torch.where(mask[..., None, None, None], m * f[..., None, None], m)


def _bounce(scene, s: _PolVolState, *, nee_steps, max_depth, rr_depth,
            while_walks=False, gate_sites=True, gate_walks=None):
    """One masked wavefront Mueller bounce (volpath.cpp:38-258 under a
    polarized variant), driven by the scan driver (``sample_stokes``) and
    the lane pool."""
    cfg = scene.config
    n = s.ray.o.shape[0]
    dev = s.ray.o.device
    nc = s.throughput_m.shape[-3]
    ca = _gate(gate_sites)
    ca_walk = _gate(gate_sites if gate_walks is None else gate_walks)
    smp = s.sampler
    tp_s0 = s.throughput_m[..., 0, 0]
    active = s.active & torch.any(tp_s0 != 0.0, dim=-1)
    ray = s.ray
    si = s.si

    # --- russian roulette on the S0 gain (volpath.cpp:79-87) ---------------
    q = torch.clamp(torch.amax(tp_s0, dim=-1) * s.eta ** 2, max=0.95)
    q = torch.clamp(q, min=1e-6).detach()
    perform_rr = s.depth > rr_depth
    smp, xi_rr = smp.next_1d()
    active = active & ((xi_rr < q) | ~perform_rr)
    throughput_m = torch.where(perform_rr[..., None, None, None],
                               s.throughput_m / q[..., None, None, None],
                               s.throughput_m)

    active_medium = active & (s.medium_idx >= 0)
    active_surface = active & ~active_medium

    # --- medium sampling (volpath.cpp:105-151) -----------------------------
    med = torch.clamp(s.medium_idx, min=0)
    smp, xi_m = smp.next_1d()
    mi = ca(active_medium,
            lambda: media.sample_interaction(scene, med, ray, xi_m, s.channel,
                                             active_medium),
            lambda: media.invalid_mi(n, nc, dev, ray.o.dtype))
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
    throughput_m = _scale(throughput_m, ratio, active_medium)

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
    throughput_m = _scale(throughput_m, mi.sigma_n * ext_ch[..., None]
                          / sn_den, sn_ok)
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
    throughput_m = _scale(throughput_m, mi.sigma_s * ext_ch[..., None]
                          / st_den, st_ok)
    valid_ray = s.valid_ray | act_scatter
    specular_chain = s.specular_chain & ~act_scatter

    phase_idx = _medium_phase(scene, s.medium_idx)
    nee_medium_p = mi.p
    nee_medium_d_in = ray.d  # the pre-phase-sample direction

    # phase sampling with the Mueller importance weight
    smp, xi_p1 = smp.next_1d()
    smp, xi_p2 = smp.next_2d()
    eye = torch.eye(4, dtype=ray.d.dtype, device=dev)
    wo_m, _ppdf, phase_w = ca(
        act_scatter,
        lambda: phase.phase_sample_mueller(scene, phase_idx, ray.d, xi_p1,
                                           xi_p2, act_scatter),
        lambda: (ray.d, ray.d.new_zeros(n), eye.expand(n, 4, 4)))
    throughput_m = torch.where(act_scatter[..., None, None, None],
                               throughput_m @ phase_w[:, None],
                               throughput_m)
    ray = Ray(o=torch.where(act_scatter[..., None], mi.p, ray.o),
              d=torch.where(act_scatter[..., None], wo_m, ray.d),
              mint=torch.where(act_scatter, 0.0, ray.mint),
              maxt=torch.where(act_scatter, INVALID_T, ray.maxt),
              time=ray.time, wavelengths=ray.wavelengths)
    needs_intersection = needs_intersection | act_scatter

    # --- surface interactions (volpath.cpp:180-252) ------------------------
    active_surface = active_surface | escaped_medium
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
    result = s.stokes + torch.where(use_emit[..., None, None],
                                    _stokes0(throughput_m, e_val), 0.0)

    active_surface = active_surface & si.is_valid
    bsdf_idx = scene.shape_bsdf[_shape_of(si)]
    is_smooth = (scene.bsdf_flags[bsdf_idx] & bsdf_flags.Smooth) != 0

    # merged NEE: the scalar walk gives emitted x transmittance; the
    # polarization enters through the vertex's scattering matrix
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
        phase_m = phase.phase_mueller(scene, phase_idx, -nee_medium_d_in,
                                      ds.d, act_scatter)
        delta_m = torch.where(act_scatter[..., None, None],
                              _stokes0(throughput_m @ phase_m[:, None],
                                       emitted), 0.0)
        bsdf_m, bsdf_pdf = bsdfs.bsdf_eval_mueller(
            scene, bsdf_idx, si, si.to_local(ds.d), active_e)
        mis_pdf = torch.where(ds.delta, 0.0, bsdf_pdf)
        w_nee = torch.where(ds.pdf > 0, mis_weight(ds.pdf, mis_pdf), 0.0)
        delta_s = torch.where(
            active_e[..., None, None],
            w_nee[..., None, None] * _stokes0(throughput_m @ bsdf_m,
                                              emitted), 0.0)
        return delta_m + delta_s, smp2, nr

    def nee_skip():
        # the stream stays aligned with the taken branch: 3 + nee_steps
        # dimensions (volpath._bounce)
        return (ray.o.new_zeros(n, nc, 4),
                dataclasses.replace(smp, dim=smp.dim + 3 + nee_steps),
                ray.o.new_zeros(()))

    nee_delta, smp, nr_s = ca(nee_active, nee_block, nee_skip)
    result = result + nee_delta
    n_rays = n_rays + nr_s

    # bsdf sampling with the Mueller importance weight
    smp, xb1 = smp.next_1d()
    smp, xb2 = smp.next_2d()

    def bsdf_skip():
        bs0, _w0 = bsdf_flags.zero_bsdf_sample(n, nc, dev, si.t.dtype)
        return bs0, si.t.new_zeros(n, nc, 4, 4)

    bs, weight_m = ca(
        active_surface,
        lambda: bsdfs.bsdf_sample_mueller(scene, bsdf_idx, si, xb1, xb2,
                                          active_surface),
        bsdf_skip)
    throughput_m = torch.where(active_surface[..., None, None, None],
                               throughput_m @ weight_m, throughput_m)
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
                   & torch.any(throughput_m[..., 0, 0] != 0, dim=-1)
                   & (depth < max_depth) & (cfg.n_emitters > 0))
    si_new = ca(active_surface,
                lambda: merge(ray_intersect(scene.geo, ray, active_surface),
                              si, active_surface),
                lambda: si)
    n_rays = n_rays + active_surface.sum()
    needs_intersection = needs_intersection & ~active_surface

    has_trans = active_surface & _is_medium_transition(scene, si)
    medium_next = torch.where(has_trans, _target_medium(scene, si, ray.d),
                              s.medium_idx)

    if not _all_emitters_delta(cfg):
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
            (add_emitter & (emitter_pdf > 0))[..., None, None],
            w_dir[..., None, None] * _stokes0(throughput_m, emitted_d), 0.0)

    return _PolVolState(
        sampler=smp, ray=ray, si=merge(si_new, si, active_surface),
        needs_intersection=needs_intersection, medium_idx=medium_next,
        throughput_m=throughput_m, stokes=result, eta=eta, depth=depth,
        channel=s.channel, specular_chain=specular_chain,
        valid_ray=valid_ray,
        active=active & (active_surface | active_medium), n_rays=n_rays)


def _state(base, throughput_m):
    """A Mueller lane state from volpath's scalar one."""
    n, nc = base.throughput.shape
    return _PolVolState(
        sampler=base.sampler, ray=base.ray, si=base.si,
        needs_intersection=base.needs_intersection,
        medium_idx=base.medium_idx,
        throughput_m=throughput_m + 0.0 * base.throughput[..., None, None],
        stokes=base.result.new_zeros(n, nc, 4), eta=base.eta,
        depth=base.depth, channel=base.channel,
        specular_chain=base.specular_chain, valid_ray=base.valid_ray,
        active=base.active, n_rays=base.n_rays)


def _init_state(scene, sampler: Sampler, ray: Ray, active=None,
                medium_idx=None):
    """A fresh Mueller lane state for the lane pool, the sensor-basis
    rotation (stokes.cpp:89-100) premultiplied into its throughput, so the
    accumulated Stokes vector is in the sensor's basis at harvest."""
    base = _init_state_scalar(scene, sampler, ray, active, medium_idx)
    rot = _sensor_basis_rotation(scene, ray)
    return _state(base, rot[:, None].expand(-1, base.throughput.shape[1], 4,
                                            4))


def sample_stokes(scene, sampler: Sampler, ray: Ray, active=None,
                  medium_idx=None):
    """The polarized volumetric transport on the scan driver -> (stokes
    (N, nc, 4) in the RAY's implicit basis, valid, sampler); the stokes
    wrapper applies the sensor-basis rotation. The bounces stop once every
    lane is dead, as volpath's do."""
    max_iterations, bkw = _knobs(scene)
    base = _init_state_scalar(scene, sampler, ray, active, medium_idx)
    eye = torch.eye(4, dtype=ray.o.dtype, device=ray.o.device)
    state = _state(base, eye.expand(*base.throughput.shape, 4, 4))
    for _ in range(max_iterations):
        if not any_lane(state.active):
            break
        state = _bounce(scene, state, **bkw)
    return state.stokes, state.valid_ray, state.sampler
