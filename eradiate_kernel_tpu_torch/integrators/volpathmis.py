"""Null-scattering volumetric path tracer with spectral MIS (integrators/
volpathmis.py counterpart; volpathmis.cpp as a masked wavefront program).

Where volpath divides by the hero channel's pdf at every event, this
integrator carries a weight matrix ``pf[i][j]`` (the product of the pdfs
had channel j driven the sampling, over the product of channel i's f)
along the path and updates it at every sampling event
(volpathmis.cpp:447-467 ``update_weights``: pf[i][j] *= p[j] / f[i],
non-finite entries scrubbed to 0). A contribution is weighted by the
balance heuristic over the channel strategies (volpathmis.cpp:469-499):

    one strategy:   w[i] = n / sum_j pf[i][j]
    two strategies: w[i] = n / sum_j (pf1 + pf2)[i][j]

The events update it as the reference does:
  RR                   pf      *= (q, 1)                       (:140)
  free flight          pf, nee *= (ff_pdf, tr)                 (:177-178)
  null collision       pf *= (sigma_n / ce, sigma_n); nee *= (1, sigma_n)
  real scatter         pf *= (sigma_t / ce, sigma_s); nee reset to pf
  phase sample         pf *= (p, p); nee *= (1, p)             (:247-248)
  bsdf sample          nee reset to pf (non-null); pf *= (pdf, f);
                       nee *= (1, f)                           (:317-319)
  emitter hit          nee *= (emitter_pdf, 1); contribution mis(pf) or
                       mis(pf, nee)                            (:272-276)
  NEE walk             nee' = pf * (ds.pdf, 1), uni' = pf; the walk
                       updates both; at its end nee' *= (1, f),
                       uni' *= (p_competing, f); contribution
                       mis(nee', uni') * emitted      (:229-233, :289-295)

In spectral the matrix is over the 4 hero wavelengths of the lane's ray
(volpathmis.cpp's spectral weights), which every ray of the path carries.

The NEE walk is a fixed trip of ``nee_steps`` ratio-tracking steps, each
one closest-hit query (the reference's two masked intersections of a
step serve disjoint lanes on the same rays, so one query answers both)
and one free-flight draw; it may end early once every lane is done, with
the sampler pinned where the full trip leaves it (volpath._run_walk).
The bounce's sites are gated as volpath's are (``gate_sites``,
``gate_walks``); every draw happens outside the gates, so a skipped site
leaves the sample stream where the taken one would.

Detach discipline: the reference's two stop_gradient sites, the RR
probability (ref :309) and the real-collision probability (ref :349),
are ``.detach()``; the preliminary intersection and the media's
majorants arrive detached. Gradients go through the scan driver; the
lane pool has no backward for this integrator (no path replay), as the
reference's while loop has none.
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
from .common import any_lane
from .volpath import (_RefPoint, _WalkHit, _eval_null_transmission, _gate,
                      _index_ch, _invalid_walk_hit, _is_medium_transition,
                      _medium_phase, _run_walk, _shape_of, _target_medium,
                      _walk_hit)


def _update(pf, p, f, active):
    """pf[i][j] *= p[j] / f[i] on the active lanes (update_weights)."""
    ratio = p[..., None, :] / f[..., :, None]
    ratio = torch.where(torch.isfinite(ratio), ratio, 0.0)
    out = pf * ratio
    out = torch.where(torch.isfinite(out), out, 0.0)
    return torch.where(active[..., None, None], out, pf)


def _bcast(x, nc):
    """A per-lane scalar (N,) -> an (N, nc) spectrum."""
    return x[..., None].expand(*x.shape, nc)


def _balance(s, nc):
    """n / s, 0 where s is 0. A true division (a Python number over a
    tensor is its reciprocal times the number in torch)."""
    return torch.where(s == 0, 0.0, s.new_full((), float(nc))
                       / torch.where(s == 0, 1.0, s))


def _mis1(pf):
    return _balance(torch.sum(pf, dim=-1), pf.shape[-1])


def _mis2(pf1, pf2):
    return _balance(torch.sum(pf1 + pf2, dim=-1), pf1.shape[-1])


# =============================================================================
# NEE with the matrix-carrying transmittance walk (volpathmis.cpp:332-444)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class _WalkState:
    sampler: Sampler
    ray: Ray
    si: _WalkHit
    needs_intersection: torch.Tensor
    medium_idx: torch.Tensor
    pf_nee: torch.Tensor
    pf_uni: torch.Tensor
    total_dist: torch.Tensor
    active: torch.Tensor
    n_rays: torch.Tensor  # () rays traced


def _walk_step(scene, s, ds, channel, ca):
    """One ratio-tracking step of the NEE walk (volpathmis.cpp:360-444): a
    free flight to a null collision, or through the segment to the surface
    bounding it (null transmission, a medium transition), updating both
    weight matrices."""
    n = s.ray.o.shape[0]
    nc = s.pf_nee.shape[-1]
    remaining = torch.clamp(ds.dist * (1.0 - 1e-4) - s.total_dist, 0.0,
                            INVALID_T)
    ray = dataclasses.replace(s.ray, maxt=remaining)
    active = s.active & (remaining > 0)
    active_medium = active & (s.medium_idx >= 0)
    active_surface = active & ~active_medium

    med = torch.clamp(s.medium_idx, min=0)
    smp, xi = s.sampler.next_1d()
    mi = ca(active_medium,
            lambda: media.sample_interaction(scene, med, ray, xi, channel,
                                             active_medium),
            lambda: media.invalid_mi(n, nc, ray.o.device, ray.o.dtype))
    # the medium lanes' and the surface lanes' queries of the reference are
    # on the same (unmoved) rays: one query serves both
    do_isect = s.needs_intersection & active
    si = ca(do_isect,
            lambda: merge(_walk_hit(ray_intersect(scene.geo, ray, do_isect)),
                          s.si, do_isect),
            lambda: s.si)
    needs_intersection = s.needs_intersection & ~do_isect
    n_rays = s.n_rays + do_isect.sum()
    mi = dataclasses.replace(mi, t=torch.where(
        active_medium & (si.t < mi.t), INVALID_T, mi.t))

    # free-flight transmittance (volpathmis.cpp:370-381)
    tr, ff_pdf = media.eval_tr_and_pdf(mi, torch.minimum(si.t, remaining))
    pf_nee = _update(s.pf_nee, ff_pdf, tr, active_medium)
    pf_uni = _update(s.pf_uni, ff_pdf, tr, active_medium)

    total_dist = torch.where(active_medium & (mi.t > remaining)
                             & mi.is_valid, ds.dist, s.total_dist)
    mi = dataclasses.replace(mi, t=torch.where(
        active_medium & (mi.t > remaining), INVALID_T, mi.t))
    escaped_medium = active_medium & ~mi.is_valid
    active_medium = active_medium & mi.is_valid
    total_dist = torch.where(active_medium, total_dist + mi.t, total_dist)

    # null collision (volpathmis.cpp:400-401)
    pf_nee = _update(pf_nee, torch.ones_like(mi.sigma_n), mi.sigma_n,
                     active_medium)
    pf_uni = _update(pf_uni, mi.sigma_n / torch.clamp(mi.combined_extinction,
                                                      min=1e-20),
                     mi.sigma_n, active_medium)
    ray = dataclasses.replace(
        ray, o=torch.where(active_medium[..., None], mi.p, ray.o),
        mint=torch.where(active_medium, 0.0, ray.mint))
    si = dataclasses.replace(si, t=torch.where(active_medium, si.t - mi.t,
                                               si.t))

    active_surface = active_surface | escaped_medium
    total_dist = torch.where(active_surface, total_dist + si.t, total_dist)
    active_surface = active_surface & si.is_valid & active & ~active_medium
    null_tr = _eval_null_transmission(scene, si, active_surface, nc)
    pf_nee = _update(pf_nee, torch.ones_like(null_tr), null_tr,
                     active_surface)
    pf_uni = _update(pf_uni, torch.ones_like(null_tr), null_tr,
                     active_surface)

    ray = Ray(o=torch.where(active_surface[..., None],
                            si.offset_origin(ray.d), ray.o),
              d=ray.d, mint=torch.where(active_surface, 0.0, ray.mint),
              maxt=remaining, time=ray.time, wavelengths=ray.wavelengths)
    alive = (torch.any(_mis1(pf_uni) != 0, dim=-1)
             | torch.any(torch.sum(pf_nee, dim=-1) != 0, dim=-1))
    has_trans = active_surface & _is_medium_transition(scene, si)
    return _WalkState(
        sampler=smp, ray=ray, si=si,
        needs_intersection=needs_intersection | active_surface,
        medium_idx=torch.where(has_trans, _target_medium(scene, si, ray.d),
                               s.medium_idx),
        pf_nee=pf_nee, pf_uni=pf_uni, total_dist=total_dist,
        active=(active_medium | active_surface) & alive, n_rays=n_rays)


def _sample_emitter_mis(scene, ref_p, ref_n, is_medium_ref, wavelengths, time,
                        medium_idx, channel, sampler, pf, active, nee_steps,
                        use_while, ca):
    """Emitter sampling with the matrix-carrying walk -> (pf_nee at the
    walk's end, pf_uni at the walk's end, the raw emitted radiance (N, nc),
    ds, sampler, rays traced)."""
    n = ref_p.shape[0]
    dev = ref_p.device
    nc = pf.shape[-1]
    sampler, s_pick = sampler.next_1d()
    sampler, s1 = sampler.next_1d()
    sampler, s2 = sampler.next_2d()
    ds, emitter_val = emitters.sample_emitter_direction(
        scene, _RefPoint(p=ref_p, t=ref_p.new_zeros(n),
                         wavelengths=wavelengths),
        s_pick, s1, s2, active, test_visibility=False)
    active = active & (ds.pdf > 0)
    # the samplers return value / pdf; the pdf enters through the weight
    # matrix instead (volpathmis.cpp:340)
    emitter_val = torch.where(active[..., None],
                              emitter_val * ds.pdf[..., None], 0.0)
    ones = ref_p.new_ones(n, nc)
    pf_nee = _update(pf, _bcast(ds.pdf, nc), ones, active)

    # connection ray; a medium reference starts in the medium
    eps_n = torch.where(is_medium_ref[..., None], 0.0, 1.0)
    scale = 1.0 + torch.amax(torch.abs(ref_p), dim=-1)
    sgn = torch.where(dot(ref_n, ds.d) >= 0, 1.0, -1.0)
    o = ref_p + eps_n * (RayEpsilon * scale * sgn)[..., None] * ref_n
    ray = Ray(o=o, d=ds.d, mint=o.new_zeros(n),
              maxt=o.new_full((n,), INVALID_T), time=time,
              wavelengths=wavelengths)
    state = _WalkState(
        sampler=sampler, ray=ray,
        si=_invalid_walk_hit(n, dev, ray.wavelengths, o.dtype),
        needs_intersection=torch.ones(n, dtype=torch.bool, device=dev),
        medium_idx=medium_idx, pf_nee=pf_nee, pf_uni=pf,
        total_dist=o.new_zeros(n), active=active,
        n_rays=o.new_zeros(()))
    final = _run_walk(lambda st: _walk_step(scene, st, ds, channel, ca),
                      state, nee_steps, use_while)
    # lanes still walking after the cap contribute nothing
    emitter_val = torch.where(final.active[..., None], 0.0, emitter_val)
    return (final.pf_nee, final.pf_uni, emitter_val, ds, final.sampler,
            final.n_rays)


# =============================================================================
# the main loop (volpathmis.cpp:100-330)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class _State:
    sampler: Sampler
    ray: Ray
    si: SurfaceInteraction
    needs_intersection: torch.Tensor
    medium_idx: torch.Tensor
    pf: torch.Tensor             # (N, nc, nc)
    pf_nee: torch.Tensor         # (N, nc, nc)
    result: torch.Tensor
    eta: torch.Tensor
    depth: torch.Tensor          # (N,) i32
    channel: torch.Tensor        # (N,) i32 driving channel
    specular_chain: torch.Tensor
    last_scatter_p: torch.Tensor  # (N, 3) the last real scatter vertex
    valid_ray: torch.Tensor
    active: torch.Tensor
    n_rays: torch.Tensor         # () rays traced


def _bounce(scene, s: _State, *, nee_steps, max_depth, rr_depth,
            while_walks=False, gate_sites=True, gate_walks=None):
    """One masked wavefront bounce (volpathmis.cpp:134-330), driven by the
    scan driver (``sample``) and the lane pool."""
    cfg = scene.config
    n = s.ray.o.shape[0]
    dev = s.ray.o.device
    nc = s.result.shape[-1]
    ca = _gate(gate_sites)
    ca_walk = _gate(gate_sites if gate_walks is None else gate_walks)
    ones = s.ray.o.new_ones(n, nc)
    smp = s.sampler
    active = s.active
    ray = s.ray
    si = s.si
    pf = s.pf
    pf_nee = s.pf_nee

    # --- russian roulette (:134-146) ----------------------------------------
    q = torch.clamp(torch.clamp(torch.amax(_mis1(pf), dim=-1) * s.eta ** 2,
                                max=0.95), 0.05, 1.0).detach()
    perform_rr = s.depth > rr_depth
    smp, xi_rr = smp.next_1d()
    active = active & ((xi_rr < q) | ~perform_rr)
    pf = _update(pf, _bcast(q, nc), ones, active & perform_rr)
    active = active & torch.any(_mis1(pf) != 0, dim=-1)

    active_medium = active & (s.medium_idx >= 0)
    active_surface = active & ~active_medium

    # --- medium sampling (:160-220); one query serves the (disjoint)
    # medium and surface lanes ------------------------------------------------
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
    needs_intersection = s.needs_intersection & ~do_isect
    n_rays = s.n_rays + do_isect.sum()
    mi = dataclasses.replace(mi, t=torch.where(
        active_medium & (si.t < mi.t), INVALID_T, mi.t))

    tr, ff_pdf = media.eval_tr_and_pdf(mi, si.t)
    pf = _update(pf, ff_pdf, tr, active_medium)
    pf_nee = _update(pf_nee, ff_pdf, tr, active_medium)

    escaped_medium = active_medium & ~mi.is_valid
    active_medium = active_medium & mi.is_valid

    smp, xi_n = smp.next_1d()
    p_real = (_index_ch(mi.sigma_t, s.channel)
              / torch.clamp(_index_ch(mi.combined_extinction, s.channel),
                            min=1e-20)).detach()
    null_scatter = xi_n >= p_real
    act_null = null_scatter & active_medium
    act_scatter = ~null_scatter & active_medium

    ce = torch.clamp(mi.combined_extinction, min=1e-20)
    pf = _update(pf, mi.sigma_n / ce, mi.sigma_n, act_null)
    pf_nee = _update(pf_nee, torch.ones_like(mi.sigma_n), mi.sigma_n,
                     act_null)
    pf = _update(pf, mi.sigma_t / ce, mi.sigma_s, act_scatter)

    depth = s.depth + act_scatter.to(torch.int32)
    active = active & (depth < max_depth)
    act_scatter = act_scatter & active

    ray = dataclasses.replace(
        ray, o=torch.where(act_null[..., None], mi.p, ray.o),
        mint=torch.where(act_null, 0.0, ray.mint))
    si = dataclasses.replace(si, t=torch.where(act_null, si.t - mi.t, si.t))

    valid_ray = s.valid_ray | act_scatter
    specular_chain = s.specular_chain & ~act_scatter
    last_scatter_p = torch.where(act_scatter[..., None], mi.p,
                                 s.last_scatter_p)
    # a real scatter resets the NEE matrix (:237)
    pf_nee = torch.where(act_scatter[..., None, None], pf, pf_nee)
    phase_idx = _medium_phase(scene, s.medium_idx)

    def medium_nee():
        """The medium NEE (:226-233) -> (contribution, sampler, rays)."""
        pf_n, pf_u, emitted, ds, smp2, nr = _sample_emitter_mis(
            scene, mi.p, -ray.d, torch.ones_like(act_scatter),
            ray.wavelengths, ray.time, s.medium_idx, s.channel, smp, pf,
            act_scatter, nee_steps, while_walks, ca_walk)
        pv = _bcast(phase.phase_eval(scene, phase_idx, -ray.d, ds.d,
                                     act_scatter), nc)
        pf_n = _update(pf_n, torch.ones_like(pv), pv, act_scatter)
        pf_u = _update(pf_u, torch.where(ds.delta[..., None], 0.0, pv), pv,
                       act_scatter)
        return (torch.where(act_scatter[..., None],
                            _mis2(pf_n, pf_u) * emitted, 0.0), smp2, nr)

    def nee_skip(smp0):
        # the walk draws 3 + nee_steps dimensions (pick, s1, s2, one a step)
        return lambda: (ray.o.new_zeros(n, nc),
                        dataclasses.replace(smp0, dim=smp0.dim + 3
                                            + nee_steps),
                        ray.o.new_zeros(()))

    delta, smp, nr = ca(act_scatter, medium_nee, nee_skip(smp))
    result = s.result + delta
    n_rays = n_rays + nr

    # phase sampling (:240-248)
    smp, xi_p1 = smp.next_1d()
    smp, xi_p2 = smp.next_2d()
    wo_m, ppdf = ca(act_scatter,
                    lambda: phase.phase_sample(scene, phase_idx, ray.d, xi_p1,
                                               xi_p2, act_scatter),
                    lambda: (ray.d, ray.d.new_zeros(n)))
    pp = _bcast(ppdf, nc)
    pf = _update(pf, pp, pp, act_scatter)
    pf_nee = _update(pf_nee, torch.ones_like(pp), pp, act_scatter)
    ray = Ray(o=torch.where(act_scatter[..., None], mi.p, ray.o),
              d=torch.where(act_scatter[..., None], wo_m, ray.d),
              mint=torch.where(act_scatter, 0.0, ray.mint),
              maxt=torch.where(act_scatter, INVALID_T, ray.maxt),
              time=ray.time, wavelengths=ray.wavelengths)
    needs_intersection = needs_intersection | act_scatter

    # --- surfaces (:255-330; si fresh from the merged query) -----------------
    active_surface = active_surface | escaped_medium
    # emitter hits count at every bounce and the MIS weights absorb the
    # NEE overlap (:262-276); a camera ray or a purely specular chain takes
    # the single-strategy weight
    em_idx = scene.shape_emitter[_shape_of(si)]
    hit_area = active_surface & si.is_valid & (em_idx >= 0)
    hit_env = active_surface & ~si.is_valid & (cfg.env_emitter >= 0)
    active_e = hit_area | hit_env
    if cfg.integrator.hide_emitters:
        active_e = active_e & (s.depth > 0)
    count_direct = (s.depth == 0) | specular_chain

    def emitter_hit():
        e_val = (emitters.eval_emitter_hit(scene, si, active_e & hit_area)
                 + emitters.eval_environment(scene, ray, ~si.is_valid,
                                             active_e & hit_env))
        mis_e = active_e & ~count_direct
        epdf = emitters.pdf_emitter_direction(scene, last_scatter_p, si,
                                              ~si.is_valid, mis_e, d=ray.d)
        pf_nee_hit = _update(pf_nee, _bcast(epdf, nc), ones, mis_e)
        contrib = torch.where(count_direct[..., None], _mis1(pf) * e_val,
                              _mis2(pf, pf_nee_hit) * e_val)
        return torch.where(active_e[..., None], contrib, 0.0)

    result = result + ca(active_e, emitter_hit,
                         lambda: ray.o.new_zeros(n, nc))

    active_surface = active_surface & si.is_valid
    bsdf_idx = scene.shape_bsdf[_shape_of(si)]
    is_smooth = (scene.bsdf_flags[bsdf_idx] & bsdf_flags.Smooth) != 0

    # surface NEE (:285-295)
    active_ne = active_surface & is_smooth & (depth + 1 < max_depth) & \
        (cfg.n_emitters > 0)

    def surface_nee():
        pf_n, pf_u, emitted, ds, smp2, nr = _sample_emitter_mis(
            scene, si.p, si.n, torch.zeros_like(active_ne),
            ray.wavelengths, ray.time, s.medium_idx, s.channel, smp, pf,
            active_ne, nee_steps, while_walks, ca_walk)
        bsdf_val, bsdf_pdf = bsdfs.bsdf_eval_pdf(scene, bsdf_idx, si,
                                                 si.to_local(ds.d), active_ne)
        pf_n = _update(pf_n, torch.ones_like(bsdf_val), bsdf_val, active_ne)
        pf_u = _update(pf_u, torch.where(ds.delta[..., None], 0.0,
                                         _bcast(bsdf_pdf, nc)),
                       bsdf_val, active_ne)
        return (torch.where(active_ne[..., None],
                            _mis2(pf_n, pf_u) * emitted, 0.0), smp2, nr)

    delta, smp, nr = ca(active_ne, surface_nee, nee_skip(smp))
    result = result + delta
    n_rays = n_rays + nr

    # bsdf sampling (:300-319)
    smp, xb1 = smp.next_1d()
    smp, xb2 = smp.next_2d()
    bs, bsdf_weight = ca(
        active_surface,
        lambda: bsdfs.bsdf_sample(scene, bsdf_idx, si, xb1, xb2,
                                  active_surface),
        lambda: bsdf_flags.zero_bsdf_sample(n, nc, dev, si.t.dtype))
    f_bsdf = bsdf_weight * torch.clamp(bs.pdf[..., None], min=1e-20)

    sampled_null = (bs.sampled_type & bsdf_flags.Null) != 0
    sampled_delta = (bs.sampled_type & bsdf_flags.Delta) != 0
    non_null = active_surface & ~sampled_null
    pf_nee = torch.where(non_null[..., None, None], pf, pf_nee)
    pf = _update(pf, _bcast(bs.pdf, nc), f_bsdf, active_surface)
    pf_nee = _update(pf_nee, ones, f_bsdf, non_null)

    depth = depth + non_null.to(torch.int32)
    valid_ray = valid_ray | non_null
    last_scatter_p = torch.where(non_null[..., None], si.p, last_scatter_p)
    specular_chain = (specular_chain | (non_null & sampled_delta)) & ~(
        active_surface & ((bs.sampled_type & bsdf_flags.Smooth) != 0))

    new_ray = si.spawn_ray(si.to_world(bs.wo))
    ray = Ray(o=torch.where(active_surface[..., None], new_ray.o, ray.o),
              d=torch.where(active_surface[..., None], new_ray.d, ray.d),
              mint=torch.where(active_surface, new_ray.mint, ray.mint),
              maxt=torch.where(active_surface, INVALID_T, ray.maxt),
              time=ray.time, wavelengths=ray.wavelengths)
    needs_intersection = needs_intersection | active_surface
    eta = torch.where(active_surface, s.eta * bs.eta, s.eta)

    has_trans = active_surface & _is_medium_transition(scene, si)
    medium_next = torch.where(has_trans, _target_medium(scene, si, ray.d),
                              s.medium_idx)
    active = (active & (active_surface | active_medium)
              & torch.any(_mis1(pf) != 0, dim=-1))
    return _State(
        sampler=smp, ray=ray, si=si, needs_intersection=needs_intersection,
        medium_idx=medium_next, pf=pf, pf_nee=pf_nee, result=result,
        eta=eta, depth=depth, channel=s.channel,
        specular_chain=specular_chain, last_scatter_p=last_scatter_p,
        valid_ray=valid_ray, active=active, n_rays=n_rays)


# bounce kwargs the regenerating (primal) driver adds to _knobs': walks end
# early; the bounce-level gates are off (occupancy near 100 %), the walk
# gates on. No _REPLAY_OK: the pool has no backward for this integrator.
_PRIMAL_BOUNCE_KWARGS = {"while_walks": True, "gate_sites": False,
                         "gate_walks": True}


def _knobs(scene):
    """(max_iterations, bounce kwargs): the lane pool's contract."""
    cfg = scene.config.integrator
    extra = dict(cfg.extra)
    max_iterations = int(extra.get("max_iterations", cfg.max_depth + 8))
    return max_iterations, dict(nee_steps=int(extra.get("nee_steps", 8)),
                                max_depth=cfg.max_depth,
                                rr_depth=cfg.rr_depth)


def _init_state(scene, sampler: Sampler, ray: Ray, active=None,
                medium_idx=None):
    """Fresh per-lane path state (the pre-loop part of
    volpathmis.cpp:100-133)."""
    cfg = scene.config
    n = ray.o.shape[0]
    dev = ray.o.device
    nc = cfg.variant.channels(ray.wavelengths)
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    v0 = 0.0 * ray.o[:, 0]
    ok = v0 == 0.0
    active = active & ok
    # the balance heuristic over the channel strategies assumes the
    # driving channel is drawn uniformly (one-sample MIS): rgb draws it,
    # mono has one channel and draws nothing, and spectral keeps channel 0
    # (hero wavelengths are already exchangeable)
    if cfg.variant.mode == "rgb":
        sampler, cs = sampler.next_1d()
        channel = torch.clamp((cs * 3).to(torch.int32), max=2)
    else:
        channel = torch.zeros(n, dtype=torch.int32, device=dev)
    hide = cfg.integrator.hide_emitters
    ones = ray.o.new_ones(n, nc, nc) + v0[:, None, None]
    return _State(
        sampler=sampler, ray=ray,
        si=invalid_si(n, ray.wavelengths.shape[-1], ray.o.dtype, dev,
                      ray.wavelengths),
        needs_intersection=ok.clone(),
        medium_idx=(torch.full((n,), cfg.sensor_medium, dtype=torch.int32,
                               device=dev) if medium_idx is None
                    else medium_idx.to(torch.int32)),
        pf=ones, pf_nee=ones.clone(), result=ray.o.new_zeros(n, nc),
        eta=ray.o.new_ones(n) + v0,
        depth=torch.zeros(n, dtype=torch.int32, device=dev), channel=channel,
        specular_chain=active & (not hide),
        last_scatter_p=ray.o,
        valid_ray=torch.full((n,), (not hide) and cfg.env_emitter >= 0,
                             dtype=torch.bool, device=dev) & ok,
        active=active, n_rays=ray.o.new_zeros(()))


def _trace(scene, sampler: Sampler, ray: Ray, active=None, medium_idx=None):
    """The scan driver's trace: up to max_iterations bounces; stops once
    every lane is dead (a bounce then changes only the sampler's
    counter)."""
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
