"""Integrator registry and the render drivers (integrators/__init__.py
counterpart): the scan driver ``render_wavefront`` and the regenerating
lane pool ``render_wavefront_regen``.

Sample index s -> pixel = s // spp, a jittered film position, a camera
ray, the integrator, and a row of [X, Y, Z, A, W] in the film. The scan
driver renders contiguous runs of samples per pass; the lane pool keeps a
fixed number of lanes busy, refilling each lane whose path ended with the
next unstarted sample. Both draw every sample from the same RNG stream, so
they render the same film up to the order of the film sums.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import sensors
from ..core.rng import Sampler
from ..core.spectrum import srgb_to_xyz
from ..films import N_BASE_CHANNELS, develop, film_put
from ..rfilters import filter_radius
from . import path, volpath

REGISTRY = {"path": path, "volpath": volpath}


def _camera_lanes(scene, seed, spp, sample):
    """The camera part of samples ``sample`` (int64 (N,)): seed -> jitter
    -> sensor ray. Returns (sampler, ray, ray weight, film position)."""
    cfg = scene.config
    H, W = cfg.film_height, cfg.film_width
    cw = cfg.crop_size[0] if cfg.crop_size else W
    cx, cy = cfg.crop_offset
    sampler, jitter = Sampler.seed(seed, sample).next_2d()
    pixel = sample // spp
    px = (pixel % cw).to(torch.float32) + cx
    py = (pixel // cw).to(torch.float32) + cy
    pos = torch.stack([px, py], dim=-1) + jitter
    pos_film = pos / torch.tensor([W, H], dtype=torch.float32,
                                  device=pos.device)
    ray, ray_weight, sampler = sensors.sample_ray(
        scene, sampler, pos_film, torch.zeros(sample.shape[0],
                                              device=pos.device))
    return sampler, ray, ray_weight, pos


def _film_rows(spec, valid):
    """[X, Y, Z, A, W] rows of finished samples."""
    one = torch.ones_like(spec[:, :1])
    return torch.cat([srgb_to_xyz(spec), torch.where(valid, 1.0, 0.0)[:, None],
                      one], dim=-1)


def render_wavefront(scene, lane_offset, n_lanes, seed, spp):
    """One pass of ``n_lanes`` samples from global sample index
    ``lane_offset``; returns the partial film (H, W, 5). Lanes beyond the
    film's sample count are masked out."""
    cfg = scene.config
    dev = scene.bsphere_center.device
    H, W = cfg.film_height, cfg.film_width
    cw, ch = cfg.crop_size if cfg.crop_size else (W, H)
    cx, cy = cfg.crop_offset
    total = ch * cw * spp

    lane = lane_offset + torch.arange(n_lanes, dtype=torch.int64, device=dev)
    lane_ok = lane < total
    sampler, ray, ray_weight, pos = _camera_lanes(
        scene, seed, spp, torch.clamp(lane, max=total - 1))
    spec, valid, sampler = REGISTRY[cfg.integrator.kind].sample(scene,
                                                                sampler, ray)
    values = torch.where(lane_ok[:, None], _film_rows(spec * ray_weight,
                                                      valid), 0.0)
    image = torch.zeros(ch, cw, N_BASE_CHANNELS, device=dev)
    offset = torch.tensor([cx, cy], dtype=torch.float32, device=dev)
    return film_put(image, pos - offset, values, cfg.rfilter,
                    dict(cfg.rfilter_params))


def _put_lanes(pool, fresh, idx):
    """``pool`` with lanes ``idx`` replaced by the lanes of ``fresh`` (same
    record type, len(idx) lanes), over every per-lane field; an int
    sampler counter of ``fresh`` fills its lanes."""
    if dataclasses.is_dataclass(pool):
        return type(pool)(**{
            f.name: _put_lanes(getattr(pool, f.name), getattr(fresh, f.name),
                               idx)
            for f in dataclasses.fields(pool)})
    if not isinstance(pool, torch.Tensor) or pool.ndim == 0:
        return pool  # per-wavefront scalars (the rays counter)
    if not isinstance(fresh, torch.Tensor):
        fresh = torch.full((idx.shape[0],), fresh, dtype=pool.dtype,
                           device=pool.device)
    return pool.index_copy(0, idx, fresh)


def _run_pool(scene, n_lanes, seed, spp, total, max_iterations, bounce,
              harvest=None, refill=None, stats=None):
    """The lane pool's schedule, shared by the render and its path-replay
    adjoint (integrators/replay.py): a pool of ``n_lanes`` lanes; each lane
    whose path finished is harvested and refilled with the next unstarted
    sample. Per iteration:

    1. ``harvest(vp, rw, slot)`` sees the pool; ``slot`` (n_lanes,) holds
       the sample index of each lane whose path ended since the last visit
       and ``total`` (a trash row) for the others;
    2. dead lanes take the next unstarted samples (camera ray, fresh
       integrator state); ``refill(ridx, new)`` is told which lanes took
       which samples;
    3. ``bounce(vp, occupied)`` runs one bounce over the whole pool (its
       unoccupied lanes inactive) and returns the new state.

    Returns the rays traced (a 0-d tensor). ``stats``, a dict, receives the
    loop iterations and the samples dropped by the runaway cap."""
    mod = REGISTRY[scene.config.integrator.kind]
    dev = scene.bsphere_center.device
    trash = torch.full((n_lanes,), total, dtype=torch.int64, device=dev)
    lane_sample = trash.clone()
    occupied = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    its = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    vp = rw = None
    rays = torch.zeros((), device=dev)
    next_sample = 0
    it = 0
    cap = 20 * max_iterations * (1 + total // n_lanes)
    while it < cap:
        # 1. harvest the lanes whose path ended since the last visit
        if vp is not None:
            finished = occupied & ~vp.active
            if harvest is not None:
                harvest(vp, rw, torch.where(finished, lane_sample, trash))
            occupied = occupied & vp.active

        # 2. refill dead lanes with the next unstarted samples
        n_dead = n_lanes - int(occupied.sum())  # host sync
        m = min(n_dead, total - next_sample)
        if m > 0:
            ridx = torch.nonzero(~occupied)[:m, 0]
            new = next_sample + torch.arange(m, dtype=torch.int64,
                                             device=dev)
            smp, ray, fresh_rw, _pos = _camera_lanes(scene, seed, spp, new)
            fresh = mod._init_state(scene, smp, ray)
            if vp is None:  # the first fill: every lane at once
                vp = dataclasses.replace(fresh, sampler=dataclasses.replace(
                    fresh.sampler, dim=torch.full(
                        (n_lanes,), fresh.sampler.dim, dtype=torch.int64,
                        device=dev)))
                rw = fresh_rw
            else:
                vp = _put_lanes(vp, fresh, ridx)
                rw = rw.index_copy(0, ridx, fresh_rw)
            lane_sample = lane_sample.index_copy(0, ridx, new)
            occupied = occupied.index_fill(0, ridx, True)
            its = its.index_fill(0, ridx, 0)
            next_sample += m
            if refill is not None:
                refill(ridx, new)
        if n_dead - m == n_lanes:  # nothing occupied, nothing left
            break

        # 3. one bounce over the whole (nearly full) pool
        vp = dataclasses.replace(vp, active=vp.active & occupied,
                                 n_rays=torch.zeros((), device=dev))
        vp = bounce(vp, occupied)
        rays = rays + vp.n_rays
        its = its + 1
        # the per-lane iteration cap (the scan driver's trip count)
        vp = dataclasses.replace(vp, active=vp.active
                                 & (its < max_iterations))
        it += 1
    if stats is not None:
        stats["iterations"] = it
        stats["dropped"] = (total - next_sample) + (
            int(occupied.sum()) if it >= cap else 0)
    return rays


def _check_regen(cfg):
    """Raise unless the lane pool can render this scene config."""
    if not regen_supported(cfg):
        raise NotImplementedError(
            f"the lane pool runs volpath; {cfg.integrator.kind!r} takes the "
            "scan driver (render(regen=False))")
    if filter_radius(cfg.rfilter, dict(cfg.rfilter_params)) > 0.5 + 1e-6:
        raise NotImplementedError(
            "the lane pool needs a single-pixel filter (radius <= 0.5)")


def render_wavefront_regen(scene, n_lanes, seed, spp, stats=None,
                           sample_log=False):
    """Regenerating wavefront render: the lane pool of ``_run_pool`` with
    ``n_lanes`` lanes keeps occupancy near 100 % whatever the spread of
    path lengths.

    The film is built from a per-sample slot buffer: a finished lane writes
    its [X, Y, Z, A, 1] row at slot ``sample`` (slots are unique, so the
    writes need no atomics and are deterministic); a reshape-sum over the
    spp axis gives the film at the end. Lanes may run in any order: a
    sample's random numbers are keyed by its index.

    Returns (film (ch, cw, 5), rays traced (a 0-d tensor)); with
    ``sample_log`` also the sample log (total, nc): row s is sample s's
    integrator ``result`` before the ray weight, written beside its film
    row (the path-replay backward's radiance totals). ``stats``, a dict,
    receives the loop iterations and the samples dropped by the runaway
    cap."""
    cfg = scene.config
    mod = REGISTRY[cfg.integrator.kind]
    _check_regen(cfg)
    dev = scene.bsphere_center.device
    cw, ch = cfg.crop_size if cfg.crop_size else (cfg.film_width,
                                                  cfg.film_height)
    total = ch * cw * spp
    n_lanes = min(n_lanes, total)
    max_iterations, bounce_kwargs = mod._knobs(scene)
    bounce_kwargs.update(mod._PRIMAL_BOUNCE_KWARGS)

    # slot `total` is the trash row of lanes that finished nothing
    slots = torch.zeros(total + 1, N_BASE_CHANNELS, device=dev)
    rlog = (torch.zeros(total + 1, cfg.variant.n_channels, device=dev)
            if sample_log else None)

    def harvest(vp, rw, slot):
        slots.index_copy_(0, slot, _film_rows(vp.result * rw, vp.valid_ray))
        if rlog is not None:
            rlog.index_copy_(0, slot, vp.result)

    rays = _run_pool(scene, n_lanes, seed, spp, total, max_iterations,
                     lambda vp, _occ: mod._bounce(scene, vp, **bounce_kwargs),
                     harvest=harvest, stats=stats)
    film = slots[:total].reshape(ch * cw, spp, N_BASE_CHANNELS).sum(1)
    film = film.reshape(ch, cw, N_BASE_CHANNELS)
    if sample_log:
        return film, rays, rlog[:total]
    return film, rays


def regen_supported(cfg) -> bool:
    """Whether the lane pool can run this integrator: it needs the bounce
    hooks (volpath has them; the port's path tracer takes the scan
    driver)."""
    mod = REGISTRY[cfg.integrator.kind]
    return all(hasattr(mod, h) for h in ("_init_state", "_bounce", "_knobs"))


def render(scene, seed=0, spp=None, samples_per_pass=None,
           develop_film=True, regen=False):
    """Multi-pass wavefront render, or with ``regen`` the lane pool of
    ``samples_per_pass`` lanes. Returns the developed image (H, W, 3), or
    the raw (H, W, 5) film with ``develop_film=False``. Both drivers are
    differentiable with respect to the scene's value-class tensors: the
    scan driver by autograd through its passes, the lane pool through the
    path-replay backward (integrators/replay.py)."""
    cfg = scene.config
    spp = spp or cfg.spp
    cw, ch = cfg.crop_size if cfg.crop_size else (cfg.film_width,
                                                  cfg.film_height)
    total = ch * cw * spp
    if samples_per_pass is None:
        samples_per_pass = min(total, 1 << 22)
    if regen and regen_supported(cfg):
        from . import replay

        if replay.replay_supported(cfg):
            # differentiable: the primal runs the same lane pool; under
            # autograd the backward is the path-replay adjoint sweep
            film = replay.render_regen_diff(scene, seed, samples_per_pass,
                                            spp)
        else:
            film, _rays = render_wavefront_regen(scene, samples_per_pass,
                                                 seed, spp)
    else:
        film = torch.zeros(ch, cw, N_BASE_CHANNELS,
                           device=scene.bsphere_center.device)
        for off in range(0, total, samples_per_pass):
            film += render_wavefront(scene, off, min(samples_per_pass,
                                                     total - off), seed, spp)
    if not develop_film:
        return film
    return develop(film, cfg.pixel_format)


__all__ = ["REGISTRY", "render", "render_wavefront",
           "render_wavefront_regen", "regen_supported"]
