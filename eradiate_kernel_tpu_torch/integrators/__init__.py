"""Integrator registry and the render drivers (integrators/__init__.py
counterpart): the scan driver ``render_wavefront`` and the regenerating
lane pool ``render_wavefront_regen``.

Sample index s -> pixel = s // spp, a jittered film position, a camera
ray, the integrator, and a row of [X, Y, Z, A, W] in the film, then the
wrapper integrators' AOV channels (aov, moment: ``n_aov`` of them). The scan
driver renders contiguous runs of samples per pass; the lane pool keeps a
fixed number of lanes busy, refilling each lane whose path ended with the
next unstarted sample. Both draw every sample from the same RNG stream, so
they render the same film up to the order of the film sums. A mono film
holds the one radiance channel in each of X, Y and Z (the reference's
layout); rgb converts to XYZ; spectral takes the hero-wavelength
estimator of XYZ at the camera ray's wavelengths (the lane pool carries
them in the lane's ray).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import sensors
from ..core.rng import Sampler
from ..films import N_BASE_CHANNELS, develop, film_put
from ..rfilters import filter_radius
from ..utils.runtime import scoped_phase
from . import (aov, common, depth, direct, moment, path, stokes, volpath,
               volpathmis)
from .bins import bins, nbins

REGISTRY = {"path": path, "direct": direct, "depth": depth,
            "volpath": volpath, "volpathmis": volpathmis, "aov": aov,
            "moment": moment, "stokes": stokes, "bins": bins,
            "nbins": nbins}


def register_integrator(name, module):
    """Register a user integrator ``name``: ``module`` is any namespace
    with ``sample(scene, sampler, ray, active=None) -> (spec (N, nc),
    valid (N,), sampler)``, which the scan driver runs; the lane pool
    runs only integrators with the bounce hooks of path.py."""
    REGISTRY[name] = module


def n_aov(cfg):
    """The number of AOV channels the integrator adds after the film's 5."""
    mod = REGISTRY[cfg.integrator.kind]
    return mod.n_aov(cfg) if hasattr(mod, "n_aov") else 0


def aov_names(cfg):
    mod = REGISTRY[cfg.integrator.kind]
    return mod.aov_names(cfg) if hasattr(mod, "aov_names") else []


def _bounce_module(cfg):
    """The module whose bounce hooks the lane pool drives: a wrapper's
    child, else the integrator itself."""
    mod = REGISTRY[cfg.integrator.kind]
    return mod._regen_module(cfg) if hasattr(mod, "_regen_module") else mod


def _needs_differentials(cfg):
    """Whether the AOV spec asks for the offset camera rays (duv AOVs)."""
    mod = REGISTRY[cfg.integrator.kind]
    return bool(n_aov(cfg)) and getattr(mod, "needs_differentials",
                                        lambda _cfg: False)(cfg)


def _camera_lanes(scene, seed, spp, sample, differentials=False):
    """The camera part of samples ``sample`` (int64 (N,)): seed -> jitter
    -> sensor ray. Returns (sampler, ray, ray weight, film position); with
    ``differentials`` also the ray differentials, scaled by 1/sqrt(spp)
    (integrator.cpp:257-261)."""
    cfg = scene.config
    H, W = cfg.film_height, cfg.film_width
    cw = cfg.crop_size[0] if cfg.crop_size else W
    cx, cy = cfg.crop_offset
    sampler, jitter = Sampler.seed(seed, sample, kind=cfg.sampler_kind,
                                   spp=spp).next_2d()
    pixel = sample // spp
    px = (pixel % cw).to(torch.float32) + cx
    py = (pixel // cw).to(torch.float32) + cy
    pos = torch.stack([px, py], dim=-1) + jitter
    pos_film = pos / torch.tensor([W, H], dtype=torch.float32,
                                  device=pos.device)
    time = torch.zeros(sample.shape[0], dtype=cfg.variant.dtype,
                       device=pos.device)
    if differentials:
        ray, rd, ray_weight, sampler = sensors.sample_ray_differential(
            scene, sampler, pos_film, time, diff_scale=1.0 / math.sqrt(spp))
        return sampler, ray, ray_weight, pos, rd
    ray, ray_weight, sampler = sensors.sample_ray(scene, sampler, pos_film,
                                                  time)
    return sampler, ray, ray_weight, pos


def _film_rows(spec, valid, wavelengths=None):
    """[X, Y, Z, A, W] rows of finished samples: spectral (N, nw) by the
    hero-wavelength estimator at ``wavelengths``, rgb (N, 3) converts to
    XYZ, mono (N, 1) repeats into X, Y and Z."""
    one = torch.ones_like(spec[:, :1])
    return torch.cat([common.spec_to_xyz(spec, wavelengths),
                      torch.where(valid, 1.0, 0.0)[:, None], one], dim=-1)


@scoped_phase("ert::pass")
def render_wavefront(scene, lane_offset, n_lanes, seed, spp):
    """One pass of ``n_lanes`` samples from global sample index
    ``lane_offset``; returns the partial film (H, W, 5 + n_aov). Lanes
    beyond the film's sample count are masked out. An AOV integrator's
    columns follow the base channels; only duv AOVs pay for the offset
    camera rays."""
    cfg = scene.config
    dev = scene.bsphere_center.device
    H, W = cfg.film_height, cfg.film_width
    cw, ch = cfg.crop_size if cfg.crop_size else (W, H)
    cx, cy = cfg.crop_offset
    total = ch * cw * spp

    lane = lane_offset + torch.arange(n_lanes, dtype=torch.int64, device=dev)
    lane_ok = lane < total
    mod = REGISTRY[cfg.integrator.kind]
    extra = n_aov(cfg)
    diff = _needs_differentials(cfg)
    sampler, ray, ray_weight, pos, *rd = _camera_lanes(
        scene, seed, spp, torch.clamp(lane, max=total - 1), diff)
    if extra:
        kw = {"ray_diff": rd[0]} if diff else {}
        spec, valid, sampler, aovs = mod.sample_aov(scene, sampler, ray,
                                                    ray_weight, **kw)
        rows = torch.cat([_film_rows(spec * ray_weight, valid,
                                     ray.wavelengths), aovs], -1)
    else:
        spec, valid, sampler = mod.sample(scene, sampler, ray)
        rows = _film_rows(spec * ray_weight, valid, ray.wavelengths)
    values = torch.where(lane_ok[:, None], rows, 0.0)
    image = torch.zeros(ch, cw, N_BASE_CHANNELS + extra,
                        dtype=cfg.variant.dtype, device=dev)
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
              harvest=None, refill=None, stats=None, sample_offset=0):
    """The lane pool's schedule, shared by the render and its path-replay
    adjoint (integrators/replay.py): a pool of ``n_lanes`` lanes runs the
    ``total`` samples from sample index ``sample_offset`` on; each lane
    whose path finished is harvested and refilled with the next unstarted
    sample. Per iteration:

    1. ``harvest(vp, rw, pos, slot)`` sees the pool (``rw`` the ray
       weights, ``pos`` the film positions of its lanes); ``slot``
       (n_lanes,) holds the sample index of each lane whose path ended
       since the last visit and ``sample_offset + total`` (a trash row)
       for the others;
    2. dead lanes take the next unstarted samples (camera ray, fresh
       integrator state); ``refill(ridx, new, ray)`` is told which lanes
       took which samples, and their camera rays;
    3. ``bounce(vp, occupied)`` runs one bounce over the whole pool (its
       unoccupied lanes inactive) and returns the new state.

    The runaway cap counts the whole film's samples, whatever the range
    (reference integrators/__init__.py:317). Returns the rays traced (a
    0-d tensor). ``stats``, a dict, receives the loop iterations and the
    samples dropped by the cap."""
    cfg = scene.config
    mod = _bounce_module(cfg)
    dev = scene.bsphere_center.device
    cw, ch = cfg.crop_size if cfg.crop_size else (cfg.film_width,
                                                  cfg.film_height)
    end = sample_offset + total
    trash = torch.full((n_lanes,), end, dtype=torch.int64, device=dev)
    lane_sample = trash.clone()
    occupied = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    its = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    vp = rw = pos = None
    rays = torch.zeros((), device=dev)
    next_sample = sample_offset
    it = 0
    cap = 20 * max_iterations * (1 + (ch * cw * spp) // n_lanes)
    while it < cap:
        with scoped_phase("ert::pool.iteration"):
            # 1. harvest the lanes whose path ended since the last visit
            if vp is not None:
                with scoped_phase("ert::pool.harvest"):
                    finished = occupied & ~vp.active
                    if harvest is not None:
                        harvest(vp, rw, pos,
                                torch.where(finished, lane_sample, trash))
                    occupied = occupied & vp.active

            # 2. refill dead lanes with the next unstarted samples
            with scoped_phase("ert::pool.refill"):
                n_dead = n_lanes - int(occupied.sum())  # host sync
                common.counters["pool_syncs"] += 1
                m = min(n_dead, end - next_sample)
                if m > 0:
                    if vp is None:
                        # the first fill: every lane at once; lanes past a
                        # range shorter than the pool hold its last sample,
                        # unoccupied
                        ridx = torch.arange(n_lanes, device=dev)
                        new = torch.clamp(next_sample + ridx, max=end - 1)
                    else:
                        ridx = torch.nonzero(~occupied)[:m, 0]  # host sync
                        common.counters["pool_syncs"] += 1
                        new = next_sample + torch.arange(
                            m, dtype=torch.int64, device=dev)
                    smp, ray, fresh_rw, fresh_pos = _camera_lanes(
                        scene, seed, spp, new)
                    fresh = mod._init_state(scene, smp, ray)
                    if vp is None:
                        vp = dataclasses.replace(
                            fresh, sampler=dataclasses.replace(
                                fresh.sampler, dim=torch.full(
                                    (n_lanes,), fresh.sampler.dim,
                                    dtype=torch.int64, device=dev)))
                        rw, pos = fresh_rw, fresh_pos
                    else:
                        vp = _put_lanes(vp, fresh, ridx)
                        rw = rw.index_copy(0, ridx, fresh_rw)
                        pos = pos.index_copy(0, ridx, fresh_pos)
                    lane_sample = lane_sample.index_copy(0, ridx[:m],
                                                         new[:m])
                    occupied = occupied.index_fill(0, ridx[:m], True)
                    its = its.index_fill(0, ridx, 0)
                    next_sample += m
                    if refill is not None:
                        refill(ridx, new, ray)
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
        stats["dropped"] = (end - next_sample) + (
            int(occupied.sum()) if it >= cap else 0)
    return rays


def _check_regen(cfg):
    """Raise unless the lane pool can render this scene config."""
    if not regen_supported(cfg):
        raise NotImplementedError(
            f"the lane pool runs path, volpath, volpathmis, the aov, moment, "
            f"bins and nbins wrappers over them (duv AOVs aside) and stokes; "
            f"{cfg.integrator.kind!r} here takes the scan driver "
            "(render(regen=False))")


def render_wavefront_regen(scene, n_lanes, seed, spp, sample_offset=0,
                           total=None, max_total=None, sample_log=False, *,
                           stats=None):
    """Regenerating wavefront render: the lane pool of ``_run_pool`` with
    ``n_lanes`` lanes keeps occupancy near 100 % whatever the spread of
    path lengths. It renders the ``total`` samples from ``sample_offset``
    on (the whole film by default) and returns their partial film; a
    shard of ``parallel.render_sharded`` renders its range so. ``total``
    must not exceed ``max_total`` (default ``total``), which sizes the
    buffers.

    Under a single-pixel filter the film is built from a per-sample slot
    buffer over the spp-aligned window of ``max_total / spp + 1`` pixels
    from the pixel of ``sample_offset``: a finished lane writes its [X, Y,
    Z, A, 1] row at its sample's slot (slots are unique, so the writes need
    no atomics and are deterministic); a reshape-sum over the spp axis
    gives the window's pixels at the end, placed at their pixel in the
    film. Under a wider filter each iteration splats its finished lanes
    into the film with film_put (the others add zero rows). Lanes may run
    in any order: a sample's random numbers are keyed by its index.

    An AOV wrapper's pool bounces its child; its columns come from the
    wrapper's hooks: ``_refill_aov`` (the camera hit, computed at refill
    and carried in the lane) and ``_harvest_aov`` (from the harvested
    lane), and follow the base channels in the film. They have a slot
    buffer of their own, so that the base channels' spp sum is the child's
    alone, bit for bit.

    Returns (film (ch, cw, 5 + n_aov), rays traced (a 0-d tensor)); with
    ``sample_log`` also the sample log over the same window, up to the
    range's end: row i is sample (sample_offset // spp) * spp + i's
    integrator ``result`` before the ray weight (in spectral its 4 hero
    channels), written beside its film row (the path-replay backward's
    radiance totals; over the whole film, (total, nc) with row s sample
    s's). ``stats``, a dict, receives the loop iterations and the samples
    dropped by the runaway cap."""
    cfg = scene.config
    wrapper = REGISTRY[cfg.integrator.kind]
    mod = _bounce_module(cfg)
    _check_regen(cfg)
    extra = n_aov(cfg)
    dev = scene.bsphere_center.device
    cw, ch = cfg.crop_size if cfg.crop_size else (cfg.film_width,
                                                  cfg.film_height)
    total = ch * cw * spp if total is None else total
    max_total = total if max_total is None else max_total
    end = sample_offset + total
    if not (0 <= total <= max_total and 0 <= sample_offset
            and end <= ch * cw * spp):
        raise ValueError(
            f"samples [{sample_offset}, {end}) with max_total {max_total}: "
            f"outside the film's {ch * cw * spp} samples or the buffers")
    # as wide as the largest range: shards of one render share a width
    n_lanes = max(1, min(n_lanes, max_total))
    max_iterations, bounce_kwargs = mod._knobs(scene)
    bounce_kwargs.update(getattr(mod, "_PRIMAL_BOUNCE_KWARGS", {}))

    rp = dict(cfg.rfilter_params)
    wide = filter_radius(cfg.rfilter, rp) > 0.5 + 1e-6
    n_ch = N_BASE_CHANNELS + extra
    # the slots cover samples [aligned_off, aligned_off + n_buf); slot
    # n_buf is the trash row of lanes that finished nothing
    aligned_off = sample_offset // spp * spp
    n_buf = (-(-max_total // spp) + 1) * spp
    slots = None if wide else torch.zeros(n_buf + 1, N_BASE_CHANNELS,
                                          device=dev)
    aov_slots = (torch.zeros(n_buf + 1, extra, device=dev)
                 if extra and not wide else None)
    film = torch.zeros(ch, cw, n_ch, device=dev) if wide else None
    offset = torch.tensor(cfg.crop_offset, dtype=torch.float32, device=dev)
    rlog = (torch.zeros(n_buf + 1, cfg.variant.n_channels, device=dev)
            if sample_log else None)
    # the camera-hit AOV columns carried per lane (filled at refill)
    carry = (torch.zeros(n_lanes, extra, device=dev)
             if hasattr(wrapper, "_refill_aov") else None)

    def refill(ridx, _new, ray):
        carry.index_copy_(0, ridx, wrapper._refill_aov(scene, ray))

    def harvest(vp, rw, pos, slot):
        rows = _film_rows(vp.result * rw, vp.valid_ray, vp.ray.wavelengths)
        aovs = (wrapper._harvest_aov(scene, vp, rw, carry) if extra
                else None)
        slot = torch.where(slot < end, slot - aligned_off, n_buf)
        if wide:
            if extra:
                rows = torch.cat([rows, aovs], -1)
            film_put(film, pos - offset,
                     torch.where((slot < n_buf)[:, None], rows, 0.0),
                     cfg.rfilter, rp)
        else:
            slots.index_copy_(0, slot, rows)
            if extra:
                aov_slots.index_copy_(0, slot, aovs)
        if rlog is not None:
            rlog.index_copy_(0, slot, vp.result)

    rays = _run_pool(scene, n_lanes, seed, spp, total, max_iterations,
                     lambda vp, _occ: mod._bounce(scene, vp, **bounce_kwargs),
                     harvest=harvest, refill=None if carry is None else refill,
                     stats=stats, sample_offset=sample_offset)
    if not wide:
        n_pix = n_buf // spp
        rows = torch.cat([b[:n_buf].reshape(n_pix, spp, -1).sum(1)
                          for b in (slots, aov_slots) if b is not None], -1)
        pix0 = aligned_off // spp
        film = torch.zeros(ch * cw + n_pix, n_ch, device=dev)
        film[pix0:pix0 + n_pix] = rows
        film = film[:ch * cw].reshape(ch, cw, n_ch)
    if sample_log:
        return film, rays, rlog[:end - aligned_off]
    return film, rays


def regen_iter_traffic_nbytes(scene, n_lanes, spp) -> int:
    """The modelled memory traffic of one lane-pool iteration (reference
    integrators/__init__.py:512): the lane state read and written, the
    per-lane bookkeeping, and the finished rows' write. The state is a
    fresh one of ``n_lanes`` lanes, built on the scene's device. A
    polarized state's channels are read from its ``stokes`` (N, nc, 4)
    field (the reference reads ``result``, which its shape-only state
    cannot compute for a polarized integrator, and raises)."""
    cfg = scene.config
    mod = _bounce_module(cfg)
    dev = scene.bsphere_center.device
    lanes = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    smp, ray, _rw, _pos = _camera_lanes(scene, 0, spp, lanes)
    state = mod._init_state(scene, smp, ray,
                            torch.zeros(n_lanes, dtype=torch.bool,
                                        device=dev))

    def nbytes(x):
        if dataclasses.is_dataclass(x):
            return sum(nbytes(getattr(x, f.name))
                       for f in dataclasses.fields(x))
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        return 0

    nc = (state.stokes.shape[-2] if hasattr(state, "stokes")
          else state.result.shape[-1])
    # positions, ray weights, occupancy, iteration counts and sample slots
    # (about 4 bytes each a lane)
    misc = n_lanes * (2 + nc + 1 + 1 + 1) * 4
    # the finished rows: X, Y, Z, the AOV channels and the weight
    append = n_lanes * (3 + n_aov(cfg) + 1) * 4
    return int(nbytes(state) + misc) * 2 + append


def regen_supported(cfg) -> bool:
    """Whether the lane pool can run this integrator (reference
    integrators/__init__.py:552-568): the (possibly wrapped) integrator
    needs the bounce hooks (path, volpath, volpathmis and stokes's two
    children have them; direct and depth take the scan driver, as in the
    reference), and an AOV wrapper its harvest hook; duv AOVs need the
    offset camera rays and keep the scan driver.

    Raises NotImplementedError for a double variant: the reference's pool
    fails there (its film placement, integrators/__init__.py:494-495, mixes
    int32 and int64 indices in dynamic_update_slice under x64), so its
    double variants render, and differentiate, on the scan driver alone;
    so does the port's (render(regen=False))."""
    if cfg.variant.is_double:
        raise NotImplementedError(
            f"the lane pool in {cfg.variant.mode}_double: the reference's "
            "fails in double precision (integrators/__init__.py:494-495: "
            "dynamic_update_slice of int32 and int64 indices under x64); "
            "render with regen=False, the scan driver")
    bmod = _bounce_module(cfg)
    if not all(hasattr(bmod, h) for h in ("_init_state", "_bounce",
                                          "_knobs")):
        return False
    if n_aov(cfg):
        return (hasattr(REGISTRY[cfg.integrator.kind], "_harvest_aov")
                and not _needs_differentials(cfg))
    return True


def _requires_grad(scene):
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in scene.tensors().values())


@scoped_phase("ert::render")
def render(scene, seed=0, spp=None, samples_per_pass=None,
           develop_film=True, return_aovs=False, regen=False):
    """Multi-pass wavefront render, or with ``regen`` the lane pool of
    ``samples_per_pass`` lanes. Returns the developed image (H, W, 3), or
    the raw (H, W, 5 + n_aov) film with ``develop_film=False``; with
    ``return_aovs`` also a {name: (H, W)} dict of the integrator's
    weight-normalised AOV channels (aov.cpp and moment.cpp's outputs).

    Both drivers are differentiable with respect to the scene's
    value-class tensors for path and volpath in every variant: the scan
    driver by autograd through its passes, the lane pool through the
    path-replay backward (integrators/replay.py). The other integrators
    have no replay, and the reference cannot differentiate its pool: their
    gradients go through the scan driver, and ``regen=True`` raises under
    autograd."""
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
            if _requires_grad(scene):
                raise NotImplementedError(
                    f"render(regen=True) of {cfg.integrator.kind!r} has no "
                    "backward (the lane pool is not differentiable); take "
                    "the gradient through the scan driver, "
                    "render(regen=False)")
            film, _rays = render_wavefront_regen(scene, samples_per_pass,
                                                 seed, spp)
    else:
        film = torch.zeros(ch, cw, N_BASE_CHANNELS + n_aov(cfg),
                           dtype=cfg.variant.dtype,
                           device=scene.bsphere_center.device)
        for off in range(0, total, samples_per_pass):
            film += render_wavefront(scene, off, min(samples_per_pass,
                                                     total - off), seed, spp)
    if not develop_film:
        return film
    img = develop(film[..., :N_BASE_CHANNELS], cfg.variant.mode,
                  cfg.pixel_format)
    if not return_aovs:
        return img
    aov_img = film[..., N_BASE_CHANNELS:] / torch.clamp(film[..., 4:5],
                                                        min=1e-12)
    return img, {name: aov_img[..., i]
                 for i, name in enumerate(aov_names(cfg))}


__all__ = ["REGISTRY", "aov_names", "n_aov", "register_integrator",
           "regen_iter_traffic_nbytes", "render", "render_wavefront",
           "render_wavefront_regen", "regen_supported"]
