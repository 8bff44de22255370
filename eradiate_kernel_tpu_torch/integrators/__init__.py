"""Integrator registry and the wavefront render driver (the scan driver of
integrators/__init__.py: ``render_wavefront`` and ``render``).

Each pass renders a contiguous run of (pixel, sample) lanes: lane ->
pixel = lane // spp, a jittered film position, a camera ray, the
integrator, and a splat of [X, Y, Z, A, W] into the film. Passes
accumulate; ``render`` develops the sum.
"""

from __future__ import annotations

import torch

from .. import sensors
from ..core.rng import Sampler
from ..core.spectrum import srgb_to_xyz
from ..films import N_BASE_CHANNELS, develop, film_put
from . import path

REGISTRY = {"path": path}


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
    lane = torch.clamp(lane, max=total - 1)
    pixel = lane // spp
    px = (pixel % cw).to(torch.float32) + cx
    py = (pixel // cw).to(torch.float32) + cy

    sampler = Sampler.seed(seed, lane)
    sampler, jitter = sampler.next_2d()
    pos = torch.stack([px, py], dim=-1) + jitter
    pos_film = pos / torch.tensor([W, H], dtype=torch.float32, device=dev)

    time = torch.zeros(n_lanes, device=dev)
    ray, ray_weight, sampler = sensors.sample_ray(scene, sampler, pos_film,
                                                  time)
    spec, valid, sampler = REGISTRY[cfg.integrator.kind].sample(scene,
                                                                sampler, ray)
    spec = spec * ray_weight
    values = torch.cat([srgb_to_xyz(spec),
                        torch.where(valid, 1.0, 0.0)[:, None],
                        torch.ones(n_lanes, 1, device=dev)], dim=-1)
    values = torch.where(lane_ok[:, None], values, 0.0)
    image = torch.zeros(ch, cw, N_BASE_CHANNELS, device=dev)
    offset = torch.tensor([cx, cy], dtype=torch.float32, device=dev)
    return film_put(image, pos - offset, values, cfg.rfilter,
                    dict(cfg.rfilter_params))


def render(scene, seed=0, spp=None, samples_per_pass=None,
           develop_film=True):
    """Multi-pass wavefront render. Returns the developed image (H, W, 3),
    or the raw (H, W, 5) film with ``develop_film=False``."""
    cfg = scene.config
    spp = spp or cfg.spp
    cw, ch = cfg.crop_size if cfg.crop_size else (cfg.film_width,
                                                  cfg.film_height)
    total = ch * cw * spp
    if samples_per_pass is None:
        samples_per_pass = min(total, 1 << 22)
    film = torch.zeros(ch, cw, N_BASE_CHANNELS,
                       device=scene.bsphere_center.device)
    for off in range(0, total, samples_per_pass):
        film += render_wavefront(scene, off, min(samples_per_pass,
                                                 total - off), seed, spp)
    if not develop_film:
        return film
    return develop(film, cfg.pixel_format)
