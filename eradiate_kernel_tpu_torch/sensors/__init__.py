"""Sensors (sensors/__init__.py counterpart): the perspective camera."""

from __future__ import annotations

import torch

from ..core.math import normalize
from ..core.ray import Ray


def _wavelengths(scene, sampler, n):
    """rgb: no wavelengths and unit weight; the draw still happens so the
    sample streams stay aligned with the reference's."""
    sampler, _ = sampler.next_1d()
    return torch.ones(n, 3, device=sampler.k0.device), sampler


def perspective_sample_ray(scene, params, sampler, pos_film, time):
    """Pinhole camera (perspective.cpp). Film u=0 maps to camera-space +x
    (the look_at ``left`` axis), v top->bottom maps +y -> -y, the camera
    looks down +z."""
    n = pos_film.shape[0]
    tw = params["to_world"]
    tan_x = params["tan_half_fov"]
    aspect = scene.config.film_height / scene.config.film_width
    x = (1.0 - 2.0 * pos_film[:, 0]) * tan_x
    y = (1.0 - 2.0 * pos_film[:, 1]) * tan_x * aspect
    d = tw.transform_vector(normalize(torch.stack([x, y, torch.ones_like(x)],
                                                  dim=-1)))
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    o = tw.translation.expand(n, 3)
    weight, sampler = _wavelengths(scene, sampler, n)
    return Ray.make(o, d, time=time), weight, sampler


REGISTRY = {"perspective": perspective_sample_ray}


def sample_ray(scene, sampler, pos_film, time):
    """Film positions in [0,1)^2 -> (ray, weight, sampler)."""
    fn = REGISTRY[scene.config.sensor_kind]
    return fn(scene, scene.sensor, sampler, pos_film, time)
