"""Depth integrator (integrators/depth.py counterpart; depth.cpp): the
distance to the first hit in every channel, 0 on a miss. Scan driver
only, as in the reference."""

from __future__ import annotations

import torch

from ..render.geometry import ray_intersect


def sample(scene, sampler, ray, active=None):
    """-> (depth (N, nc), valid, sampler); ``active`` is accepted and
    unread, as in the reference."""
    si = ray_intersect(scene.geo, ray)
    t = torch.where(si.is_valid, si.t, 0.0)
    nc = scene.config.variant.channels(ray.wavelengths)
    return t[:, None].expand(-1, nc), si.is_valid, sampler
