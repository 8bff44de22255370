"""Depth integrator (integrators/depth.py counterpart; depth.cpp): the
distance to the first hit in every channel, 0 on a miss. Scan driver
only, as in the reference."""

from __future__ import annotations

import torch

from ..render.geometry import ray_intersect


def sample(scene, sampler, ray):
    """-> (depth (N, 3), valid, sampler)."""
    si = ray_intersect(scene.geo, ray)
    t = torch.where(si.is_valid, si.t, 0.0)
    return t[:, None].expand(-1, 3), si.is_valid, sampler
