"""The Stokes-vector integrator (integrators/stokes.py counterpart;
stokes.cpp): the polarized transport of its child, whose S0 the film
splats and whose S1..S3 follow as AOV channels.

A scene with media, or a ``volpath`` child, takes the Mueller volpath
(integrators/polarized_vol.py); a surface scene takes the polarized path
tracer (integrators/polarized.py). The Stokes vector, accumulated in the
camera ray's implicit basis, is rotated at the end into the sensor's
horizontal axis (stokes.cpp:89-100: the target basis is cross(ray.d,
sensor up)). Both children ride the lane pool, which premultiplies that
rotation into a lane's throughput at refill, so its harvest reads the
carried vector.

Mitsuba emits S1..S3 per rgb channel (stokes.cpp:117); the film's AOV
layer carries scalars, so the AOVs are the channel means, as in the
reference. The lane pool has no backward for it (the path replay needs
the ``_REPLAY_OK`` hook, integrators/replay.py), and its gradients through
the scan driver are not held against the reference yet (slice 6e-2).
"""

from __future__ import annotations

import torch

from . import polarized, polarized_vol


def aov_names(cfg):
    return ["s1", "s2", "s3"]


def n_aov(cfg):
    return 3


def _volumetric(cfg):
    return (bool(cfg.medium_kinds)
            or dict(cfg.integrator.extra).get("child") == "volpath")


def _regen_module(cfg):
    """The child whose bounce the lane pool drives."""
    return polarized_vol if _volumetric(cfg) else polarized


def _harvest_aov(scene, vp, rw, aov_carry):
    """S1..S3, the channel means of the carried sensor-basis Stokes
    vector."""
    return vp.stokes.mean(dim=-2)[:, 1:4]


def sample_aov(scene, sampler, ray, ray_weight, active=None):
    """The child's Stokes vector in the sensor's basis -> (S0 (N, nc),
    valid, sampler, S1..S3 channel means (N, 3))."""
    stokes, valid, sampler = _regen_module(scene.config).sample_stokes(
        scene, sampler, ray, active)
    rot = polarized_vol._sensor_basis_rotation(scene, ray)
    stokes = torch.einsum("nij,ncj->nci", rot, stokes)
    return stokes[..., 0], valid, sampler, stokes.mean(dim=-2)[:, 1:4]


def sample(scene, sampler, ray, active=None):
    spec, valid, sampler, _ = sample_aov(scene, sampler, ray, None, active)
    return spec, valid, sampler
