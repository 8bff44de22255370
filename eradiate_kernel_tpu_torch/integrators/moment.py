"""The second-moment wrapper integrator (integrators/moment.py
counterpart; moment.cpp:28-46): a child integrator's radiance plus the
per-channel second moment of its splatted XYZ value (in spectral the
hero-wavelength estimate at the ray's wavelengths) as the AOV channels
m2.x, m2.y and m2.z, from which a per-pixel variance follows (the z-test
render regression harness reads them)."""

from __future__ import annotations

from .common import spec_to_xyz


def aov_names(cfg):
    return ["m2.x", "m2.y", "m2.z"]


def n_aov(cfg):
    return 3


def _child(cfg):
    from . import REGISTRY

    return REGISTRY[dict(cfg.integrator.extra).get("child", "path")]


def sample(scene, sampler, ray, active=None):
    return _child(scene.config).sample(scene, sampler, ray, active)


def sample_aov(scene, sampler, ray, ray_weight, active=None):
    """The child's sample and the second moment of the splatted value (the
    sensor's weight included, as it lands in the film)."""
    spec, valid, sampler = _child(scene.config).sample(scene, sampler, ray,
                                                       active)
    xyz = spec_to_xyz(spec * ray_weight, ray.wavelengths)
    return spec, valid, sampler, xyz * xyz


# --- the lane pool's hooks ---------------------------------------------------

def _regen_module(cfg):
    return _child(cfg)


def _harvest_aov(scene, vp, rw, aov_carry):
    """The second moment of the splatted value, from the harvested lane's
    state."""
    xyz = spec_to_xyz(vp.result * rw, vp.ray.wavelengths)
    return xyz * xyz
