"""The spectral-bin wrapper integrators (integrators/bins.py counterpart):
``bins`` (bins.cpp:12-58) adds, as AOV channels, the child integrator's
radiance integrated over named wavelength bins "name:lo:hi", the way
Eradiate takes per-band top-of-atmosphere radiances from one render;
``nbins`` (nbins.cpp:50,127) takes narrow bins "name:center", a hero
wavelength within +-``tolerance`` of the center contributing.

A bin column is the hero-wavelength estimate of the bin's integral: the
mean over the 4 hero wavelengths of the weighted radiance (the child's
times the sensor's wavelength weight, 1 / pdf) where the wavelength falls
in the bin. The wrappers draw nothing: the child's sample stream and base
film are those of the child alone. They run on both drivers (the lane
pool bounces the child and harvests the columns from the lane's ray) and
in the spectral variant only (scene.SceneConfig refuses them elsewhere,
as bins.cpp throws).
"""

from __future__ import annotations

import torch


def _parse(cfg, narrow):
    """[(name, lo, hi)] of the integrator's ``bins`` spec."""
    extra = dict(cfg.integrator.extra)
    out = []
    for part in str(extra.get("bins", "")).split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if narrow:
            center = float(fields[1])
            tol = float(extra.get("tolerance", 1.0))
            out.append((fields[0], center - tol, center + tol))
        else:
            out.append((fields[0], float(fields[1]), float(fields[2])))
    return out


def _child(cfg):
    from . import REGISTRY
    return REGISTRY[dict(cfg.integrator.extra).get("child", "path")]


def _columns(cfg, narrow, weighted, wl):
    """(N, n_bins) hero-mean estimates of each bin's integral."""
    cols = [torch.sum(torch.where((wl >= lo) & (wl < hi), weighted, 0.0),
                      dim=-1, keepdim=True) * (1.0 / wl.shape[-1])
            for _name, lo, hi in _parse(cfg, narrow)]
    if not cols:
        return weighted.new_zeros(weighted.shape[0], 0)
    return torch.cat(cols, -1)


class _Bins:
    """The bins (narrow=False) or nbins (narrow=True) wrapper."""

    def __init__(self, narrow):
        self.narrow = narrow

    def aov_names(self, cfg):
        return [name for name, _, _ in _parse(cfg, self.narrow)]

    def n_aov(self, cfg):
        return len(_parse(cfg, self.narrow))

    def sample(self, scene, sampler, ray, active=None):
        return _child(scene.config).sample(scene, sampler, ray, active)

    def sample_aov(self, scene, sampler, ray, ray_weight, active=None):
        """The child's sample and the bin columns of its radiance."""
        cfg = scene.config
        spec, valid, sampler = _child(cfg).sample(scene, sampler, ray,
                                                  active)
        return spec, valid, sampler, _columns(
            cfg, self.narrow, spec * ray_weight, ray.wavelengths)

    # --- the lane pool's hooks -------------------------------------------
    def _regen_module(self, cfg):
        return _child(cfg)

    def _harvest_aov(self, scene, vp, rw, aov_carry):
        return _columns(scene.config, self.narrow, vp.result * rw,
                        vp.ray.wavelengths)


def make(narrow: bool):
    """The bins (narrow=False) or nbins (narrow=True) wrapper."""
    return _Bins(narrow)


bins = make(False)
nbins = make(True)
