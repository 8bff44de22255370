"""The AOV wrapper integrator (integrators/aov.py counterpart; aov.cpp:
65-99): a child integrator's radiance plus arbitrary-output-variable
channels from the camera ray's first hit.

The spec string is "name:type,name:type,..." with the types depth,
position, uv, geo_normal, sh_normal, prim_index, shape_index, duv_dx and
duv_dy; a type of n > 1 channels is named name.x, name.y, ... The scan
driver appends the columns after the film's 5 base channels. On the lane
pool the child's state bounces as usual; the columns are computed from
one closest-hit query of the camera rays when a lane is refilled and
carried in the lane until its harvest. duv_dx and duv_dy need the offset
camera rays of ``sensors.sample_ray_differential`` and keep the scan
driver, as in the reference."""

from __future__ import annotations

import torch

from ..render.geometry import ray_intersect
from ..render.records import compute_uv_partials

_TYPE_CHANNELS = {
    "depth": 1, "position": 3, "uv": 2, "geo_normal": 3, "sh_normal": 3,
    "prim_index": 1, "shape_index": 1, "duv_dx": 2, "duv_dy": 2,
}


def parse_aovs(cfg):
    """[(name, type), ...] from the integrator config's "aovs" extra."""
    spec = dict(cfg.integrator.extra).get("aovs", "")
    out = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        name, ty = part.split(":")
        if ty not in _TYPE_CHANNELS:
            raise ValueError(f"unknown aov type {ty!r}")
        out.append((name.strip(), ty.strip()))
    return out


def aov_names(cfg):
    names = []
    for name, ty in parse_aovs(cfg):
        n = _TYPE_CHANNELS[ty]
        names += [name] if n == 1 else [f"{name}.{c}" for c in "xyzw"[:n]]
    return names


def n_aov(cfg):
    return sum(_TYPE_CHANNELS[ty] for _, ty in parse_aovs(cfg))


def _child(cfg):
    from . import REGISTRY

    return REGISTRY[dict(cfg.integrator.extra).get("child", "path")]


def sample(scene, sampler, ray, active=None):
    return _child(scene.config).sample(scene, sampler, ray, active)


def needs_differentials(cfg):
    """Whether the spec asks for screen-space uv partials: the scan driver
    then traces the offset camera rays (aov.cpp:124, 212-213)."""
    return any(ty in ("duv_dx", "duv_dy") for _, ty in parse_aovs(cfg))


def _aov_columns(cfg, si, duv):
    """The (N, n_aov) AOV block of the camera rays' hits ``si``; ``duv``
    the uv partials (needed by duv_dx and duv_dy only)."""
    valid = si.is_valid
    cols = []
    for _name, ty in parse_aovs(cfg):
        if ty == "depth":
            cols.append(torch.where(valid, si.t, 0.0)[:, None])
        elif ty == "prim_index":
            cols.append(si.prim_index.to(torch.float32)[:, None])
        elif ty == "shape_index":
            cols.append(si.shape_index.to(torch.float32)[:, None])
        else:
            v = {"position": lambda: si.p, "uv": lambda: si.uv,
                 "geo_normal": lambda: si.n,
                 "sh_normal": lambda: si.sh_frame.n,
                 "duv_dx": lambda: duv[0], "duv_dy": lambda: duv[1]}[ty]()
            cols.append(torch.where(valid[:, None], v, 0.0))
    n = si.t.shape[0]
    return (torch.cat(cols, dim=-1) if cols
            else torch.zeros(n, 0, device=si.t.device))


def sample_aov(scene, sampler, ray, ray_weight, active=None, ray_diff=None):
    """The child's sample and the AOV block of ``ray``'s first hit ->
    (spec, valid, sampler, aovs (N, n_aov))."""
    cfg = scene.config
    spec, valid, sampler = _child(cfg).sample(scene, sampler, ray, active)
    si = ray_intersect(scene.geo, ray)
    duv = None if ray_diff is None else compute_uv_partials(si, ray_diff)
    return spec, valid, sampler, _aov_columns(cfg, si, duv)


# --- the lane pool's hooks (integrators.render_wavefront_regen) -------------

def _regen_module(cfg):
    return _child(cfg)


def _refill_aov(scene, ray):
    """The AOV block of refilled lanes' camera rays: one closest-hit
    query, carried in the lane until its harvest."""
    return _aov_columns(scene.config, ray_intersect(scene.geo, ray), None)


def _harvest_aov(scene, vp, rw, aov_carry):
    return aov_carry
