"""Sensor construction (scene/build_sensors.py counterpart): perspective,
thinlens, radiancemeter, mradiancemeter, distant, mdistant, distantflux
and irradiancemeter, with a shutter, an animated ``to_world`` and a
spectral response function (stored only: the reference reads it in the
spectral variant alone)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.math import coordinate_system
from ..core.transform import Transform, as_animated_transform, as_transform

_SENSOR_TYPES = ("perspective", "thinlens", "radiancemeter", "mradiancemeter",
                 "distant", "mdistant", "distantflux", "irradiancemeter")


def _build_srf(spec, params):
    """A spectral response function on a uniform grid with its sampling
    CDF (perspective.cpp:106-180): adds srf_nodes, srf_cdf and srf_integral
    to ``params`` (srf_lines, srf_line_cdf and srf_integral for discrete
    lines)."""
    K = 257
    t = spec["type"]
    if t == "uniform":
        lo, hi = spec.get("lambda_min", 360.0), spec.get("lambda_max", 830.0)
        nodes = np.linspace(lo, hi, K)
        vals = np.full(K, float(spec.get("value", 1.0)))
    elif t == "regular":
        lo, hi = spec["lambda_min"], spec["lambda_max"]
        src = np.asarray(spec["values"], np.float64)
        nodes = np.linspace(lo, hi, K)
        vals = np.interp(nodes, np.linspace(lo, hi, len(src)), src)
    elif t == "irregular":
        wav = np.asarray(spec["wavelengths"], np.float64)
        src = np.asarray(spec["values"], np.float64)
        nodes = np.linspace(wav[0], wav[-1], K)
        vals = np.interp(nodes, wav, src)
    elif t == "discrete":
        wav = np.asarray(spec["wavelengths"], np.float64)
        w = np.asarray(spec.get("values", np.ones_like(wav)), np.float64)
        cdf = np.concatenate([[0.0], np.cumsum(w)]) / w.sum()
        params["srf_lines"] = wav.astype(np.float32)
        params["srf_line_cdf"] = cdf.astype(np.float32)
        params["srf_integral"] = np.float32(w.sum())
        return
    else:
        raise ValueError(f"unsupported srf spectrum type {t!r}")
    cell = 0.5 * (vals[1:] + vals[:-1]) * np.diff(nodes)
    integral = float(cell.sum())
    cdf = np.concatenate([[0.0], np.cumsum(cell)]) / max(integral, 1e-30)
    params["srf_nodes"] = nodes.astype(np.float32)
    params["srf_cdf"] = cdf.astype(np.float32)
    params["srf_integral"] = np.float32(integral)


def _parse_fov(val, aspect):
    """sensor.cpp:113-165 parse_fov: ``fov`` + ``fov_axis`` (x, y, smaller,
    larger, diagonal) or a 35 mm-equivalent ``focal_length`` -> horizontal
    field of view in degrees."""
    if "fov" in val and "focal_length" in val:
        raise ValueError("Please specify either a focal length "
                         "('focal_length') or a field of view ('fov')!")
    if "fov" in val:
        fov = float(val["fov"])
        axis = str(val.get("fov_axis", "x")).lower()
        if axis == "smaller":
            axis = "y" if aspect > 1 else "x"
        elif axis == "larger":
            axis = "x" if aspect > 1 else "y"
    else:
        f = str(val.get("focal_length", "50mm"))
        if f.endswith("mm"):
            f = f[:-2]
        fov = 2.0 * np.rad2deg(
            np.arctan(np.sqrt(36.0 ** 2 + 24.0 ** 2) / (2.0 * float(f))))
        axis = "diagonal"
    if axis == "x":
        result = fov
    elif axis == "y":
        result = np.rad2deg(2.0 * np.arctan(
            np.tan(0.5 * np.deg2rad(fov)) * aspect))
    elif axis == "diagonal":
        diagonal = 2.0 * np.tan(0.5 * np.deg2rad(fov))
        width = diagonal / np.sqrt(1.0 + 1.0 / (aspect * aspect))
        result = np.rad2deg(2.0 * np.arctan(0.5 * width))
    else:
        raise ValueError("The 'fov_axis' parameter must be set to one of "
                         "'smaller', 'larger', 'diagonal', 'x', or 'y'!")
    if not 0.0 < result < 180.0:
        raise ValueError("The horizontal field of view must be in the "
                         "range [0, 180]!")
    return float(result)


def _target(val, params, static):
    """A point target (``target``) or the bounding-sphere cross-section."""
    if "target" in val:
        params["target"] = np.asarray(val["target"], np.float32)
        static["target_mode"] = "point"
    else:
        static["target_mode"] = "none"


def _distant_frame(val):
    """distant.cpp:243-263: ``direction`` (exclusive with ``to_world``)
    gives the frame look_at(0, direction, up), up = direction x
    ``orientation`` or the coordinate_system basis of the direction."""
    if "to_world" in val:
        raise ValueError("distant: only one of 'direction' and 'to_world' "
                         "can be specified")
    dirc = np.asarray(val["direction"], np.float64)
    dirc = dirc / np.linalg.norm(dirc)
    if "orientation" in val:
        up = np.cross(dirc, np.asarray(val["orientation"], np.float64))
        up = up / np.linalg.norm(up)
    else:
        _s, up_t = coordinate_system(torch.as_tensor(dirc, dtype=torch.float32))
        up = up_t.numpy().astype(np.float64)
    return Transform.look_at([0.0, 0.0, 0.0], list(dirc), list(up))


def _build_sensor(b, t, val, film_cfg):
    """(sensor params (numpy), sensor statics (sorted (key, value) pairs))
    for sensor type ``t``. mdistant and mradiancemeter set the film to
    N x 1 with a box filter in ``film_cfg``."""
    if t not in _SENSOR_TYPES:
        raise ValueError(f"unknown sensor type {t!r}")
    anim = as_animated_transform(val.get("to_world"))
    # an animated sensor's static to_world is its first keyframe; the
    # sensors that read to_world_anim evaluate it at each ray's time
    tw = (anim.eval(torch.as_tensor(anim.times[0])) if anim is not None
          else as_transform(val.get("to_world")))
    tw = Transform(m=np.asarray(tw.m, np.float32),
                   inv_t=np.asarray(tw.inv_t, np.float32))
    params, static = {}, {}
    if anim is not None:
        params["to_world_anim"] = anim
    if "shutter_open" in val or "shutter_close" in val:
        so = float(val.get("shutter_open", 0.0))
        params["shutter_open"] = np.float32(so)
        params["shutter_span"] = np.float32(
            float(val.get("shutter_close", so)) - so)
    if t in ("perspective", "thinlens"):
        aspect = film_cfg["width"] / film_cfg["height"]
        params["to_world"] = tw
        params["tan_half_fov"] = np.float32(
            np.tan(np.deg2rad(_parse_fov(val, aspect)) / 2))
        if t == "thinlens":
            params["aperture_radius"] = np.float32(
                val.get("aperture_radius", 0.1))
            params["focus_distance"] = np.float32(
                val.get("focus_distance", 1.0))
    elif t in ("radiancemeter", "distantflux"):
        params["to_world"] = tw
        if t == "distantflux":
            _target(val, params, static)
    elif t == "mradiancemeter":
        origins = np.asarray(val["origins"], np.float32).reshape(-1, 3)
        directions = np.asarray(val["directions"], np.float32).reshape(-1, 3)
        if len(origins) != len(directions):
            raise ValueError("mradiancemeter: as many origins as directions")
        params["origins"], params["directions"] = origins, directions
        film_cfg.update(width=len(origins), height=1, rfilter="box")
    elif t == "distant":
        params["to_world"] = _distant_frame(val) if "direction" in val else tw
        static["flip_directions"] = bool(val.get("flip_directions", False))
        _target(val, params, static)
        w, h = film_cfg["width"], film_cfg["height"]
        static["direction_mode"] = ("single" if (w, h) == (1, 1)
                                    else "plane" if h == 1 else "hemisphere")
    elif t == "mdistant":
        params["directions"] = np.asarray(val["directions"],
                                          np.float32).reshape(-1, 3)
        _target(val, params, static)
        film_cfg.update(width=len(params["directions"]), height=1,
                        rfilter="box")
    else:  # irradiancemeter
        sh = val.get("shape")
        if not (isinstance(sh, dict) and sh.get("type") == "ref"):
            raise ValueError("irradiancemeter needs {'shape': {'type': "
                             "'ref', 'id': <name>}}")
        kind, idx = b.named[sh["id"]]
        if kind != "shape":
            raise ValueError(f"irradiancemeter: {sh['id']!r} is a {kind}")
        params["shape"] = np.int32(idx)
    if "srf" in val:
        _build_srf(val["srf"], params)
    return params, tuple(sorted(static.items()))
