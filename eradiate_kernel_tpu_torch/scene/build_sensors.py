"""Sensor construction (scene/build_sensors.py counterpart): perspective."""

from __future__ import annotations

import numpy as np

from ..core.transform import as_transform

_SENSOR_TYPES = ("perspective",)


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


def _build_sensor(builder, t, val, film_cfg):
    """Sensor params (numpy) for sensor type ``t``."""
    if t not in _SENSOR_TYPES:
        raise NotImplementedError(
            f"sensor {t!r}: this slice of the port carries {_SENSOR_TYPES}")
    for key in ("shutter_open", "shutter_close", "srf", "medium"):
        if key in val:
            raise NotImplementedError(
                f"sensor {key!r}: not carried by this slice of the port")
    aspect = film_cfg["width"] / film_cfg["height"]
    fov = _parse_fov(val, aspect)
    tw = as_transform(val.get("to_world"))
    return {"to_world": tw,
            "tan_half_fov": np.float32(np.tan(np.deg2rad(fov) / 2))}
