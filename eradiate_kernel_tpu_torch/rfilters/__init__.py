"""Reconstruction filters (rfilters/__init__.py counterpart): box, tent,
gaussian, mitchell, catmullrom and lanczos, as functions of the signed
distance from the pixel centre, evaluated exactly (no lookup table), as the
reference evaluates them."""

from __future__ import annotations

import math

import numpy as np
import torch

DEFAULTS = {
    "box": {"radius": 0.5},
    "tent": {"radius": 1.0},
    "gaussian": {"stddev": 0.5},
    "mitchell": {"B": 1.0 / 3.0, "C": 1.0 / 3.0},
    "catmullrom": {"B": 0.0, "C": 0.5},
    "lanczos": {"lobes": 3},
}


def _params(kind, params):
    if kind not in DEFAULTS:
        raise ValueError(f"unknown rfilter {kind!r}")
    return {**DEFAULTS[kind], **(params or {})}


def filter_radius(kind: str, params=None) -> float:
    p = _params(kind, params)
    if kind in ("box", "tent"):
        return p["radius"]
    if kind == "gaussian":
        return 4.0 * p["stddev"]
    if kind in ("mitchell", "catmullrom"):
        return 2.0
    return float(p["lobes"])


def eval_filter(kind: str, x, params=None):
    """The filter's weight at signed distance ``x`` (a tensor, pixels)."""
    p = _params(kind, params)
    ax = torch.abs(x)
    if kind == "box":
        return torch.where(ax <= p["radius"], 1.0, 0.0)
    if kind == "tent":
        return torch.clamp(1.0 - ax / p["radius"], min=0.0)
    if kind == "gaussian":
        s = p["stddev"]
        r = 4.0 * s
        alpha = -1.0 / (2.0 * s * s)
        return torch.clamp(torch.exp(alpha * ax * ax)
                           - float(np.float32(np.exp(alpha * r * r))),
                           min=0.0)
    if kind in ("mitchell", "catmullrom"):
        B, C = p["B"], p["C"]
        x2 = ax * ax
        x3 = x2 * ax
        v1 = ((12 - 9 * B - 6 * C) * x3 + (-18 + 12 * B + 6 * C) * x2
              + (6 - 2 * B)) * (1.0 / 6.0)
        v2 = ((-B - 6 * C) * x3 + (6 * B + 30 * C) * x2
              + (-12 * B - 48 * C) * ax + (8 * B + 24 * C)) * (1.0 / 6.0)
        return torch.where(ax < 1.0, v1, torch.where(ax < 2.0, v2, 0.0))
    n = p["lobes"]
    px = math.pi * ax
    sinc = torch.where(ax < 1e-6, 1.0,
                       torch.sin(px) / torch.clamp(px, min=1e-9))
    sincn = torch.where(ax < 1e-6, 1.0,
                        torch.sin(px / n) / torch.clamp(px / n, min=1e-9))
    return torch.where(ax < n, sinc * sincn, 0.0)
