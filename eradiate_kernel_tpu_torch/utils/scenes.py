"""Canned scenes (utils/scenes.py counterpart): the plane-parallel
atmosphere, the repository's main workload."""

from __future__ import annotations

import numpy as np


def atmosphere(width=64, height=64, spp=16, max_depth=16, grid_res=16,
               tau=0.36, albedo=0.9, surface_reflectance=0.3,
               sun_direction=(0.3, 0.0, -0.94)):
    """Plane-parallel Rayleigh atmosphere over an RPV ground: gridvolume
    sigma_t with an exponential profile (vertical optical depth ``tau``),
    Rayleigh phase, directional sun, a perspective camera looking down.

    ``grid_res``: an int D gives a (D, 4, 4) plane-parallel profile; a
    tuple (D, H, W) a full 3D grid with a mild horizontal modulation of
    the density, so that large grids exercise real 3D lookups. The
    atmosphere cube spans x, y in [-19.5, 20.5] and z in [0, 1]."""
    if isinstance(grid_res, (tuple, list)):
        D, Hc, Wc = grid_res
    else:
        D, Hc, Wc = grid_res, 4, 4
    z = (np.arange(D) + 0.5) / D
    profile = np.exp(-z / 0.25)
    profile *= tau / (profile.mean() * 1.0)  # unit slab height
    sigma = np.broadcast_to(profile[:, None, None],
                            (D, Hc, Wc)).astype(np.float32)
    if Hc > 4 or Wc > 4:
        yy = (np.arange(Hc) + 0.5) / Hc
        xx = (np.arange(Wc) + 0.5) / Wc
        mod = (1.0 + 0.5 * np.sin(2 * np.pi * 3 * xx)[None, None, :]
               * np.sin(2 * np.pi * 3 * yy)[None, :, None]
               * np.exp(-z / 0.5)[:, None, None])
        sigma = (sigma * mod).astype(np.float32)

    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": max_depth},
        "sensor": {
            "type": "perspective", "fov": 60.0,
            "to_world": {"type": "look_at", "origin": [0.5, 0.5, 3.0],
                         "target": [0.5, 0.5, 0.0], "up": [0, 1, 0]},
            "film": {"width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "surface": {
            "type": "rectangle",
            "to_world": [{"type": "scale", "value": 20.0},
                         {"type": "translate", "value": [0.5, 0.5, 0.0]}],
            "bsdf": {"type": "rpv", "rho_0": surface_reflectance,
                     "g": -0.1, "k": 0.7},
        },
        "atmo": {
            "type": "cube",
            "to_world": [{"type": "scale", "value": [20.0, 20.0, 0.5]},
                         {"type": "translate", "value": [0.5, 0.5, 0.5]}],
            "bsdf": {"type": "null"},
            "interior": {
                "type": "heterogeneous",
                "sigma_t": {"type": "gridvolume", "data": sigma,
                            "to_world": [{"type": "scale",
                                          "value": [40.0, 40.0, 1.0]},
                                         {"type": "translate",
                                          "value": [-19.5, -19.5, 0.0]}]},
                "albedo": albedo,
                "phase": {"type": "rayleigh"},
            },
        },
        "sun": {"type": "directional",
                "direction": list(sun_direction), "irradiance": 1.0},
    }
