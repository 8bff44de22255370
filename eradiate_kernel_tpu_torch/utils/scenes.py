"""Canned scenes (utils/scenes.py counterpart): the Cornell box, the
furnace and the plane-parallel atmosphere, the repository's main
workload. Each returns the reference's dict for the same arguments."""

from __future__ import annotations

import numpy as np

from ..core.transform import Transform


def cornell_box(width=64, height=64, spp=16, max_depth=6, integrator="path"):
    """The Cornell box of six rectangles and a rectangular area light near
    the ceiling (the geometry of the cbox scene). The sample mapping puts
    camera-space +x on the image's left, so the red wall is at x = +1."""
    T = Transform
    rect = lambda xf, bsdf: {"type": "rectangle", "to_world": xf.m,
                             "bsdf": {"type": "ref", "id": bsdf}}
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": max_depth},
        "sensor": {
            "type": "perspective", "fov": 39.3077,
            "to_world": T.look_at([0, 0, -3.9], [0, 0, 0], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "white_bsdf": {"type": "diffuse", "reflectance": {
            "type": "rgb", "value": [0.885, 0.698, 0.666]}},
        "red_bsdf": {"type": "diffuse", "reflectance": {
            "type": "rgb", "value": [0.57, 0.04, 0.04]}},
        "green_bsdf": {"type": "diffuse", "reflectance": {
            "type": "rgb", "value": [0.105, 0.37, 0.067]}},
        "floor": rect(T.translate([0, -1, 0]) @ T.rotate([1, 0, 0], -90),
                      "white_bsdf"),
        "ceiling": rect(T.translate([0, 1, 0]) @ T.rotate([1, 0, 0], 90),
                        "white_bsdf"),
        "back": rect(T.translate([0, 0, 1]) @ T.rotate([1, 0, 0], 180),
                     "white_bsdf"),
        "left": rect(T.translate([-1, 0, 0]) @ T.rotate([0, 1, 0], 90),
                     "green_bsdf"),
        "right": rect(T.translate([1, 0, 0]) @ T.rotate([0, 1, 0], -90),
                      "red_bsdf"),
        "light": {"type": "rectangle",
                  "to_world": (T.translate([0, 0.99, 0])
                               @ T.rotate([1, 0, 0], 90)
                               @ T.scale([0.23, 0.19, 1.0])).m,
                  "bsdf": {"type": "diffuse", "reflectance": 0.0},
                  "emitter": {"type": "area", "radiance": {
                      "type": "rgb", "value": [18.387, 13.9873, 6.75357]}}},
    }


def furnace(albedo=0.5, radiance=1.0, width=16, height=16, spp=64,
            max_depth=32, integrator="path"):
    """A diffuse unit sphere under a constant environment: a pixel on the
    sphere sees radiance x sum_k albedo^k over the bounces it reaches."""
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": max_depth},
        "sensor": {
            "type": "perspective", "fov": 40.0,
            "to_world": Transform.look_at([0, 0, -4], [0, 0, 0],
                                          [0, 1, 0]).m,
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "sphere": {"type": "sphere", "radius": 1.0,
                   "bsdf": {"type": "diffuse", "reflectance": albedo}},
        "env": {"type": "constant", "radiance": radiance},
    }


def atmosphere(width=64, height=64, spp=16, max_depth=16, grid_res=16,
               tau=0.36, albedo=0.9, surface_reflectance=0.3,
               sun_direction=(0.3, 0.0, -0.94), sensor="perspective"):
    """Plane-parallel Rayleigh atmosphere over an RPV ground: gridvolume
    sigma_t with an exponential profile (vertical optical depth ``tau``),
    Rayleigh phase, directional sun. ``sensor``: 'perspective', a camera
    looking down on a ``width`` x ``height`` film, or 'distant', the
    radiance leaving the top of the atmosphere straight up (rays travel
    along -direction) towards the point (0.5, 0.5, 0) on a 1x1 film.

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

    if sensor == "distant":
        sensor_dict = {
            "type": "distant", "direction": [0, 0, 1],
            "target": [0.5, 0.5, 0.0],
            "film": {"width": 1, "height": 1, "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}}
    else:
        sensor_dict = {
            "type": "perspective", "fov": 60.0,
            "to_world": {"type": "look_at", "origin": [0.5, 0.5, 3.0],
                         "target": [0.5, 0.5, 0.0], "up": [0, 1, 0]},
            "film": {"width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}}
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": max_depth},
        "sensor": sensor_dict,
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
