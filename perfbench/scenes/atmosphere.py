"""Plane-parallel Rayleigh atmosphere over an RPV ground (a frozen copy of
the port's ``utils/scenes.py::atmosphere`` with bench.py's flagship
settings), so that later changes to the package cannot move the scene.

``inputs(cfg)`` makes the arrays both sides are given; ``scene_dict``
builds the port's scene from them."""

import numpy as np


def sigma_profile(cfg):
    """(D, 4, 4) float32 extinction grid: an exponential profile of scale
    height ``scale_height`` whose mean over the D cell centres is ``tau``
    (the vertical optical depth of the unit slab)."""
    D = int(cfg["grid_res"])
    z = (np.arange(D) + 0.5) / D
    profile = np.exp(-z / cfg["scale_height"])
    profile *= cfg["tau"] / profile.mean()
    return np.broadcast_to(profile[:, None, None], (D, 4, 4)).astype(
        np.float32)


def inputs(cfg):
    return {"sigma_t": sigma_profile(cfg)}


def scene_dict(cfg, inp, width, height, spp):
    half = cfg["half_width"]
    cx = cfg["center_xy"]
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": cfg["max_depth"],
                       "nee_transmittance": cfg["nee_transmittance"]},
        "sensor": {
            "type": "perspective", "fov": cfg["fov"],
            "to_world": {"type": "look_at", "origin": cfg["camera_origin"],
                         "target": cfg["camera_target"],
                         "up": cfg["camera_up"]},
            "film": {"width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
        "surface": {
            "type": "rectangle",
            "to_world": [{"type": "scale", "value": half},
                         {"type": "translate",
                          "value": [cx, cx, cfg["ground_z"]]}],
            "bsdf": {"type": "rpv", "rho_0": cfg["rpv_rho_0"],
                     "g": cfg["rpv_g"], "k": cfg["rpv_k"]},
        },
        "atmo": {
            "type": "cube",
            "to_world": [{"type": "scale", "value": [half, half, 0.5]},
                         {"type": "translate", "value": [cx, cx, 0.5]}],
            "bsdf": {"type": "null"},
            "interior": {
                "type": "heterogeneous",
                "sigma_t": {"type": "gridvolume", "data": inp["sigma_t"],
                            "to_world": [{"type": "scale",
                                          "value": [2 * half, 2 * half, 1.0]},
                                         {"type": "translate",
                                          "value": [cx - half, cx - half,
                                                    0.0]}]},
                "albedo": cfg["albedo"],
                "phase": {"type": "rayleigh"},
            },
        },
        "sun": {"type": "directional", "direction": cfg["sun_direction"],
                "irradiance": cfg["irradiance"]},
    }


def triangles(cfg, inp):
    """(V, F) of the scene's triangle meshes: the atmosphere box's 12
    triangles (the ground is an analytic rectangle)."""
    half, cx = cfg["half_width"], cfg["center_xy"]
    c = np.array([[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)],
                 np.float64)
    V = np.stack([cx - half + 2 * half * c[:, 0], cx - half + 2 * half * c[:, 1],
                  c[:, 2]], -1).astype(np.float32)
    F = np.array([[0, 2, 1], [1, 2, 3], [4, 5, 6], [5, 7, 6],
                  [0, 1, 4], [1, 5, 4], [2, 6, 3], [3, 6, 7],
                  [0, 4, 2], [2, 4, 6], [1, 3, 5], [3, 7, 5]], np.int32)
    return V, F
