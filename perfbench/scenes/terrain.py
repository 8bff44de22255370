"""RPV heightfield terrain under a directional sun (frozen copies of
chip_smoke.py's ``terrain`` and ``terrain_scene``, which reproduce
bench_mesh.py's terrain(n) and camera pose).

``inputs(cfg)`` makes the mesh both sides are given; ``scene_dict`` builds
the port's scene from it."""

import numpy as np


def heightfield(n, seed):
    """Heightfield mesh over [-1, 1]^2 with fractal bumps: (V (n*n, 3)
    float32, F (2 (n-1)^2, 3) int32). Vertex (i, j) sits at x_i, y_j."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1, 1, n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    Z = np.zeros_like(X)
    for octave in range(1, 6):
        f = 2.0 ** octave
        ph = rng.uniform(0, 2 * np.pi, 4)
        Z += (np.sin(f * np.pi * X + ph[0]) * np.sin(f * np.pi * Y + ph[1])
              + np.cos(f * np.pi * (X + Y) + ph[2])) * (0.25 / f)
    V = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a, b, c, d = idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:], idx[1:, 1:]
    F = np.concatenate([
        np.stack([a, b, c], -1).reshape(-1, 3),
        np.stack([b, d, c], -1).reshape(-1, 3)]).astype(np.int32)
    return V, F


def inputs(cfg):
    V, F = heightfield(int(cfg["resolution"]), int(cfg["terrain_seed"]))
    return {"vertices": V, "faces": F}


def scene_dict(cfg, inp, width, height, spp):
    return {
        "type": "scene",
        "terrain": {"type": "mesh", "vertices": inp["vertices"],
                    "faces": inp["faces"],
                    "bsdf": {"type": "rpv", "rho_0": cfg["rpv_rho_0"],
                             "g": cfg["rpv_g"], "k": cfg["rpv_k"]}},
        "sun": {"type": "directional", "direction": cfg["sun_direction"],
                "irradiance": cfg["irradiance"]},
        "camera": {
            "type": "perspective", "fov": cfg["fov"],
            "to_world": {"type": "look_at", "origin": cfg["camera_origin"],
                         "target": cfg["camera_target"],
                         "up": cfg["camera_up"]},
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
        "integrator": {"type": "path", "max_depth": cfg["max_depth"]},
    }


def triangles(cfg, inp):
    """(V, F) of the scene's triangle meshes."""
    return inp["vertices"], inp["faces"]
