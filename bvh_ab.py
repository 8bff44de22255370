"""Render and kernel times of the port's tile-BVH loads through the
eradiate_kernel_tpu_torch package beside this script (chip_smoke.py phases
3, 5 and 6): the forest render (256x256, spp 16, max_depth 6) through
tile_bvh and through tile_bvh8 (ERT_BVH_WIDE=1), the terrain render
(256x256, spp 16, max_depth 6) through its default query (the sweep) and
through tile_bvh (ERT_ACCEL=bvh), each BVH kernel alone on the three
loads (the forest's 2^19 primary rays, terrain(256)'s 2^20 primary and
2^20 incoherent rays), and the sweep kernel alone on the two terrain
loads (the sorted pipeline's sweep, whose leaf the BVH kernels share). Needs one CUDA card and the chip_smoke.py of the
same checkout; prints one JSON line with the card's name, each render's
median ms of 3 and each kernel's ms (CUDA events, 10 back-to-back launches).

To compare two checkouts on one card, copy this script into the root of
each and run the copies in turns on one card (A, B, B, A):

    python3 bvh_ab.py --label NAME
"""

import json
import sys
import time

import numpy as np
import torch


def render_ms(scene, runs=3, **env_values):
    """Median ms of ``runs`` renders of ``scene`` (after a 1-spp warm-up)
    with the environment variables set."""
    from chip_smoke import env
    from eradiate_kernel_tpu_torch import integrators

    times = []
    with env(**env_values):
        integrators.render(scene, seed=0, spp=1)
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            integrators.render(scene, seed=0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main():
    if not torch.cuda.is_available():
        print("bvh_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (cuda_ms, forest_scene, make_rays, terrain,
                            terrain_scene)
    from eradiate_kernel_tpu_torch.core.ray import Ray
    from eradiate_kernel_tpu_torch.ops import bvh, intersect
    from eradiate_kernel_tpu_torch.ops.accel import pack_tiles
    from eradiate_kernel_tpu_torch.scene import load_dict

    dev = torch.device("cuda")
    label = sys.argv[sys.argv.index("--label") + 1] \
        if "--label" in sys.argv else ""
    out = {"label": label, "device": torch.cuda.get_device_name(0)}

    forest = load_dict(forest_scene(256, 256, 16, 6))
    V, F = terrain(256)
    ground = load_dict(terrain_scene(V, F, 256, 256, 16, 6))
    out["render_ms"] = {
        "forest tile_bvh": render_ms(forest, ERT_BVH_WIDE="0"),
        "forest tile_bvh8": render_ms(forest, ERT_BVH_WIDE="1"),
        "terrain sweep": render_ms(ground, ERT_ACCEL="auto"),
        "terrain tile_bvh": render_ms(ground, ERT_ACCEL="bvh"),
    }

    t = pack_tiles(V, None, F, np.zeros(len(F), np.int32))
    nbox, nmeta, _ = bvh.build_tile_bvh(t["lo"], t["hi"])
    cbox, cmeta = bvh.collapse_to_bvh8(nbox, nmeta)
    t.update(nbox=nbox, nmeta=nmeta, cbox=cbox, cmeta=cmeta)
    tiles = {k: torch.as_tensor(v, device=dev) for k, v in t.items()}

    def rays(n, kind, scale=(1, 1, 1)):
        o, d = make_rays(n, kind)
        return Ray.make(torch.as_tensor(o * np.float32(scale), device=dev),
                        torch.as_tensor(d, device=dev))

    loads = {"forest": (forest.geo.tiles(), rays(1 << 19, "primary",
                                                 (8, 8, 1))),
             "terrain primary": (tiles, rays(1 << 20, "primary")),
             "terrain incoherent": (tiles, rays(1 << 20, "incoherent"))}
    out["kernel_ms"] = {}
    for name in ("tile_bvh", "tile_bvh8"):
        for load, (tl, ray) in loads.items():
            args, _unsort, _n = intersect.prepare_bvh(
                tl, ray, wide=name == "tile_bvh8")
            out["kernel_ms"][f"{name} {load}"] = cuda_ms(
                lambda: intersect._traverse_cuda(name, *args), reps=10)
    for load in ("terrain primary", "terrain incoherent"):
        args, _unsort, _n = intersect.prepare_sweep(*loads[load])
        out["kernel_ms"][f"tile_sweep {load}"] = cuda_ms(
            lambda: intersect.sweep(*args), reps=10)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
