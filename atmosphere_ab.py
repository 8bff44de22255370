"""Render time of the port's atmosphere loads through the
eradiate_kernel_tpu_torch package beside this script: the flagship
(256x256, spp 64, max_depth 12, a 64 x 4 x 4 grid) and the 64^3 grid at
spp 16, residual NEE, on the lane pool of 32,768 lanes (chip_smoke.py
phases 9-10). Needs one CUDA card; prints one JSON line with the card's
name, each render's seconds, loop iterations, host syncs and image mean.

To compare two checkouts on one card, copy this script into the root of
each and run the copies in turns within one session (A, B, B, A):

    python3 atmosphere_ab.py --label NAME
"""

import json
import sys
import time

import torch

LANES = 1 << 15
LOADS = {"flagship": (64, 64), "large3d": (16, (64, 64, 64))}


def main():
    if not torch.cuda.is_available():
        print("atmosphere_ab: no CUDA device", file=sys.stderr)
        return 2
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.films import develop
    from eradiate_kernel_tpu_torch.integrators import common
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    label = sys.argv[sys.argv.index("--label") + 1] \
        if "--label" in sys.argv else ""
    out = {"label": label, "device": torch.cuda.get_device_name(0)}
    for name, (spp, grid_res) in LOADS.items():
        d = atmosphere(256, 256, spp, 12, grid_res=grid_res)
        d["integrator"]["nee_transmittance"] = "residual"
        scene = load_dict(d)
        integrators.render_wavefront_regen(scene, LANES, 0, 1)  # warm-up
        torch.cuda.synchronize()
        common.counters["host_syncs"] = 0
        stats = {}
        t0 = time.perf_counter()
        film, _rays = integrators.render_wavefront_regen(scene, LANES, 0,
                                                         spp, stats=stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        out[name] = dict(
            render_s=seconds, msamples_per_s=256 * 256 * spp / seconds / 1e6,
            iterations=stats["iterations"],
            host_syncs=common.counters["host_syncs"],
            image_mean=float(develop(film).mean()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
