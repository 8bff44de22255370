"""Is the bins integrator's sum over a partition of 360-830 nm, divided by
the range's width, the same estimand as the base film's Y? On a grey scene
both equal the flat radiance, so their gap must average to zero.

The scene is chip_smoke.py phase 36b's: bench.py's spectral distant
atmosphere (1x1 ``distant`` film, 64^3 sigma_t grid, max_depth 12,
residual NEE) under ``bins`` b1..b5 partitioning 360-830 nm. For each
sample count and each seed, one lane-pool render gives the gap
sum(bins) / 470 - Y. The script prints each gap, and for each sample count
the mean over the seeds with its standard error from their spread (the
seeds are independent; phase 36b's z-test estimates its variance from 8
batches of one seed).

    python tools/bins_sum_check.py                   # the port, on the card
    python tools/bins_sum_check.py --device cpu --grid-res 16 --spp 16384
    python tools/bins_sum_check.py --package jax --grid-res 16 --spp 16384

``--package jax`` renders with the JAX package on the CPU (the reference);
the default is the PyTorch port. ``--out FILE`` also writes the records as
JSON.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BINS = "b1:360:455,b2:455:550,b3:550:645,b4:645:740,b5:740:830"
WIDTH = 830.0 - 360.0


def scene_dict(atmosphere, spp, grid_res):
    d = atmosphere(spp=spp, max_depth=12, grid_res=grid_res, sensor="distant")
    d["integrator"]["nee_transmittance"] = "residual"
    d["integrator"] = {"type": "bins", "bins": BINS,
                       "child": d["integrator"]}
    return d


def renderer(package, device, lanes):
    """(atmosphere, render(scene_dict, seed) -> raw film as numpy)."""
    if package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from eradiate_kernel_tpu import integrators
        from eradiate_kernel_tpu.core.types import Variant
        from eradiate_kernel_tpu.scene import load_dict
        from eradiate_kernel_tpu.utils.scenes import atmosphere

        def render(d, seed):
            return np.asarray(integrators.render(
                load_dict(d, Variant("spectral")), seed=seed, regen=True,
                samples_per_pass=lanes, develop_film=False))
        return atmosphere, render

    import torch

    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    scenes = {}

    def render(d, seed):
        key = d["sensor"]["sampler"]["sample_count"]
        if key not in scenes:
            scenes[key] = load_dict(d, Variant("spectral"), device=device)
        film = integrators.render(scenes[key], seed=seed, regen=True,
                                  samples_per_pass=lanes, develop_film=False)
        if film.is_cuda:
            torch.cuda.synchronize()
        return film.cpu().numpy()
    return atmosphere, render


def gap_of(film):
    """sum(bins) / 470 - Y of a raw 1x1 film (Y, weight, then the bins)."""
    f = film.astype(np.float64)
    w = f[..., 4].sum()
    return f[..., 5:].sum() / w / WIDTH - f[..., 1].sum() / w


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cuda",
                    help="the port's device (the JAX package runs on the "
                         "CPU)")
    ap.add_argument("--spp", default="32768,65536",
                    help="comma-separated sample counts")
    ap.add_argument("--seeds", type=int, default=16,
                    help="seeds 1 .. N at each sample count")
    ap.add_argument("--grid-res", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=1 << 15)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    atmosphere, render = renderer(args.package, args.device, args.lanes)
    records = []
    for spp in (int(s) for s in args.spp.split(",")):
        d = scene_dict(atmosphere, spp, args.grid_res)
        gaps, ys = [], []
        t0 = time.perf_counter()
        for seed in range(1, args.seeds + 1):
            film = render(d, seed)
            gaps.append(float(gap_of(film)))
            ys.append(float(film[..., 1].sum() / film[..., 4].sum()))
            print(f"spp {spp} seed {seed}: Y {ys[-1]:.7f} gap "
                  f"{gaps[-1]:+.3e}", flush=True)
        g = np.asarray(gaps)
        se = float(g.std(ddof=1) / np.sqrt(len(g)))
        rec = dict(package=args.package, spp=spp,
                   device="cpu" if args.package == "jax" else args.device,
                   grid_res=args.grid_res, seeds=args.seeds,
                   mean_gap=float(g.mean()), std_err=se,
                   t=float(g.mean() / se), per_sample_sd=float(
                       g.std(ddof=1) * np.sqrt(spp)),
                   negative=int((g < 0).sum()), mean_y=float(np.mean(ys)),
                   gaps=gaps, seconds=time.perf_counter() - t0)
        records.append(rec)
        print(f"spp {spp}: mean gap {rec['mean_gap']:+.3e} over "
              f"{args.seeds} seeds, standard error {se:.3e}, t = "
              f"{rec['t']:+.2f}; {rec['negative']} of {args.seeds} negative; "
              f"per-sample sd {rec['per_sample_sd']:.3e}; mean Y "
              f"{rec['mean_y']:.7f}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    print(json.dumps([{k: v for k, v in r.items() if k != "gaps"}
                      for r in records]))


if __name__ == "__main__":
    main()
