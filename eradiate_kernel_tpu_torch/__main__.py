"""Command-line renderer, the ``mitsuba`` CLI analog (src/mitsuba/mitsuba.cpp):

    python -m eradiate_kernel_tpu_torch scene.xml -o out.exr -D spp=256

Options mirror the reference's: -o output, -D key=value scene parameters,
-m variant mode, -s spp override, -t timeout in seconds, -p progress,
--regen the lane pool, --seed; and --device (cuda by default; cpu runs on
the CPU and is never chosen for the caller).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="eradiate_kernel_tpu_torch",
        description="PyTorch/CUDA differentiable renderer (Mitsuba-XML "
                    "scenes)")
    ap.add_argument("scene", help="scene file (.xml)")
    ap.add_argument("-o", "--output", default=None,
                    help="output image (.exr, .pfm, .ppm, .hdr or .png); "
                         "default: scene name with .exr")
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="key=value",
                    help="scene parameter substitution ($key in the XML)")
    ap.add_argument("-m", "--mode", default="rgb",
                    choices=["mono", "rgb", "spectral"],
                    help="variant mode (default rgb)")
    ap.add_argument("-s", "--spp", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("-t", "--timeout", type=float, default=None,
                    help="render timeout in seconds (partial image saved)")
    ap.add_argument("-p", "--progress", action="store_true",
                    help="show a progress bar")
    ap.add_argument("--regen", action="store_true",
                    help="regenerating lane-pool renderer (fastest primal "
                         "path for path/volpath; no progress/timeout "
                         "granularity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to render on (default cuda; cpu for the "
                         "CPU)")
    args = ap.parse_args(argv)

    from . import integrators
    from .core.types import Variant
    from .films import save
    from .scene import load_file
    from .utils import runtime

    params = {}
    for d in args.define:
        k, _, v = d.partition("=")
        params[k] = v

    t0 = time.time()
    scene = load_file(args.scene, Variant(args.mode), parameters=params,
                      device=args.device)
    print(f"loaded {args.scene!r} in {time.time() - t0:.2f}s "
          f"({scene.shape_bsdf.shape[0]} shapes, "
          f"{scene.config.film_width}x{scene.config.film_height}, "
          f"spp={args.spp or scene.config.spp}, "
          f"{scene.bsphere_center.device})", file=sys.stderr)

    t0 = time.time()
    if args.regen:
        film = integrators.render(scene, seed=args.seed, spp=args.spp,
                                  develop_film=False, regen=True)
    else:
        ctl = runtime.RenderController(timeout=args.timeout)
        film = runtime.render(scene, seed=args.seed, spp=args.spp,
                              progress=args.progress, controller=ctl,
                              develop_film=False)
    print(f"rendered in {time.time() - t0:.2f}s", file=sys.stderr)

    out = args.output or (args.scene.rsplit(".", 1)[0] + ".exr")
    save(out, film, scene.config.variant.mode, scene.config.pixel_format)
    print(f"wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
