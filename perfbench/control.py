#!/usr/bin/env python3
"""Readings that the comparison's limits are set from (not part of a run):

    python3 perfbench/control.py --workload <cell> --seeds 12 --films <n> \\
        --control-seeds 3 [--coplanar] --out <file.json>

- the program: for each of ``--seeds`` seeds, ``--films`` films as a run's
  window renders them and the run's own reference, through the run's
  comparison (the worst film of each number);
- the control: the reference put in the program's place and computed in
  bfloat16, the precision below the configuration's float32, one film a
  seed at the cell's own size, against the float32 reference;
- the faults at the cell's size, on the first seed: a film left as it
  was made (zeros), half of the samples left out (spp / 2), the radiance
  altered by 2 % and by 5 % where it is produced, a film returned twice;
- with ``--coplanar`` (atmosphere cells): the configuration's scene with
  its ground back at z = 0, coplanar with the slab's floor, as bench.py
  builds it, on three seeds, twice each, against the reference.

Runs on the CUDA card; prints one JSON line and writes it to ``--out``."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--films", type=int, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--coplanar", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import importlib

    import torch

    from perfbench import bench
    from perfbench.reference import common, compare

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    _spec, _cell, cfg, mix, limits = bench.resolve(args.workload)
    scenes = importlib.import_module(f"perfbench.scenes.{cfg['builder']}")
    entry = importlib.import_module(f"perfbench.entries.{mix['entry']}")
    reference = importlib.import_module(
        f"perfbench.reference.{cfg['builder']}")
    W, H, spp, block = mix["width"], mix["height"], mix["spp"], mix["block"]
    ref_spp = limits["reference_spp"]
    pick = lambda seed, stream: int(bench.seeds(seed, stream).integers(
        0, 2 ** 31 - 1))

    def ref_of(config, inputs, seed, dtype=torch.float32, n=ref_spp):
        return reference.render(config, inputs, W, H, n, pick(seed, 2),
                                dev, dtype)

    runner = entry.Runner(cfg, mix, scenes, dev)
    runner(pick(0, 0))
    runner.sync()
    log = lambda m: print(m, file=sys.stderr, flush=True)
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(),
           "power_limit": bench.power_limit(), "program": [], "control": [],
           "faults": {}, "coplanar": []}
    seed_list = [args.first_seed + 7919 * k for k in range(args.seeds)]
    first = None
    for seed in seed_list:
        draw = bench.seeds(seed, 1)
        t0 = time.perf_counter()
        films = [runner(int(draw.integers(0, 2 ** 31 - 1)))
                 for _ in range(args.films)]
        runner.sync()
        t1 = time.perf_counter()
        sums, counts = ref_of(cfg, runner.inputs, seed)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        nums = compare.run_numbers(films, sums, counts, spp, block)
        out["program"].append({"seed": seed, **nums,
                               "films_s": t1 - t0, "reference_s": t2 - t1})
        log(f"# program seed {seed}: {nums} (films {t1 - t0:.2f} s, "
            f"reference {t2 - t1:.2f} s)")
        if first is None:
            first = (seed, films[0], sums, counts)
    for seed in seed_list[:args.control_seeds]:
        t0 = time.perf_counter()
        s16, c16 = ref_of(cfg, runner.inputs, seed + 1, torch.bfloat16, spp)
        film = common.film_from_sums(s16.float(), c16)
        sums, counts = ref_of(cfg, runner.inputs, seed)
        nums = compare.run_numbers([film], sums, counts, spp, block)
        out["control"].append({"seed": seed, **nums,
                               "seconds": time.perf_counter() - t0})
        log(f"# control (bfloat16 reference) seed {seed}: {nums}")
    seed, film, sums, counts = first
    scale = lambda f, k: torch.cat([f[..., :3] * k, f[..., 3:]], -1)
    half = runner(pick(seed, 3), spp=spp // 2)
    for name, films in (("zeros", [torch.zeros_like(film)]),
                        ("half_samples", [half]),
                        ("altered_2pct", [scale(film, 1.02)]),
                        ("altered_5pct", [scale(film, 1.05)]),
                        ("returned_twice", [film, film])):
        out["faults"][name] = compare.run_numbers(films, sums, counts, spp,
                                                  block)
        log(f"# fault {name}: {out['faults'][name]}")
    if args.coplanar:
        runner.close()
        cop = {**cfg, "scene": {**cfg["scene"], "ground_z": 0.0}}
        r2 = entry.Runner(cop, mix, scenes, dev)
        for seed in seed_list[:3]:
            fa = r2(pick(seed, 1))
            fb = r2(pick(seed, 1))
            sums, counts = ref_of(cop, r2.inputs, seed)
            nums = compare.run_numbers([fa], sums, counts, spp, block)
            nums["repeat_equal"] = bool(torch.equal(fa, fb))
            nums["mean_y"] = float(fa[..., 1].sum() / fa[..., 4].sum())
            nums["ref_mean"] = float(sums.sum() / counts.sum())
            out["coplanar"].append({"seed": seed, **nums})
            log(f"# coplanar seed {seed}: {nums}")
    for k in ("block_chi2", "global_z"):
        lo = max(p[k] for p in out["program"])
        up = min(c[k] for c in out["control"]) if out["control"] else None
        log(f"# {k}: program max {lo!r} over {len(out['program'])} seeds, "
            f"control min {up!r}")
    line = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
