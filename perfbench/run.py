#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the CUDA card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints statistics on earlier lines, the
numbers the comparison checked beside their limits as the last lines on
standard error, and one JSON object as the last line on standard output.
Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), or when JAX or the JAX package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, heads the import path
sys.path[0] = ROOT
# one process with one CPU thread: the card's work is launched from one
# thread, and idle CPU threads only add jitter to the host's dispatch
os.environ["OMP_NUM_THREADS"] = "1"
# caches stay at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "perfbench", "out", "cache", sub)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from perfbench import bench

    _spec, cell, *_ = bench.resolve(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark does not run on the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    result = bench.run(args.workload, args.seed, args.seconds, args.trace,
                       device="cuda", t_start=T_START, log=log)
    found = bench.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
