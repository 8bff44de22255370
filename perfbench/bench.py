"""The harness: one run of one cell of BENCHMARK.json.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name:

- ``configs/<config>.json`` (the file BENCHMARK.json names): the scene's
  parameters and its ``builder``, the module ``scenes/<builder>.py`` that
  makes its inputs and ``reference/<builder>.py``, its plain reference;
- ``mixes/<traffic>.json``: the traffic, read by ``entries/<entry>.py``;
- ``cells/<workload>.json``: the reference's sample count and the limit
  of each number the comparison reports;
- ``metrics/<name>.py``: a per-layer metric's reader, ``read(ctx)``, which
  returns a number or None when it finds nothing to read.

A run: set-up (imports, the card, the scene, one warm-up film at the
cell's own shapes) until the first timed call; films back to back, each
with its own seed drawn from --seed, until --seconds have passed (whole
films); with --trace 1 a few more films under the profiler, with spans
around the mesh queries; then, with the program's state freed, the
reference and the comparison of every film of the run."""

import gc
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import devtrace, hooks, roofline

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "eradiate_kernel_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def resolve(workload, root=ROOT):
    """(spec, cell, config, mix, cell file) of ``workload``."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(root, conf["file"]))
    mix = load_json(os.path.join(HERE, "mixes", f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "cells", f"{workload}.json"))
    return spec, cell, cfg, mix, limits


def reports(spec, workload, kind):
    """The metrics of ``spec[kind]`` that cell ``workload`` reports."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def metric_reader(name):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def seeds(seed, stream):
    """The generator of one stream of a run's --seed (0: the warm-up film,
    1: the films, 2: the reference)."""
    return np.random.default_rng([int(seed), stream])


def forbidden_modules():
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
        return out.strip().splitlines()[0] if out.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def quantile(values, q):
    return float(np.quantile(np.asarray(values), q)) if values else None


def run(workload, seed, seconds, trace, device="cuda", t_start=None,
        overrides=None, log=print, program=None):
    """One run; returns the result dict (the line run.py prints).
    ``overrides`` ({"mix": {...}, "scene": {...}, "limits": {...}})
    shrink a cell for the CPU tests; ``program`` wraps the entry's runner
    (the tests break the timed path with it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec, cell, cfg, mix, limits = resolve(workload)
    overrides = overrides or {}
    mix = {**mix, **overrides.get("mix", {})}
    cfg = {**cfg, "scene": {**cfg["scene"], **overrides.get("scene", {})}}
    limits = {**limits, **overrides.get("limits", {})}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    scenes = importlib.import_module(f"perfbench.scenes.{cfg['builder']}")
    entry = importlib.import_module(f"perfbench.entries.{mix['entry']}")
    reference = importlib.import_module(
        f"perfbench.reference.{cfg['builder']}")

    runner = entry.Runner(cfg, mix, scenes, dev)
    call = runner if program is None else program(runner)
    film_seeds = seeds(seed, 1)
    draw = lambda: int(film_seeds.integers(0, 2 ** 31 - 1))
    warm_seed = int(seeds(seed, 0).integers(0, 2 ** 31 - 1))
    call(warm_seed)
    runner.sync()
    setup_s = time.perf_counter() - t_start

    films, times = [], []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        films.append(call(draw()))
        runner.sync()
        b = time.perf_counter()
        times.append(b - a)
        if b - t0 >= seconds:
            break
    window_s = b - t0
    rate = len(films) * runner.samples / window_s / 1e6
    log(f"# {workload}: {len(films)} films in {window_s:.4f} s; film time "
        f"median {statistics.median(times):.4f} s, p90 "
        f"{quantile(times, 0.9):.4f} s; {rate:.6f} Msamples/s; set-up "
        f"{setup_s:.4f} s")
    memory_peak = (torch.cuda.max_memory_allocated(dev) if on_card
                   else None)

    result = {"workload": workload, "seed": seed}
    if trace:
        per_layer, dev_extra, breakdown = _traced(
            workload, seed, spec, mix, cfg, scenes, runner, call, draw,
            films, rate, log)
        result["metrics"] = per_layer
        result["breakdown"] = breakdown
    else:
        dev_extra = {}
        values = {"msamples_per_s": rate, "setup_s": setup_s}
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in reports(spec, workload, "end_to_end")}

    # the program's state is freed before the reference runs
    inputs = runner.inputs
    runner.close()
    del runner, call
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    sums, counts = reference.render(
        cfg, inputs, mix["width"], mix["height"], limits["reference_spp"],
        int(seeds(seed, 2).integers(0, 2 ** 31 - 1)), dev)
    from .reference import compare

    numbers = compare.run_numbers(films, sums, counts, mix["spp"],
                                  mix["block"])
    log(f"# reference and comparison: {time.perf_counter() - t_ref:.4f} s "
        f"over {len(films)} films; the films' mean radiance over the "
        f"reference's: {compare.mean_ratio(films, sums, counts):.6f}")
    checks = {k: {"value": v, "limit": limits["limits"][k]}
              for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result.update({
        "correct": correct, "attempted": len(films),
        "failed": 0 if correct else len(films),
        "device": {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": memory_peak,
                   "visible_devices": (torch.cuda.device_count() if on_card
                                       else 0),
                   "power_limit": power_limit() if on_card else None,
                   **dev_extra},
        "checks": checks})
    return result


def _traced(workload, seed, spec, mix, cfg, scenes, runner, call, draw,
            films, rate, log):
    """Films under the profiler -> (per-layer metrics, device keys,
    breakdown)."""
    n = int(mix["trace_films"])
    with hooks.instrument(capture=True) as read:
        activities = [ProfilerActivity.CPU]
        if runner.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function(devtrace.WINDOW):
                t0 = time.perf_counter()
                for _ in range(n):
                    films.append(call(draw()))
                runner.sync()
                traced_s = time.perf_counter() - t0
        counts = read()
    traced_rate = n * runner.samples / traced_s / 1e6
    log(f"# traced: {n} films in {traced_s:.4f} s, {traced_rate:.6f} "
        f"Msamples/s against {rate:.6f} untraced (tracing overhead "
        f"{(rate / traced_rate - 1) * 100:.2f} %)")
    out_dir = os.path.join(HERE, "out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{workload}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    del prof
    try:
        summary = devtrace.reduce_file(path)
    finally:
        os.remove(path)
    log(f"# trace: window {summary['window_s']:.6f} s, busy "
        f"{summary['busy_s']:.6f} s, launches {summary['launches']}, "
        f"kernels without a launch record {summary['kernels_unmatched']}")
    work = None
    if counts["rays"]:
        V, F = scenes.triangles(cfg["scene"], runner.inputs)
        work = roofline.Work(V, F, runner.device)
        for r in counts["rays"]:
            work.add(r)
        counts["rays"] = None
        bound_s, by = work.bound()
        log(f"# tile_sweep work: {work.queries} queries, {work.rays} rays, "
            f"{work.tests:.6g} ray-triangle tests, {work.nbytes:.6g} bytes; "
            f"least time {bound_s:.6g} s ({by} bound) against "
            f"{summary['query_kernel_s']:.6g} s of query kernels")
    ctx = {"trace": summary, "counters": counts, "work": work,
           "samples": n * runner.samples, "films": n}
    per_layer = {}
    for m in reports(spec, workload, "per_layer"):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = {"device_ops": summary["device_ops"],
                 "idle_gaps": summary["idle_gaps"]}
    return per_layer, {"busy_s": summary["busy_s"],
                       "window_s": summary["window_s"]}, breakdown
