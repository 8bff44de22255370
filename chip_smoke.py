"""On-card smoke test of the PyTorch/CUDA port (eradiate_kernel_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. build every CUDA kernel of the port (tile_sweep, tile_bvh, tile_bvh8,
     grid_gather) from the repository's sources, one nvcc per source, in
     parallel, printing each kernel's registers and spills and a few
     instruction counts of its SASS;
  2. hold the tile-sweep kernel against its plain PyTorch version on the
     bench terrain (terrain(256): 130,050 triangles, 1,017 tiles: the
     sorted pipeline) with 2^20 coherent primary rays and 2^20 incoherent
     rays;
  3. render the terrain scene at full width (256x256 film, 16 spp, path
     tracer with max_depth 6, RPV surface, directional sun) through the
     port's ``load_dict`` and ``integrators.render``, counting kernel
     launches;
  4. render a 64x64, 4 spp version twice, through the kernel and through
     the plain sweep, and compare the films;
  5. hold each tile-BVH kernel (binary and 8-wide, walking in warps of
     ops/intersect.py's BVH_GROUP = 32 rays) against its plain version,
     bit for bit, visit counts included: terrain(256) through the BVH with
     the loads of phase 2, and the instanced forest (bench_mesh.py's
     bench_forest: one 2,048-triangle crown instanced 256 times, 4,096 BVH
     leaves) with 2^19 primary rays;
  6. render the forest at full width (256x256, 16 spp, max_depth 6, RPV
     ground, directional sun) through the binary BVH (the default policy)
     and through the 8-wide BVH (ERT_BVH_WIDE=1), counting launches; then
     once more with every launch synchronised and timed (the kernel stage:
     ms a launch) and its visits summed for the bound;
  7. render a 64x64, 4 spp forest through each BVH kernel and its plain
     version and compare the films;
  8. hold the row-gather kernel's gather entry against its plain version,
     bit for bit: on the gather probe's shape (4,096 rows of 1 float, 1,024
     lanes) and on the packed 8-corner table of a 64^3 grid with 32,768
     lanes of corner indices of random points, with the wrapper's host time
     piece by piece; then its fused trilinear entry against the plain chain
     on the 64^3 load, timed beside torch's grid_sample on the same grid;
  9. render the atmosphere (utils/scenes.atmosphere, bench.py's flagship
     load: 256x256 film, 64 spp, volpath max_depth 12, a 64 x 4 x 4
     plane-parallel grid, residual NEE transmittance) on the regenerating
     lane pool of 32,768 lanes, counting kernel launches (tile_sweep ==
     closest-hit queries: the atmosphere cube is one tile, one fused
     launch a query), loop iterations and host syncs;
 10. render the atmosphere with a 64^3 grid (bench.py's large3d) at 16 spp
     the same way; grid_gather launches == gridvolume lookups > 0 (one
     fused launch a lookup); then the fused query on the cube (32,768
     rays) and on an 8-tile terrain(23) against its plain version, bit for
     bit, timed beside the eager sorted pipeline; and the fused query
     against the sorted pipeline on 8-, 16- and 32-tile terrains under
     2^15 and 2^20 primary and incoherent rays (where the sort starts to
     pay);
 11. render a 64x64, 4 spp 64^3 atmosphere through the kernels, through
     the plain gather and through the plain sweep, and compare the films;
 13. hold the trilinear lookup's backward entry (grid_trilinear_bwd)
     against its plain version on phase 8's 64^3 load (32,768 lanes of
     random points, C = 1 and C = 3) within rtol 1e-5 and atol 1e-7 (its
     atomics add in an order that changes from run to run), and bit for
     bit on 32,768 lanes whose corners no two lanes share; timed beside
     the plain index_add_ chain and the backward of grid_sample;
 14. value+grad (the mean of the developed image with respect to the
     gridvolume grid, the albedo and the spectra, the sun's irradiance
     among them) of the flagship and of the 64^3 atmosphere at 256x256,
     spp 4 (the primal phases take 64 and 16; cut for the time limit),
     through autodiff.traverse, integrators.render(regen=True) and
     loss.backward() (the lane pool's path-replay backward): primal and
     value+grad times, forward and adjoint loop iterations, host syncs,
     launches of every kernel and entry in the forward and in the
     backward (grid_trilinear_bwd launches == gridvolume lookups of the
     adjoint > 0 on the 64^3 scene), threefry's share of a synchronised
     flagship value+grad, and the peak device memory; the film bit-equal
     to the primal render's, the gradients finite and not all zero; then
     the 64x64 spp4 value+grad of the 64^3 atmosphere through the kernels
     and through the plain gather and the plain sweep, gradients within
     phase 13's tolerance;
 12. (last) print the kernels line (every kernel and entry, the backward
     included), the value+grad records, the card's name and power limit,
     and the final ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --profile`` adds, before the report, a breakdown of
the full-width terrain, forest, flagship atmosphere and 64^3 atmosphere
renders: host time per stage (each stage synchronised before and after)
and a torch.profiler pass whose kernel tables go to
smoke_out/profile_<scene>.txt.
"""

import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# each kernel's device functions (profiler rows are matched by these names)
KERNEL_FUNCS = {"tile_sweep": ("tile_sweep_kernel", "tile_sweep_small_kernel"),
                "tile_bvh": ("tile_bvh_kernel",),
                "tile_bvh8": ("tile_bvh8_kernel",),
                "grid_gather": ("grid_gather_kernel", "grid_trilinear_kernel",
                                "grid_trilinear_bwd_kernel")}
# SASS opcode families counted per kernel function: the reciprocal and
# the calls of its slow path, 32- and 128-bit shared loads, async copies,
# barriers, global reductions (Hopper's REDG: atomics whose result is
# unused), FP32 arithmetic (an opcode counts under a family it equals or
# extends with a "." suffix; LDS only as itself)
SASS_OPS = ("MUFU.RCP", "CALL", "LDS", "LDS.128", "LDG.E.128", "LDGSTS",
            "BAR.SYNC", "BAR.RED", "WARPSYNC", "REDG", "FFMA", "FMUL",
            "FADD")


def terrain(n=256, seed=0):
    """Heightfield mesh over [-1,1]^2 with fractal bumps: 2*(n-1)^2 tris
    (the repository's bench_mesh.py terrain)."""
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


def make_rays(n_rays, kind, seed=1):
    """bench_mesh.py's ray loads: 'primary' (pinhole camera above the
    terrain looking down) or incoherent (random origins and directions)."""
    rng = np.random.default_rng(seed)
    if kind == "primary":
        o = np.array([0.0, -1.5, 1.2], np.float32)
        s = int(np.sqrt(n_rays))
        u = (np.arange(s) + 0.5) / s - 0.5
        U, Vv = np.meshgrid(u, u, indexing="ij")
        d = np.stack([U, 0.9 + 0.0 * U, -0.55 + 0.6 * Vv], axis=-1)
        d = d.reshape(-1, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.broadcast_to(o, d.shape)
        return o.astype(np.float32)[:n_rays], d.astype(np.float32)[:n_rays]
    o = rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(0.3, 1.0, n_rays)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def terrain_scene(V, F, width, height, spp, max_depth):
    """RPV terrain under a directional sun, seen by a perspective camera at
    the bench pose (o = (0, -1.5, 1.2), central direction (0, 0.9, -0.55);
    58 deg horizontal field of view spans the primary load's fan)."""
    return {
        "type": "scene",
        "terrain": {"type": "mesh", "vertices": V, "faces": F,
                    "bsdf": {"type": "rpv", "rho_0": 0.2, "g": -0.1,
                             "k": 0.7}},
        "sun": {"type": "directional", "direction": [0.3, 0.0, -0.94],
                "irradiance": 1.0},
        "camera": {
            "type": "perspective", "fov": 58.0,
            "to_world": {"type": "look_at", "origin": [0.0, -1.5, 1.2],
                         "target": [0.0, -0.6, 0.65], "up": [0, 0, 1]},
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
        "integrator": {"type": "path", "max_depth": max_depth},
    }


def forest_scene(width, height, spp, max_depth, n_inst=256):
    """bench_mesh.py's bench_forest: a terrain(33) crown scaled by 0.5
    (2,048 triangles in 16 tiles) in one shapegroup, instanced n_inst
    times, each a translate then a rotate about z placed from
    default_rng(4) as there; plus an RPV ground rectangle scaled by 9, the
    directional sun and a perspective camera from (0, -14, 7)."""
    rng = np.random.default_rng(4)
    V, F = terrain(33)
    d = {
        "type": "scene",
        "grp": {"type": "shapegroup",
                "crown": {"type": "mesh", "vertices": V * 0.5, "faces": F,
                          "bsdf": {"type": "diffuse"}}},
        "ground": {"type": "rectangle",
                   "to_world": {"type": "scale", "value": [9.0, 9.0, 1.0]},
                   "bsdf": {"type": "rpv", "rho_0": 0.2, "g": -0.1,
                            "k": 0.7}},
        "sun": {"type": "directional", "direction": [0.3, 0.0, -0.94],
                "irradiance": 1.0},
        "camera": {
            "type": "perspective", "fov": 60.0,
            "to_world": {"type": "look_at", "origin": [0.0, -14.0, 7.0],
                         "target": [0.0, 0.0, 0.0], "up": [0, 0, 1]},
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
        "integrator": {"type": "path", "max_depth": max_depth},
    }
    for i in range(n_inst):
        x, y = rng.uniform(-8, 8, 2)
        d[f"i{i}"] = {"type": "instance",
                      "shapegroup": {"type": "ref", "id": "grp"},
                      "to_world": [
                          {"type": "translate",
                           "value": [float(x), float(y),
                                     float(rng.uniform(0, 0.3))]},
                          {"type": "rotate", "axis": [0, 0, 1],
                           "angle": float(rng.uniform(0, 360))}]}
    return d


def sass_counts(name):
    """{kernel function: {opcode: count}} of kernel ``name``'s SASS, for the
    functions of KERNEL_FUNCS and the opcodes of SASS_OPS; None where the
    toolkit has no cuobjdump."""
    from eradiate_kernel_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    sass = subprocess.run([cuobjdump, "-sass", _build._so_path(name)],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    op_re = re.compile(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z0-9_.]+)")
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            cur = next((k for k in KERNEL_FUNCS[name] if k in fn), None)
            if cur is not None:
                counts.setdefault(cur, collections.Counter())
            continue
        m = op_re.search(line)
        if cur is not None and m:
            counts[cur][m.group(1)] += 1
    fam = lambda op, key: op == key or (key != "LDS"
                                         and op.startswith(key + "."))
    return {fn: {key: sum(n for op, n in c.items() if fam(op, key))
                 for key in SASS_OPS} for fn, c in counts.items()}


def cuda_ms(fn, reps):
    """Mean ms of fn() over reps runs, by CUDA events, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_once(fn):
    """(fn(), its ms by CUDA events) for one run without a warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes, ops):
    """(least ms, what bounds it): bytes over the HBM rate against FP32
    operations over the FP32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def tile_bytes(n_tiles):
    from eradiate_kernel_tpu_torch.ops import intersect

    return n_tiles * intersect.TILE_K * (9 * 4 + 2 * 4)


def sweep_bound(args, visited):
    """Least time (ms) the card could take for one sweep: the larger of
    bytes moved / HBM rate and FP32 operations / FP32 peak. Bytes: rays in,
    each visit's (id, tnear) pair, counts, the tile arrays once, outputs.
    Operations: tiles visited x 256 x 128 tests x FLOPS_PER_TEST."""
    from eradiate_kernel_tpu_torch.ops import intersect

    rays, count = args[0], args[2]
    n_pad, nb = rays.shape[0], count.shape[0]
    visits = int(visited.sum())
    nbytes = (n_pad * 32 + visits * 8 + nb * 4 + tile_bytes(args[4].shape[0])
              + n_pad * (4 + 8 + 4 + 4) + nb * 4)
    ops = visits * intersect.RAY_BLOCK * intersect.TILE_K \
        * intersect.FLOPS_PER_TEST
    return bound(nbytes, ops) + (visits,)


def bvh_bound(args, stats, wide):
    """Least time (ms) the card could take for one BVH traversal. Bytes:
    rays in, the tree, instance rows and packed tile rows once, outputs and
    stats. Operations: leaves visited x BVH_GROUP x 128 tests x
    FLOPS_PER_TEST, plus inner nodes visited x BVH_GROUP rays x (2 or 8)
    children x FLOPS_PER_SLAB, from the per-group stats. (The TPU's 256-ray
    walk tests more: 1.3-3.6x on these loads, PERF.md.)"""
    from eradiate_kernel_tpu_torch.ops import intersect

    rays, g = args[0], intersect.BVH_GROUP
    tree = sum(a.numel() * 4 for a in args[1:5])
    inner, leaves = (int(x) for x in stats[:, :2].sum(0))
    nbytes = (rays.shape[0] * (32 + 20) + stats.numel() * 4 + tree
              + args[5].numel() * 4)
    ops = (leaves * g * intersect.TILE_K * intersect.FLOPS_PER_TEST
           + inner * g * (8 if wide else 2) * intersect.FLOPS_PER_SLAB)
    return bound(nbytes, ops) + (inner, leaves)


def films_equivalent(a, b, max_flips, tol=1e-4):
    """tests/conftest.py::assert_driver_equivalent: per-pixel agreement to
    tol x max(|a|, 1) except at most max_flips pixels, which must stay
    finite and bounded. Returns the number of differing pixels."""
    diff = np.abs(a - b).max(axis=-1)
    scale = np.abs(a).max(axis=-1) + 1e-6
    bad = diff > tol * np.maximum(scale, 1.0)
    assert bad.sum() <= max_flips, \
        f"{bad.sum()} pixels diverged (budget {max_flips}); max {diff.max()}"
    if bad.any():
        assert np.isfinite(b).all()
        assert diff[bad].max() < 10 * (np.abs(a).mean() + 1.0)
    return int(bad.sum())


@contextlib.contextmanager
def stage_timers(stages):
    """Wrap each ``(module, attribute)`` function of ``stages`` (name ->
    pair; the stages must not call one another) so that it synchronises
    the card before and after and adds its host time (s) to the dict that
    is yielded."""
    spent = dict.fromkeys(stages, 0.0)
    saved = []

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return wrapper

    for name, (mod, attr) in stages.items():
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, timed(name, fn))
    try:
        yield spent
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def env(**values):
    """Set environment variables for the duration."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def profile_render(render, render_s, label, window=None):
    """Where a full-width render's time goes (``render()`` runs it); prints
    '#' lines and writes the profiler's kernel table to
    smoke_out/profile_<label>.txt. The profiler traces ``window()`` (a
    shorter steady run of the same loop) when given, else the render; a
    window is also timed without the profiler for its busy share."""
    from eradiate_kernel_tpu_torch import bsdfs, media, phase
    from eradiate_kernel_tpu_torch.core import rng
    from eradiate_kernel_tpu_torch.integrators import common
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.render import geometry

    stages = {
        "sweep pre-passes": (intersect, "prepare_sweep"),
        "sweep kernel": (intersect, "sweep"),
        "fused sweep query": (intersect, "sweep_small"),
        "bvh pre-passes": (intersect, "prepare_bvh"),
        "tile_bvh/tile_bvh8 kernel": (intersect, "traverse"),
        "volume lookups": (media, "volume_eval"),
        "threefry": (rng, "threefry2x32"),
        "surface interaction": (geometry, "compute_surface_interaction"),
        "bsdf sample": (bsdfs, "bsdf_sample"),
        "bsdf eval": (bsdfs, "bsdf_eval_pdf"),
        "flight profile setup": (media, "_flight_profile_setup"),
        "flight sample": (media, "_flight_sample"),
        "phase sample": (phase, "phase_sample"),
    }
    with stage_timers(stages) as spent:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    rest = total - sum(spent.values())
    parts = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in spent.items() if v)
    print(f"# {label} render stages (synchronised, ms): total "
          f"{total * 1e3:.1f}: {parts}, other {rest * 1e3:.1f}", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if window is not None:
        render = window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
    common.counters["host_syncs"] = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    counted_syncs = common.counters["host_syncs"]
    avgs = prof.key_averages()
    # device-side rows only: an aten op's row repeats its kernels' time
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    ours = {name: sum(e.self_device_time_total for e in kernels
                      if any(f in e.key for f in funcs))
            for name, funcs in KERNEL_FUNCS.items()}
    launches = sum(e.count for e in avgs if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    syncs = sum(e.count for e in avgs if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize"))
    os.makedirs("smoke_out", exist_ok=True)
    with open(os.path.join("smoke_out", f"profile_{label}.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=50))
    if busy_us == 0:
        print(f"# {label} render profile: the profiler saw no device time "
              "(busy share not measured)", flush=True)
        return
    ours_txt = ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in ours.items())
    what = "window" if window else "render"
    print(f"# {label} render profile: device kernel time "
          f"{busy_us / 1e3:.1f} ms ({ours_txt}), busy share "
          f"{busy_us / 1e6 / render_s:.3f} of the unprofiled {what} "
          f"({render_s * 1e3:.1f} ms), {busy_us / 1e6 / prof_s:.3f} of "
          f"the profiled one ({prof_s * 1e3:.1f} ms); kernel launches "
          f"{launches}, host syncs {syncs} (any_lane sites "
          f"{counted_syncs})", flush=True)
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)[:8]
    print(f"# {label} render profile, aten ops by device time (ms, calls): "
          + ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.1f} "
                      f"({e.count})" for e in ops), flush=True)


def zero_launches():
    """Set every kernel's launch count to 0."""
    from eradiate_kernel_tpu_torch.ops import gather, intersect

    for counts in (intersect.launches, gather.launches):
        for k in counts:
            counts[k] = 0


def all_launches():
    """Every kernel's launch count: name -> launches."""
    from eradiate_kernel_tpu_torch.ops import gather, intersect

    return {**intersect.launches, **gather.launches}


def counted_render(scene, prepare_name, **render_kw):
    """Render ``scene`` with every kernel's launch count set to 0 just
    before and read just after. Counts the path tracer's bounces and the
    closest-hit queries (calls of intersect.<prepare_name>). Returns
    (image, seconds, launches, bounces, queries, rays traced)."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.integrators import path
    from eradiate_kernel_tpu_torch.ops import intersect

    counts = {"bounces": 0, "queries": 0, "traced": 0.0}
    bounce = path._bounce
    prepare = getattr(intersect, prepare_name)

    def counted_bounce(*a, **kw):
        state = bounce(*a, **kw)
        counts["bounces"] += 1
        counts["traced"] = float(state.n_rays)
        return state

    def counted_prepare(*a, **kw):
        counts["queries"] += 1
        return prepare(*a, **kw)

    path._bounce = counted_bounce
    setattr(intersect, prepare_name, counted_prepare)
    try:
        torch.cuda.synchronize()
        zero_launches()
        counts.update(bounces=0, queries=0)
        t0 = time.perf_counter()
        img = integrators.render(scene, seed=0, **render_kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = all_launches()
    finally:
        path._bounce = bounce
        setattr(intersect, prepare_name, prepare)
    return (img, seconds, launches, counts["bounces"], counts["queries"],
            counts["traced"])


def check_render(label, scene, img, seconds, launches, bounces, queries,
                 traced, kernel, mean_range):
    """Print a full-width render's line and hold its launches to its
    closest-hit queries."""
    cfg = scene.config
    assert img.shape == (cfg.film_height, cfg.film_width, 3)
    n_samples = cfg.film_height * cfg.film_width * cfg.spp
    mean = float(img.mean())
    print(f"# {label}: {seconds * 1e3:.1f} ms, "
          f"{n_samples / seconds / 1e6:.3f} Msamples/s, rays traced "
          f"{traced:.0f}, bounces {bounces}, closest-hit queries {queries}, "
          f"launches {launches}, image mean {mean:.5f}", flush=True)
    assert bool(torch.isfinite(img).all()), f"{label}: non-finite pixels"
    assert mean_range[0] < mean < mean_range[1], \
        f"{label}: image mean {mean} out of {mean_range}"
    # every mesh query of the render went through the kernel: one camera or
    # bounce query per bounce, and one shadow query per bounce but the last
    # (a path at max_depth ends before next-event estimation)
    assert launches[kernel] == queries, \
        f"{label}: {launches[kernel]} {kernel} launches, {queries} queries"
    assert sum(launches.values()) == launches[kernel], \
        f"{label}: other kernels launched: {launches}"
    assert bounces >= 1 and queries >= 2 * bounces - 1, \
        f"{label}: {queries} queries for {bounces} bounces"
    return mean


def counted_regen(scene, n_lanes):
    """Render ``scene`` on the lane pool with every kernel's launch count
    and the host-sync count set to 0 just before and read just after.
    Counts the closest-hit queries (calls of intersect.prepare_sweep or
    of the fused query's intersect.prepare_small) and the gridvolume gather
    lookups (volumes._trilinear_gather calls). Returns (film, seconds,
    launches, counts)."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.integrators import common
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.textures import volumes

    counts = {"queries": 0, "lookups": 0}
    prepare, small = intersect.prepare_sweep, intersect.prepare_small
    trilinear = volumes._trilinear_gather

    def counted(fn, what):
        def wrapper(*a, **kw):
            counts[what] += 1
            return fn(*a, **kw)
        return wrapper

    intersect.prepare_sweep = counted(prepare, "queries")
    intersect.prepare_small = counted(small, "queries")
    volumes._trilinear_gather = counted(trilinear, "lookups")
    try:
        stats = {}
        torch.cuda.synchronize()
        zero_launches()
        common.counters["host_syncs"] = 0
        t0 = time.perf_counter()
        film, rays = integrators.render_wavefront_regen(
            scene, n_lanes, 0, scene.config.spp, stats=stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = all_launches()
        counts.update(stats, rays=float(rays),
                      host_syncs=common.counters["host_syncs"])
    finally:
        intersect.prepare_sweep = prepare
        intersect.prepare_small = small
        volumes._trilinear_gather = trilinear
    return film, seconds, launches, counts


def check_atmosphere(label, scene, film, seconds, launches, counts):
    """Print an atmosphere render's line and hold its launches to its
    queries and lookups. Returns the render's record."""
    from eradiate_kernel_tpu_torch.films import develop

    cfg = scene.config
    img = develop(film)
    assert img.shape == (cfg.film_height, cfg.film_width, 3)
    assert bool(torch.isfinite(img).all()), f"{label}: non-finite pixels"
    n_samples = cfg.film_height * cfg.film_width * cfg.spp
    assert float(film[..., 4].sum()) == n_samples, f"{label}: samples lost"
    mean = float(img.mean())
    rec = dict(render_ms=seconds * 1e3,
               msamples_per_s=n_samples / seconds / 1e6,
               mrays_per_s=counts["rays"] / seconds / 1e6,
               rays=counts["rays"], iterations=counts["iterations"],
               host_syncs=counts["host_syncs"], image_mean=mean,
               queries=counts["queries"], lookups=counts["lookups"],
               launches=launches)
    print(f"# {label}: {rec['render_ms']:.1f} ms, "
          f"{rec['msamples_per_s']:.3f} Msamples/s, "
          f"{rec['mrays_per_s']:.2f} Mrays/s ({counts['rays']:.0f} rays), "
          f"loop iterations {counts['iterations']}, host syncs "
          f"{counts['host_syncs']}, closest-hit queries {counts['queries']},"
          f" gridvolume gathers {counts['lookups']}, launches {launches}, "
          f"image mean {mean:.5f}", flush=True)
    assert 0.01 < mean < 2.0, f"{label}: image mean {mean}"
    # the atmosphere cube is one 12-triangle tile: every mesh query of the
    # render was one launch of the fused sweep, every large-grid lookup one
    # launch of the fused trilinear lookup, and nothing else was launched
    assert launches["tile_sweep"] == counts["queries"] > 0, \
        f"{label}: {launches['tile_sweep']} sweeps, {counts['queries']} queries"
    assert launches["grid_gather"] == counts["lookups"], \
        f"{label}: {launches['grid_gather']} gathers, {counts['lookups']} lookups"
    assert launches["tile_bvh"] == launches["tile_bvh8"] == 0, launches
    return rec


def gather_load(table, idx):
    """The row-gather kernel against its plain version on one load, bit
    for bit; times of the kernel, the plain version and index_select; the
    bound. Returns the load's record."""
    from eradiate_kernel_tpu_torch.ops import gather

    out = gather._gather_cuda(table, idx)
    ref = gather.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), "grid_gather differs from the plain gather"
    L, R = out.shape
    # bytes: each index read once, each gathered row read and written once
    nbytes = L * (idx.element_size() + 2 * R * 4)
    bound_ms, bound_by = bound(nbytes, 0)
    return dict(
        ms=cuda_ms(lambda: gather._gather_cuda(table, idx), reps=50),
        plain_ms=cuda_ms(lambda: gather.gather_rows_plain(table, idx),
                         reps=50),
        library_ms=cuda_ms(lambda: torch.index_select(table, 0, idx),
                           reps=50),
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0,
        rows=table.shape[0], row_floats=R, lanes=L,
        device_us={"kernel": device_us(
            lambda: gather._gather_cuda(table, idx), ("grid_gather",)),
            "index_select": device_us(
                lambda: torch.index_select(table, 0, idx))})


def device_us(fn, names=None, reps=200):
    """Mean device time (us) a call of fn() of the kernels whose names
    contain one of ``names`` (every kernel when None), by torch.profiler
    over reps back-to-back calls; None if the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and (names is None or any(n in e.key for n in names)))
    return total / reps if total else None


def gather_host_us(table, idx, n=2000, rounds=5):
    """Host time (us a call, time.perf_counter over n back-to-back calls,
    the median of ``rounds`` rounds that take the pieces in turn) of each
    piece of a gather launch: the generic dict-loop check (_build.check)
    and the lean direct one, the output allocation both ways, the stream
    lookup both ways, the ctypes call alone, the whole wrapper, and
    index_select."""
    from eradiate_kernel_tpu_torch.ops import _build, gather

    dev = table.device
    V, R = table.shape
    L = idx.shape[0]
    fn = gather._fn("grid_gather_launch")
    out = gather._gather_cuda(table, idx)
    raw = _build.stream(dev.index)
    assert raw == torch.cuda.current_stream(dev).cuda_stream
    launch = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), V, R, L,
              idx.dtype == torch.int64, R % 4 == 0, raw)
    pieces = {
        "generic check": lambda: _build.check(
            "grid_gather", {"table": (table, torch.float32, (V, R)),
                            "idx": (idx, idx.dtype, (L,))}, dev),
        "direct check": lambda: gather._check_rows(table, idx),
        "torch.empty": lambda: torch.empty(L, R, dtype=torch.float32,
                                           device=dev),
        "new_empty": lambda: table.new_empty((L, R)),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream": lambda: _build.stream(dev.index),
        "ctypes launch": lambda: fn(*launch),
        "wrapper": lambda: gather._gather_cuda(table, idx),
        "index_select": lambda: torch.index_select(table, 0, idx),
    }
    times = {name: [] for name in pieces}
    for _ in range(rounds):
        for name, f in pieces.items():
            f()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                f()
            times[name].append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
    return {name: float(np.median(t)) for name, t in times.items()}


def trilinear_load(grid, packed, slot, pl):
    """The fused trilinear lookup against the plain chain on one load, bit
    for bit; times of both and of grid_sample, the one PyTorch call that
    computes the same lookup (on the unpacked grid of one slot); the
    bound. Returns the load's record."""
    from eradiate_kernel_tpu_torch.ops import gather
    from eradiate_kernel_tpu_torch.textures import volumes

    grid_shape = grid.shape
    out = gather.grid_trilinear(packed, grid_shape, slot, pl)
    ref = volumes.trilinear_gather_plain(packed, grid_shape, slot, pl)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), "grid_trilinear differs from the plain chain"
    L, C = out.shape
    # grid_sample with align_corners=True maps g in [-1, 1] to g' = (g + 1)
    # / 2 * (n - 1) and clamps it to [0, n - 1] under 'border': the lookup's
    # clamp(p, 0, 1) * (n - 1), up to the rounding of p * 2 - 1
    assert grid_shape[0] == 1 and not bool(slot.any())
    vol = grid.permute(0, 4, 1, 2, 3).contiguous()
    g = (pl * 2 - 1).view(1, 1, 1, L, 3)

    def library():
        return torch.nn.functional.grid_sample(
            vol, g, mode="bilinear", padding_mode="border",
            align_corners=True)

    lib_err = float((library().reshape(C, L).T - out).abs().max())
    assert lib_err < 1e-5, f"grid_sample differs from the lookup by {lib_err}"
    # bytes: the point, the slot, the 8C-float row, the result; operations:
    # the corner setup (4 an axis) and 7 lerps of 3 a channel
    bound_ms, bound_by = bound(L * (12 + 4 + 8 * C * 4 + C * 4),
                               L * (12 + 21 * C))
    return dict(
        ms=cuda_ms(lambda: gather.grid_trilinear(packed, grid_shape, slot,
                                                 pl), reps=50),
        plain_ms=cuda_ms(lambda: volumes.trilinear_gather_plain(
            packed, grid_shape, slot, pl), reps=50),
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0,
        library_ms=cuda_ms(library, reps=50), library_max_abs_err=lib_err,
        rows=packed.shape[0], channels=C, lanes=L,
        device_us={"kernel": device_us(lambda: gather.grid_trilinear(
            packed, grid_shape, slot, pl), ("grid_trilinear",)),
            "plain chain": device_us(lambda: volumes.trilinear_gather_plain(
                packed, grid_shape, slot, pl)),
            "grid_sample": device_us(library)})


def trilinear_bwd_load(grid, slot, pl, ct):
    """The lookup's backward kernel against its plain version on one load:
    rtol 1e-5 and atol 1e-7 on d_grid, since the atomics add in an order
    that changes from run to run; times of both and of the one PyTorch call
    that computes the same gradient, torch.autograd.grad of grid_sample
    with respect to the unpacked grid (its backward alone: the forward is
    kept with retain_graph); the bound. Returns the load's record."""
    from eradiate_kernel_tpu_torch.ops import gather
    from eradiate_kernel_tpu_torch.textures import volumes

    shape = tuple(grid.shape)
    out = gather.grid_trilinear_bwd(ct, shape, slot, pl)
    ref = volumes.trilinear_backward_plain(ct, shape, slot, pl)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-7)
    err = float((out - ref).abs().max())
    L, C = ct.shape
    assert shape[0] == 1 and not bool(slot.any())
    vol = grid.permute(0, 4, 1, 2, 3).contiguous().requires_grad_()
    with torch.enable_grad():
        sampled = torch.nn.functional.grid_sample(
            vol, (pl * 2 - 1).view(1, 1, 1, L, 3), mode="bilinear",
            padding_mode="border", align_corners=True)
    ct_lib = ct.T.reshape(1, C, 1, 1, L).contiguous()

    def library():
        return torch.autograd.grad(sampled, vol, ct_lib, retain_graph=True)[0]

    # grid_sample's fractions differ from the lookup's by the rounding of
    # p * 2 - 1 (trilinear_load), so its gradient differs by as much
    lib_err = float((library().permute(0, 2, 3, 4, 1) - out).abs().max())
    assert lib_err < 1e-4, f"grid_sample's gradient differs by {lib_err}"
    # bytes: the point, the slot and the cotangent read, 8C floats of
    # atomics; operations: the corner setup (12) and 14 a channel
    bound_ms, bound_by = bound(L * (12 + 4 + 4 * C) + L * 8 * C * 4,
                               L * (12 + 14 * C))
    return dict(
        ms=cuda_ms(lambda: gather.grid_trilinear_bwd(ct, shape, slot, pl),
                   reps=50),
        plain_ms=cuda_ms(lambda: volumes.trilinear_backward_plain(
            ct, shape, slot, pl), reps=50),
        library_ms=cuda_ms(library, reps=50), library_max_abs_err=lib_err,
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
        channels=C, lanes=L,
        device_us={"kernel": device_us(lambda: gather.grid_trilinear_bwd(
            ct, shape, slot, pl), ("grid_trilinear_bwd",)),
            "plain": device_us(lambda: volumes.trilinear_backward_plain(
                ct, shape, slot, pl)),
            "grid_sample backward": device_us(library)})


def distinct_corner_lanes(n, dev, gen):
    """Lanes at every other voxel of an n^3 grid along each axis plus a
    fraction in [0.1, 0.9]: no two lanes share a corner."""
    ar = torch.arange(0, n - 1, 2, device=dev)
    z, y, x = torch.meshgrid(ar, ar, ar, indexing="ij")
    idx = torch.stack([x.flatten(), y.flatten(), z.flatten()], -1)
    frac = 0.1 + 0.8 * torch.rand(idx.shape, generator=gen).to(dev)
    return (idx + frac) / (n - 1)


def value_grad(scene, n_lanes, keys, threefry=False):
    """The lane pool's value+grad of the developed image's mean with
    respect to the ParameterMap keys ``keys``, through the user's entry
    points (autodiff.traverse, integrators.render(regen=True),
    loss.backward()), after a primal render of the same scene and seed.
    Every count is set to 0 just before the value+grad and read after its
    forward and after its backward: kernel launches, closest-hit queries
    and gridvolume lookups, loop iterations, host syncs. With
    ``threefry``, one more value+grad with every threefry call
    synchronised and timed (its share of that run). Returns (record, the
    parameters with their .grad)."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core import rng
    from eradiate_kernel_tpu_torch.films import develop
    from eradiate_kernel_tpu_torch.integrators import common, replay
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.textures import volumes
    from eradiate_kernel_tpu_torch.utils import autodiff

    pm = autodiff.traverse(scene).keep(keys)
    render = lambda sc: integrators.render(
        sc, seed=0, samples_per_pass=n_lanes, regen=True, develop_film=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    primal = render(scene)
    torch.cuda.synchronize()
    primal_s = time.perf_counter() - t0

    counts = {"queries": 0, "lookups": 0}
    small, trilinear = intersect.prepare_small, volumes._trilinear_gather

    def counted(fn, what):
        def wrapper(*a, **kw):
            counts[what] += 1
            return fn(*a, **kw)
        return wrapper

    def snapshot():
        return dict(launches=all_launches(), **counts,
                    host_syncs=common.counters["host_syncs"],
                    **replay.counters)

    intersect.prepare_small = counted(small, "queries")
    volumes._trilinear_gather = counted(trilinear, "lookups")
    try:
        params = pm.trainable()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        common.counters["host_syncs"] = 0
        replay.counters.update(forward_iterations=0, adjoint_iterations=0)
        t0 = time.perf_counter()
        film = render(pm.with_trainable(params))
        loss = develop(film).mean()
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        fwd = snapshot()
        loss.backward()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        end = snapshot()
        peak = torch.cuda.max_memory_allocated()
    finally:
        intersect.prepare_small = small
        volumes._trilinear_gather = trilinear
    bwd = {k: ({kk: vv - fwd[k][kk] for kk, vv in v.items()}
               if isinstance(v, dict) else v - fwd[k])
           for k, v in end.items()}
    assert torch.equal(film.detach(), primal), \
        "the value+grad film differs from the primal render's"
    rec = dict(primal_ms=primal_s * 1e3, value_grad_ms=total_s * 1e3,
               forward_ms=forward_s * 1e3,
               backward_ms=(total_s - forward_s) * 1e3,
               value_grad_over_primal=total_s / primal_s,
               forward=fwd, backward=bwd, peak_bytes=peak,
               loss=float(loss.detach()))
    if threefry:
        with stage_timers({"threefry": (rng, "threefry2x32")}) as spent:
            p2 = pm.trainable()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            develop(render(pm.with_trainable(p2))).mean().backward()
            torch.cuda.synchronize()
            sync_s = time.perf_counter() - t0
        rec.update(threefry_ms=spent["threefry"] * 1e3,
                   synchronised_ms=sync_s * 1e3,
                   threefry_share=spent["threefry"] / sync_s)
    return rec, params


def check_value_grad(label, scene, rec, params):
    """Print a value+grad's line and hold it to its counts: one sweep
    launch a closest-hit query and one lookup launch a gridvolume lookup,
    forward and adjoint, one backward launch a lookup of the adjoint, and
    finite gradients that are not all zero (the spectra on the sun's row:
    the RPV rows' gradient is NaN in the reference too, ROADMAP Queue
    3)."""
    a = {k: v.detach().cpu().numpy() for k, v in scene.tensors().items()}
    sun = int(a["spec_slot"][a["emitters.directional.irradiance"][0]])
    grads = {}
    for k, p in params.items():
        g = p.grad[sun] if k == "spectra.baked.value" else p.grad
        assert g is not None and bool(torch.isfinite(g).all()), \
            f"{label}: {k} gradient not finite"
        assert bool(g.abs().sum() > 0), f"{label}: {k} gradient all zero"
        grads[k] = float(g.abs().sum())
    rec["grad_abs_sums"] = grads
    fwd, bwd = rec["forward"], rec["backward"]
    for part in (fwd, bwd):
        la = part["launches"]
        assert la["tile_sweep"] == part["queries"] > 0, (label, part)
        assert la["grid_gather"] == part["lookups"], (label, part)
        assert la["tile_bvh"] == la["tile_bvh8"] == 0, (label, part)
    assert fwd["launches"]["grid_trilinear_bwd"] == 0, (label, fwd)
    assert bwd["launches"]["grid_trilinear_bwd"] == bwd["lookups"], \
        (label, bwd)
    print(f"# {label} value+grad: primal {rec['primal_ms']:.1f} ms, "
          f"value+grad {rec['value_grad_ms']:.1f} ms (forward "
          f"{rec['forward_ms']:.1f}, backward {rec['backward_ms']:.1f}; "
          f"{rec['value_grad_over_primal']:.2f}x the primal), loop "
          f"iterations forward {fwd['forward_iterations']} adjoint "
          f"{bwd['adjoint_iterations']}, host syncs forward "
          f"{fwd['host_syncs']} backward {bwd['host_syncs']}, launches "
          f"forward {fwd['launches']} backward {bwd['launches']}, "
          f"closest-hit queries {fwd['queries']} + {bwd['queries']}, "
          f"gridvolume lookups {fwd['lookups']} + {bwd['lookups']}, peak "
          f"memory {rec['peak_bytes'] / 2**20:.1f} MiB, loss "
          f"{rec['loss']:.6f}, |grad| sums {grads}"
          + (f", threefry {rec['threefry_ms']:.1f} ms of a synchronised "
             f"{rec['synchronised_ms']:.1f} ms run (share "
             f"{rec['threefry_share']:.3f})" if "threefry_ms" in rec
             else ""), flush=True)
    return rec


def small_query_load(tiles, ray):
    """One closest-hit query of a small tile set through intersect_tiles:
    one counted launch of the fused query, bit-equal to its plain version
    (visits included); the eager sorted pipeline's sweep bit-equal to its
    plain version and its t equal to the fused query's; times of the fused
    query, its plain version, the eager pipeline and the eager pipeline's
    kernel alone; the bound. Returns the load's record."""
    from eradiate_kernel_tpu_torch.ops import intersect

    n = ray.o.shape[0]
    args = intersect.prepare_small(tiles, ray)
    before = intersect.launches["tile_sweep"]
    out = intersect.intersect_tiles(tiles, ray, return_visited=True)
    torch.cuda.synchronize()
    assert intersect.launches["tile_sweep"] == before + 1, \
        "the fused query is not one tile_sweep launch"
    ref = intersect._sweep_small_plain(*args)
    for what, a, b in zip(("t", "uv", "prim", "shape", "visits"), out, ref):
        assert torch.equal(a, b), f"fused sweep: {what} differs"
    eager_args, _unsort, _n = intersect.prepare_sweep(tiles, ray)
    e_out = intersect.sweep(*eager_args)
    e_ref = intersect._sweep_plain(*eager_args)
    for what, a, b in zip(("t", "uv", "prim", "shape", "visits"), e_out,
                          e_ref):
        assert torch.equal(a, b), f"sorted sweep: {what} differs"
    e_full = intersect.intersect_tiles_sorted(tiles, ray)
    assert torch.equal(e_full[0], out[0]), "fused and sorted t differ"
    T = tiles["lo"].shape[0]
    nb = out[4].shape[0]
    visits, eager_visits = int(out[4].sum()), int(e_out[4].sum())
    # bytes: the ray fields, the root and tile boxes and the tiles once, the
    # outputs; operations: tiles visited x 256 x 128 tests, counting the
    # visits the query needs: the fewer of the two orders' (the unsorted
    # blocks' extra visits are the fused query's own cost)
    nbytes = n * 32 + 24 + T * 24 + tile_bytes(T) + n * 20 + nb * 4
    ops = (min(visits, eager_visits) * intersect.RAY_BLOCK * intersect.TILE_K
           * intersect.FLOPS_PER_TEST)
    bound_ms, bound_by = bound(nbytes, ops)
    return dict(
        ms=cuda_ms(lambda: intersect.intersect_tiles(tiles, ray), reps=50),
        plain_ms=cuda_ms(lambda: intersect._sweep_small_plain(*args),
                         reps=5),
        eager_pipeline_ms=cuda_ms(
            lambda: intersect.intersect_tiles_sorted(tiles, ray), reps=20),
        eager_kernel_ms=cuda_ms(lambda: intersect.sweep(*eager_args),
                                reps=50),
        bound_ms=bound_ms, bound_by=bound_by, visits=visits,
        eager_visits=eager_visits, fused_extra_visits=visits - eager_visits,
        tiles=T, rays=n,
        device_us={"kernel": device_us(
            lambda: intersect.intersect_tiles(tiles, ray),
            ("tile_sweep_small",), reps=50),
            "eager pipeline": device_us(
                lambda: intersect.intersect_tiles_sorted(tiles, ray),
                reps=20)},
        hit_frac=float(torch.isfinite(out[0]).float().mean()),
        max_abs_err=0.0)


def crossover_load(tiles, ray):
    """The fused query (unsorted, one launch) against the sorted pipeline
    on a tile set that either can serve, whatever SWEEP_FUSED_MAX_TILES
    routes: the same t; the time and the tile visits of each. Returns the
    load's record."""
    from eradiate_kernel_tpu_torch.ops import intersect

    def fused():
        return intersect.sweep_small(*intersect.prepare_small(tiles, ray))

    def srt():
        return intersect.intersect_tiles_sorted(tiles, ray,
                                                return_visited=True)

    f_out, s_out = fused(), srt()
    assert torch.equal(f_out[0], s_out[0]), "fused and sorted t differ"
    rec = dict(tiles=tiles["lo"].shape[0], rays=ray.o.shape[0],
               fused_ms=cuda_ms(fused, reps=10),
               sorted_ms=cuda_ms(srt, reps=10),
               fused_visits=int(f_out[4].sum()),
               sorted_visits=int(s_out[4].sum()))
    rec["fused_over_sorted"] = rec["fused_ms"] / rec["sorted_ms"]
    return rec


def check_bvh_load(name, tiles, ray, n_rays):
    """One BVH kernel against its plain version on one ray load: hits and
    stats bit for bit; times of the kernel, the plain version and the full
    query; the bound. Returns the load's record."""
    from eradiate_kernel_tpu_torch.ops import intersect

    wide = name == "tile_bvh8"
    args, _unsort, _n = intersect.prepare_bvh(tiles, ray, wide=wide)
    out = intersect._traverse_cuda(name, *args)
    ref, plain_ms = cuda_once(lambda: intersect._PLAIN_WALKS[name](*args))
    hit = torch.isfinite(out[0]) & torch.isfinite(ref[0])
    max_err = (float((out[0][hit] - ref[0][hit]).abs().max())
               if hit.any() else 0.0)
    for what, a, b in zip(("t", "uv", "prim", "shape", "stats"), out, ref):
        assert torch.equal(a, b), f"{name}: {what} differs from the plain"
    deepest = int(out[4][:, 2].max())
    assert deepest <= intersect.STACK_SIZE, f"{name}: stack overflow"
    ms = cuda_ms(lambda: intersect._traverse_cuda(name, *args), reps=10)
    full_ms = cuda_ms(lambda: intersect.intersect_bvh(tiles, ray, wide=wide),
                      reps=5)
    bound_ms, bound_by, inner, leaves = bvh_bound(args, out[4], wide)
    hit = torch.isfinite(out[0][:n_rays])
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_err,
                bound_ms=bound_ms, bound_by=bound_by, inner_visits=inner,
                leaf_visits=leaves, deepest_stack=deepest,
                hit_frac=float(hit.float().mean()),
                intersect_ms=full_ms, mrays_per_s=n_rays / full_ms / 1e3)


def render_kernel_stage(scene, name):
    """Render ``scene`` once with every BVH traversal synchronised before
    and after and its host time summed (the kernel stage), and the bound
    summed over the launches from each launch's visits. Returns the
    stage's record."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.ops import intersect

    wide = name == "tile_bvh8"
    traverse = intersect.traverse
    rec = dict(stage_ms=0.0, launches=0, bound_ms=0.0, inner_visits=0,
               leaf_visits=0, bound_by=collections.Counter())

    def timed(nm, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = traverse(nm, *args)
        torch.cuda.synchronize()
        rec["stage_ms"] += (time.perf_counter() - t0) * 1e3
        rec["launches"] += 1
        b_ms, b_by, inner, leaves = bvh_bound(args, out[4], wide)
        rec["bound_ms"] += b_ms
        rec["bound_by"][b_by] += 1
        rec["inner_visits"] += inner
        rec["leaf_visits"] += leaves
        return out

    saved = dict(intersect.launches)
    intersect.traverse = timed
    try:
        integrators.render(scene, seed=0)
    finally:
        intersect.traverse = traverse
        intersect.launches.update(saved)
    rec["ms_per_launch"] = rec["stage_ms"] / rec["launches"]
    rec["bound_ms_per_launch"] = rec["bound_ms"] / rec["launches"]
    rec["bound_by"] = rec["bound_by"].most_common(1)[0][0]
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core.ray import Ray
    from eradiate_kernel_tpu_torch.ops import _build, bvh, gather, intersect
    from eradiate_kernel_tpu_torch.ops.accel import pack_tiles
    from eradiate_kernel_tpu_torch.scene import build, load_dict
    from eradiate_kernel_tpu_torch.textures import volumes
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    dev = torch.device("cuda")
    # the reference pins float32 matmuls to full precision; so does the port
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    print(f"# device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_kernels(verbose=True)
    assert set(secs) == {"tile_sweep", "tile_bvh", "tile_bvh8",
                         "grid_gather"}, secs
    print(f"# build: {', '.join(f'{k} {v:.2f} s' for k, v in secs.items())}"
          f" (in parallel, {time.perf_counter() - t0:.2f} s in all)",
          flush=True)
    # the leaves' reciprocal (__frcp_rn), staging (LDGSTS), 128-bit shared
    # or global loads, and the barriers a kernel build takes (BAR: block,
    # WARPSYNC: warp)
    for name in ("tile_sweep", "tile_bvh", "tile_bvh8", "grid_gather"):
        for fn, ops in (sass_counts(name) or {name: "no cuobjdump"}).items():
            print(f"# SASS {fn}: {ops}", flush=True)

    # ---- 2. tile sweep vs plain on the bench terrain --------------------------
    V, F = terrain(256)
    tiles_np = pack_tiles(V, F, np.zeros(len(F), np.int32))
    tiles = {k: torch.as_tensor(v, device=dev) for k, v in tiles_np.items()}
    # the tables a scene's Geometry builds once at load
    tiles["root"], tiles["rows"] = intersect.sweep_tables(tiles)
    print(f"# terrain: {len(F)} triangles, {len(tiles_np['lo'])} tiles",
          flush=True)
    n_rays = 1 << 20
    terrain_rays = {}
    loads = {}
    max_err = 0.0
    for kind in ("primary", "incoherent"):
        o, d = make_rays(n_rays, kind)
        ray = Ray.make(torch.as_tensor(o, device=dev),
                       torch.as_tensor(d, device=dev))
        terrain_rays[kind] = ray
        args, _unsort, _n = intersect.prepare_sweep(tiles, ray)
        out = intersect.sweep(*args)
        ref = intersect._sweep_plain(*args)
        torch.cuda.synchronize()
        t_k, uv_k, prim_k, shape_k, vis_k = out
        t_p, uv_p, prim_p, shape_p, vis_p = ref
        miss_k, miss_p = torch.isinf(t_k), torch.isinf(t_p)
        assert torch.equal(miss_k, miss_p), f"{kind}: miss sets differ"
        hit = ~miss_k
        err = float((t_k[hit] - t_p[hit]).abs().max()) if hit.any() else 0.0
        max_err = max(max_err, err)
        # bit-exact: both evaluate the same float32 expressions in the same
        # order with every product and sum rounded (-fmad=false)
        assert torch.equal(t_k, t_p), f"{kind}: t differs (max {err})"
        assert torch.equal(uv_k, uv_p), f"{kind}: uv differs"
        assert torch.equal(prim_k, prim_p) and torch.equal(shape_k, shape_p), \
            f"{kind}: prim/shape differ"
        assert torch.equal(vis_k, vis_p), f"{kind}: visit counts differ"
        ms = cuda_ms(lambda: intersect.sweep(*args), reps=10)
        plain_ms = cuda_ms(lambda: intersect._sweep_plain(*args), reps=1)
        full_ms = cuda_ms(lambda: intersect.intersect_tiles(tiles, ray),
                          reps=5)
        bound_ms, bound_by, visits = sweep_bound(args, vis_k)
        loads[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, visits=visits,
                           hit_frac=float(hit.float().mean()),
                           intersect_tiles_ms=full_ms)
        print(f"# sweep {kind}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.3f} ms ({bound_by}), tiles visited "
              f"{visits} ({visits / args[2].shape[0]:.1f}/block), hits "
              f"{loads[kind]['hit_frac']:.3f}, intersect_tiles "
              f"{full_ms:.3f} ms ({n_rays / full_ms / 1e3:.1f} Mrays/s)",
              flush=True)

    # ---- 3. full-width terrain render through the port's entry points -------
    scene = load_dict(terrain_scene(V, F, 256, 256, 16, 6))
    integrators.render(scene, seed=0, spp=1)  # warm-up (allocator)
    img, render_s, launches, bounces, queries, traced = counted_render(
        scene, "prepare_sweep")
    check_render("render 256x256 spp16 max_depth 6", scene, img, render_s,
                 launches, bounces, queries, traced, "tile_sweep",
                 (0.005, 0.5))
    sweep_launches = launches["tile_sweep"]

    # ---- 4. whole path: kernel vs plain sweep --------------------------------
    small = load_dict(terrain_scene(V, F, 64, 64, 4, 6))
    film_k = integrators.render(small, seed=3, develop_film=False)
    with intersect.use_plain():
        film_p = integrators.render(small, seed=3, develop_film=False)
    flips = films_equivalent(film_p.cpu().numpy(), film_k.cpu().numpy(),
                             max_flips=2)
    print(f"# whole path 64x64 spp4: kernel vs plain films agree "
          f"({flips} pixels over tolerance, budget 2)", flush=True)

    # ---- 5. BVH kernels vs plain: terrain(256) and the forest ---------------
    t0 = time.perf_counter()
    nbox, nmeta, depth = bvh.build_tile_bvh(tiles_np["lo"], tiles_np["hi"])
    cbox, cmeta = bvh.collapse_to_bvh8(nbox, nmeta)
    print(f"# terrain BVH: depth {depth}, {len(nmeta)} binary nodes, "
          f"{len(cbox)} 8-wide nodes, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for k, v in dict(nbox=nbox, nmeta=nmeta, cbox=cbox, cmeta=cmeta).items():
        tiles[k] = torch.as_tensor(v, device=dev)

    bvh_build_s = [0.0]
    build_tile_bvh = build.build_tile_bvh

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = build_tile_bvh(*a, **kw)
        bvh_build_s[0] += time.perf_counter() - t0
        return out

    build.build_tile_bvh = timed_build
    try:
        t0 = time.perf_counter()
        forest = load_dict(forest_scene(256, 256, 16, 6))
        load_s = time.perf_counter() - t0
    finally:
        build.build_tile_bvh = build_tile_bvh
    geo = forest.geo
    n_leaves = (geo.bvh_meta[:, 2] >= 0).sum().item()
    print(f"# forest: {geo.n_instances} instances x {geo.ig_faces.shape[0]} "
          f"shared triangles (= {geo.n_instances * geo.ig_faces.shape[0]} "
          f"effective), {geo.tiles_v0.shape[0]} group tiles, {n_leaves} BVH "
          f"leaves, {geo.bvh8_box.shape[0]} 8-wide nodes; load_dict "
          f"{load_s:.2f} s of which the binary BVH build "
          f"{bvh_build_s[0]:.2f} s", flush=True)
    forest_tiles = geo.tiles()
    n_forest = 1 << 19
    o, d = make_rays(n_forest, "primary")
    o = o * np.float32([8, 8, 1])  # bench_forest's wider camera footprint
    forest_ray = Ray.make(torch.as_tensor(o, device=dev),
                          torch.as_tensor(d, device=dev))

    bvh_loads = {}
    for name in ("tile_bvh", "tile_bvh8"):
        for load, (tl, ray, n) in {
                "forest": (forest_tiles, forest_ray, n_forest),
                "terrain primary": (tiles, terrain_rays["primary"], n_rays),
                "terrain incoherent": (tiles, terrain_rays["incoherent"],
                                       n_rays)}.items():
            rec = check_bvh_load(name, tl, ray, n)
            bvh_loads[(name, load)] = rec
            print(f"# {name} {load}: kernel {rec['ms']:.3f} ms, plain "
                  f"{rec['plain_ms']:.1f} ms (bit-equal), bound "
                  f"{rec['bound_ms']:.3f} ms "
                  f"({rec['bound_by']}), inner nodes {rec['inner_visits']}, "
                  f"leaves {rec['leaf_visits']}, deepest stack "
                  f"{rec['deepest_stack']}, hits {rec['hit_frac']:.3f}, "
                  f"intersect {rec['intersect_ms']:.3f} ms "
                  f"({rec['mrays_per_s']:.1f} Mrays/s)", flush=True)
    for name in ("tile_bvh", "tile_bvh8"):
        for kind in ("primary", "incoherent"):
            ratio = (loads[kind]["intersect_tiles_ms"]
                     / bvh_loads[(name, f"terrain {kind}")]["intersect_ms"])
            print(f"# terrain {kind}: {name} over tiles {ratio:.3f} "
                  "(Mrays/s ratio, full queries)", flush=True)

    # ---- 6. full-width forest renders through each BVH kernel ---------------
    integrators.render(forest, seed=0, spp=1)  # warm-up (allocator)
    forest_runs = {}
    for name, wide in (("tile_bvh", "0"), ("tile_bvh8", "1")):
        with env(ERT_BVH_WIDE=wide):
            img, secs_r, launches, bounces, queries, traced = counted_render(
                forest, "prepare_bvh")
        label = f"forest render 256x256 spp16 max_depth 6 ({name})"
        mean = check_render(label, forest, img, secs_r, launches, bounces,
                            queries, traced, name, (0.005, 0.5))
        cfg = forest.config
        n_samples = cfg.film_height * cfg.film_width * cfg.spp
        forest_runs[name] = dict(render_ms=secs_r * 1e3,
                                 msamples_per_s=n_samples / secs_r / 1e6,
                                 launches=launches[name], queries=queries,
                                 image_mean=mean)
        # the render's own queries (the bounces' rays): its kernel stage
        # with each launch synchronised, ms a launch beside the bound
        with env(ERT_BVH_WIDE=wide):
            stage = render_kernel_stage(forest, name)
        forest_runs[name]["kernel"] = stage
        print(f"# forest render ({name}) kernel stage "
              f"{stage['stage_ms']:.1f} ms over {stage['launches']} "
              f"launches, {stage['ms_per_launch']:.3f} ms a launch, bound "
              f"{stage['bound_ms_per_launch']:.3f} ms a launch "
              f"({stage['bound_by']}), inner nodes {stage['inner_visits']}, "
              f"leaves {stage['leaf_visits']}", flush=True)

    # ---- 7. whole path: each BVH kernel vs its plain version ----------------
    small_forest = load_dict(forest_scene(64, 64, 4, 6))
    films = {}
    for name, wide in (("tile_bvh", "0"), ("tile_bvh8", "1")):
        with env(ERT_BVH_WIDE=wide):
            films[name] = integrators.render(small_forest, seed=3,
                                             develop_film=False)
            with intersect.use_plain():
                plain = integrators.render(small_forest, seed=3,
                                           develop_film=False)
        flips = films_equivalent(plain.cpu().numpy(),
                                 films[name].cpu().numpy(), max_flips=2)
        print(f"# whole path forest 64x64 spp4: {name} kernel vs plain films "
              f"agree ({flips} pixels over tolerance, budget 2)", flush=True)
    flips = films_equivalent(films["tile_bvh"].cpu().numpy(),
                             films["tile_bvh8"].cpu().numpy(), max_flips=2)
    print(f"# whole path forest 64x64 spp4: tile_bvh vs tile_bvh8 films "
          f"agree ({flips} pixels over tolerance, budget 2)", flush=True)

    # ---- 8. grid gather vs plain: the probe's shape and the 64^3 table -------
    gen = torch.Generator().manual_seed(0)
    probe_tab = torch.rand(4096, 1, generator=gen).to(dev)
    probe_idx = torch.randint(0, 4096, (1024,), generator=gen,
                              dtype=torch.int32).to(dev)
    grid64 = torch.rand(1, 64, 64, 64, 1, generator=gen).to(dev)
    packed = volumes.packed_corners(grid64)
    pl = torch.rand(1 << 15, 3, generator=gen).to(dev)
    slot0 = torch.zeros(1 << 15, dtype=torch.int32, device=dev)
    corner_idx = volumes._corner0((1, 64, 64, 64), slot0, pl)[0]
    gather_loads = {"probe": (probe_tab, probe_idx),
                    "packed 64^3": (packed, corner_idx)}
    for load, (table, idx) in gather_loads.items():
        rec = gather_loads[load] = gather_load(table, idx)
        rec["host_us"] = gather_host_us(table, idx)
        print(f"# grid_gather {load} ({rec['rows']} rows of "
              f"{rec['row_floats']} f32, {rec['lanes']} lanes): kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms "
              f"(bit-equal), index_select {rec['library_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}); device us a "
              f"call {rec['device_us']}; host us a call (median of 5 rounds "
              f"of 2,000 calls): " + ", ".join(
                  f"{k} {v:.2f}" for k, v in rec["host_us"].items()),
              flush=True)
    trilinear = trilinear_load(grid64, packed, slot0, pl)
    print(f"# grid_trilinear packed 64^3 ({trilinear['lanes']} lanes): fused "
          f"lookup {trilinear['ms']:.4f} ms, plain chain "
          f"{trilinear['plain_ms']:.4f} ms (bit-equal), grid_sample "
          f"{trilinear['library_ms']:.4f} ms (max abs err "
          f"{trilinear['library_max_abs_err']:.2e}), bound "
          f"{trilinear['bound_ms']:.5f} ms ({trilinear['bound_by']}); device "
          f"us a call {trilinear['device_us']}",
          flush=True)

    # ---- 9-10. atmosphere renders on the regenerating lane pool --------------
    lanes = 1 << 15

    def bench_atmosphere(*args, **kw):
        """bench.py's load: the atmosphere with residual NEE, set as the
        bench sets it."""
        d = atmosphere(*args, **kw)
        d["integrator"]["nee_transmittance"] = "residual"
        return load_dict(d)

    flagship = bench_atmosphere(256, 256, 64, 12, grid_res=64)
    integrators.render_wavefront_regen(flagship, lanes, 0, 1)  # warm-up
    film, atmo_s, launches, counts = counted_regen(flagship, lanes)
    atmo = {"flagship": check_atmosphere(
        "atmosphere 256x256 spp64 max_depth 12 grid 64", flagship, film,
        atmo_s, launches, counts)}
    assert launches["grid_gather"] == 0  # the einsum path: 1,024 voxels
    large = bench_atmosphere(256, 256, 16, 12, grid_res=(64, 64, 64))
    assert large.vol_packed is not None
    film, secs_l, launches, counts = counted_regen(large, lanes)
    atmo["large3d"] = check_atmosphere(
        "atmosphere 256x256 spp16 max_depth 12 grid 64^3", large, film,
        secs_l, launches, counts)
    assert launches["grid_gather"] > 0

    # the fused query at the atmosphere's shape: the one-tile cube, a pool
    # of 32,768 rays from inside the slab in random directions; then an
    # 8-tile terrain(23) (968 triangles) under the bench camera's primary
    # rays and incoherent rays, 32,768 each
    o = torch.rand(lanes, 3, generator=gen) * torch.tensor([30.0, 30.0, 1.0])
    o = (o - torch.tensor([15.0, 15.0, 0.0])).to(dev)
    d = torch.nn.functional.normalize(torch.randn(lanes, 3, generator=gen),
                                      dim=-1).to(dev)
    small_loads = {"atmosphere cube": (flagship.geo.tiles(), Ray.make(o, d))}
    V8, F8 = terrain(23)
    tiles8 = {k: torch.as_tensor(v, device=dev) for k, v in
              pack_tiles(V8, F8, np.zeros(len(F8), np.int32)).items()}
    assert tiles8["lo"].shape[0] == 8
    tiles8["root"], tiles8["rows"] = intersect.sweep_tables(tiles8)
    for kind in ("primary", "incoherent"):
        o8, d8 = make_rays(lanes, kind, seed=5)
        small_loads[f"terrain(23) {kind}"] = (tiles8, Ray.make(
            torch.as_tensor(o8, device=dev), torch.as_tensor(d8, device=dev)))
    for load, (tl, ray) in small_loads.items():
        rec = small_loads[load] = small_query_load(tl, ray)
        print(f"# fused sweep {load} ({rec['tiles']} tiles, {rec['rays']} "
              f"rays): intersect_tiles (one launch) {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.3f} ms (bit-equal, visits {rec['visits']}),"
              f" bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}); eager "
              f"sorted pipeline {rec['eager_pipeline_ms']:.3f} ms, its kernel "
              f"{rec['eager_kernel_ms']:.4f} ms (visits "
              f"{rec['eager_visits']}); hits {rec['hit_frac']:.3f}; device "
              f"us a call {rec['device_us']}",
              flush=True)
    # where the sort starts to pay (intersect.SWEEP_FUSED_MAX_RAY_TILES):
    # terrain(23), (33), (46) (8, 16 and 32 tiles) under primary rays (the
    # path tracer's first bounce) and incoherent ones, 2^15 (the lane
    # pool's size) and 2^20 (a 256x256 spp16 pass) of each, the fused query
    # beside the sorted pipeline
    crossover = {}
    for n_grid in (23, 33, 46):
        Vc, Fc = terrain(n_grid)
        tc = {k: torch.as_tensor(v, device=dev) for k, v in
              pack_tiles(Vc, Fc, np.zeros(len(Fc), np.int32)).items()}
        tc["root"], tc["rows"] = intersect.sweep_tables(tc)
        for kind in ("primary", "incoherent"):
            for log_n in (15, 20):
                oc, dc = make_rays(1 << log_n, kind, seed=6)
                rec = crossover_load(tc, Ray.make(
                    torch.as_tensor(oc, device=dev),
                    torch.as_tensor(dc, device=dev)))
                crossover[f"{rec['tiles']} tiles {kind} 2^{log_n}"] = rec
                print(f"# fused vs sorted, terrain({n_grid}) {rec['tiles']} "
                      f"tiles, 2^{log_n} {kind} rays: fused "
                      f"{rec['fused_ms']:.3f} ms (visits "
                      f"{rec['fused_visits']}), sorted {rec['sorted_ms']:.3f}"
                      f" ms (visits {rec['sorted_visits']}), ratio "
                      f"{rec['fused_over_sorted']:.3f}", flush=True)

    # ---- 11. whole path on the 64^3 atmosphere: kernels vs plain -------------
    small_atmo = bench_atmosphere(64, 64, 4, 12, grid_res=(64, 64, 64))
    film_k, _ = integrators.render_wavefront_regen(small_atmo, lanes, 3, 4)
    for name, plain in (("grid_gather", gather.use_plain),
                        ("tile_sweep", intersect.use_plain)):
        with plain():
            film_p, _ = integrators.render_wavefront_regen(small_atmo, lanes,
                                                           3, 4)
        flips = films_equivalent(film_p.cpu().numpy(), film_k.cpu().numpy(),
                                 max_flips=2)
        print(f"# whole path 64^3 atmosphere 64x64 spp4: {name} kernel vs "
              f"plain films agree ({flips} pixels over tolerance, budget 2)",
              flush=True)

    # ---- 13. the trilinear lookup's backward vs plain on the 64^3 load -------
    gen13 = torch.Generator().manual_seed(13)
    grid64_c3 = torch.rand(1, 64, 64, 64, 3, generator=gen13).to(dev)
    bwd_loads = {}
    for g64 in (grid64, grid64_c3):
        C = g64.shape[-1]
        ct = torch.randn(pl.shape[0], C, generator=gen13).to(dev)
        rec = bwd_loads[f"C={C}"] = trilinear_bwd_load(g64, slot0, pl, ct)
        # exact where no two lanes share a corner (32^3 lanes)
        pl_d = distinct_corner_lanes(64, dev, gen13)
        ct_d = torch.randn(pl_d.shape[0], C, generator=gen13).to(dev)
        slot_d = torch.zeros(pl_d.shape[0], dtype=torch.int32, device=dev)
        assert torch.equal(
            gather.grid_trilinear_bwd(ct_d, g64.shape, slot_d, pl_d),
            volumes.trilinear_backward_plain(ct_d, g64.shape, slot_d, pl_d))
        print(f"# grid_trilinear_bwd 64^3 C={C} ({rec['lanes']} lanes): "
              f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms "
              f"(max abs err {rec['max_abs_err']:.2e}; bit-equal on "
              f"{pl_d.shape[0]} lanes with distinct corners), grid_sample "
              f"backward {rec['library_ms']:.4f} ms (max abs err "
              f"{rec['library_max_abs_err']:.2e}), bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}); device us a "
              f"call {rec['device_us']}", flush=True)

    # ---- 14. value+grad of the flagship and the 64^3 atmosphere ----------------
    # spp 4 (the primal phases take 64 and 16): the time limit
    grads = {}
    keys = ["volumes.gridvolume.grid", "volumes.constvolume.value",
            "spectra.baked.value"]
    flagship4 = bench_atmosphere(256, 256, 4, 12, grid_res=64)
    rec, params = value_grad(flagship4, lanes, keys, threefry=True)
    grads["flagship"] = check_value_grad(
        "atmosphere 256x256 spp4 max_depth 12 grid 64", flagship4, rec,
        params)
    assert rec["backward"]["launches"]["grid_trilinear_bwd"] == 0  # einsum
    large4 = bench_atmosphere(256, 256, 4, 12, grid_res=(64, 64, 64))
    rec, params = value_grad(large4, lanes, keys)
    grads["large3d"] = check_value_grad(
        "atmosphere 256x256 spp4 max_depth 12 grid 64^3", large4, rec, params)
    assert rec["backward"]["launches"]["grid_trilinear_bwd"] > 0
    # the same value+grad at 64x64 through the kernels and through the
    # plain gather (lookup and backward) and the plain sweep
    small_vg = {}
    for name, plain in (("kernels", contextlib.nullcontext),
                        ("grid_gather plain", gather.use_plain),
                        ("tile_sweep plain", intersect.use_plain)):
        with plain():
            _rec, params = value_grad(small_atmo, lanes, keys)
        small_vg[name] = {k: p.grad for k, p in params.items()}
    for name in ("grid_gather plain", "tile_sweep plain"):
        worst = 0.0
        for k, g in small_vg["kernels"].items():
            ref = small_vg[name][k]
            ok = torch.isfinite(ref)
            torch.testing.assert_close(g[ok], ref[ok], rtol=1e-5, atol=1e-7)
            assert torch.equal(ok, torch.isfinite(g)), k
            worst = max(worst, float((g[ok] - ref[ok]).abs().max()))
        print(f"# whole path 64^3 atmosphere 64x64 spp4 value+grad: kernels "
              f"vs {name} gradients agree (rtol 1e-5, atol 1e-7; max abs "
              f"err {worst:.2e})", flush=True)

    if "--profile" in sys.argv[1:]:
        profile_render(lambda: integrators.render(scene, seed=0), render_s,
                       "terrain")
        profile_render(lambda: integrators.render(forest, seed=0),
                       forest_runs["tile_bvh"]["render_ms"] / 1e3, "forest")
        # the profiler traces a 4-spp window of the same lane pool (262,144
        # samples, 8 refills of the pool)
        profile_render(
            lambda: integrators.render_wavefront_regen(flagship, lanes, 0,
                                                       64),
            atmo_s, "atmosphere",
            window=lambda: integrators.render_wavefront_regen(
                flagship, lanes, 0, 4))
        profile_render(
            lambda: integrators.render_wavefront_regen(large, lanes, 0, 16),
            secs_l, "large3d",
            window=lambda: integrators.render_wavefront_regen(
                large, lanes, 0, 2))

    # ---- 12. report -----------------------------------------------------------
    p = loads["primary"]
    kernels = [{
        "name": "tile_sweep", "route": "cuda",
        "source": "eradiate_kernel_tpu_torch/csrc/tile_sweep.cu",
        "replaces": "eradiate_kernel_tpu/ops/pallas_intersect.py:94",
        "launches": sweep_launches, "max_abs_err": max_err,
        "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
        "bound_by": p["bound_by"], "library_ms": None,
        "load": "2^20 primary rays on terrain(256)",
        "incoherent": loads["incoherent"],
        "atmosphere_cube": dict(small_loads["atmosphere cube"], launches={
            k: v["launches"]["tile_sweep"] for k, v in atmo.items()},
            load="fused query, 32,768 rays, 1 tile"),
        "tiles8_primary": small_loads["terrain(23) primary"],
        "tiles8_incoherent": small_loads["terrain(23) incoherent"],
        "fused_vs_sorted": crossover,
    }]
    for name, src, line in (("tile_bvh", "tile_bvh.cu", 206),
                            ("tile_bvh8", "tile_bvh8.cu", 718)):
        f = bvh_loads[(name, "forest")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"eradiate_kernel_tpu_torch/csrc/{src}",
            "replaces": f"eradiate_kernel_tpu/ops/pallas_intersect.py:{line}",
            "launches": forest_runs[name]["launches"],
            "max_abs_err": max(bvh_loads[(name, load)]["max_abs_err"]
                               for load in ("forest", "terrain primary",
                                            "terrain incoherent")),
            "ms": f["ms"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": None,
            "load": "2^19 primary rays on the instanced forest",
            "group": intersect.BVH_GROUP,
            "terrain_primary": bvh_loads[(name, "terrain primary")],
            "terrain_incoherent": bvh_loads[(name, "terrain incoherent")],
            "forest_render": forest_runs[name],
        })
    # the main path's lookups run the fused trilinear entry (its library
    # call: grid_sample); the gather entry's loads carry index_select
    kernels.append({
        "name": "grid_gather", "route": "cuda",
        "source": "eradiate_kernel_tpu_torch/csrc/grid_gather.cu",
        "replaces": "tools/probe_pallas_gather.py:54",
        "replaces_all": "tools/probe_pallas_gather.py:54,58,62,72 "
                        "(k_fancy, k_take, k_tala, k_onehot via call :87)",
        "launches": atmo["large3d"]["launches"]["grid_gather"],
        "max_abs_err": 0.0, "ms": trilinear["ms"],
        "plain_ms": trilinear["plain_ms"], "bound_ms": trilinear["bound_ms"],
        "bound_by": trilinear["bound_by"],
        "library_ms": trilinear["library_ms"],
        "library_call": "torch.nn.functional.grid_sample (5-D, bilinear, "
                        "border, align_corners=True)",
        "load": "fused trilinear lookup, 64^3 packed table, 32,768 lanes",
        "gather_packed_64^3": gather_loads["packed 64^3"],
        "gather_probe": gather_loads["probe"],
    })
    bwd1 = bwd_loads["C=1"]
    kernels.append({
        "name": "grid_trilinear_bwd", "route": "cuda",
        "source": "eradiate_kernel_tpu_torch/csrc/grid_gather.cu",
        "replaces": "tools/probe_pallas_gather.py:54",
        "replaces_all": "tools/probe_pallas_gather.py:54,58,62,72 (the "
                        "gather probe's kernels; this is the backward "
                        "entry of their port's trilinear lookup)",
        "launches": grads["large3d"]["backward"]["launches"][
            "grid_trilinear_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd_loads.values()),
        "ms": bwd1["ms"], "plain_ms": bwd1["plain_ms"],
        "bound_ms": bwd1["bound_ms"], "bound_by": bwd1["bound_by"],
        "library_ms": bwd1["library_ms"],
        "library_call": "torch.autograd.grad of "
                        "torch.nn.functional.grid_sample (5-D, bilinear, "
                        "border, align_corners=True) with respect to the "
                        "unpacked grid",
        "load": "64^3 grid, C = 1, 32,768 lanes of random points",
        "C=3": bwd_loads["C=3"],
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"value_grad": grads}))
    print(json.dumps({"atmosphere": {
        k: {kk: vv for kk, vv in v.items() if kk != "launches"}
        for k, v in atmo.items()}}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
