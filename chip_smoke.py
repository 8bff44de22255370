"""On-card smoke test of the PyTorch/CUDA port (eradiate_kernel_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. build every CUDA kernel of the port (tile_sweep, tile_bvh, tile_bvh8)
     from the repository's sources, one nvcc per source, in parallel;
  2. hold the tile-sweep kernel against its plain PyTorch version on the
     bench terrain (terrain(256): 130,050 triangles, 1,017 tiles) with
     2^20 coherent primary rays and 2^20 incoherent rays;
  3. render the terrain scene at full width (256x256 film, 16 spp, path
     tracer with max_depth 6, RPV surface, directional sun) through the
     port's ``load_dict`` and ``integrators.render``, counting kernel
     launches;
  4. render a 64x64, 4 spp version twice, through the kernel and through
     the plain sweep, and compare the films;
  5. hold each tile-BVH kernel (binary and 8-wide) against its plain
     version: terrain(256) through the BVH with the loads of phase 2, and
     the instanced forest (bench_mesh.py's bench_forest: one 2,048-triangle
     crown instanced 256 times, 4,096 BVH leaves) with 2^19 primary rays;
  6. render the forest at full width (256x256, 16 spp, max_depth 6, RPV
     ground, directional sun) through the binary BVH (the default policy)
     and through the 8-wide BVH (ERT_BVH_WIDE=1), counting launches;
  7. render a 64x64, 4 spp forest through each BVH kernel and its plain
     version and compare the films;
  8. print the kernels line, the card's name and power limit, and the
     final ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --profile`` adds, before the report, a breakdown of
the full-width terrain and forest renders: host time per stage (each stage
synchronised before and after) and a torch.profiler pass whose kernel
tables go to smoke_out/profile_<scene>.txt.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


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
    rays in, the tree, instance rows and tiles once, outputs and stats.
    Operations: leaves visited x 256 x 128 tests x FLOPS_PER_TEST, plus
    inner nodes visited x 256 rays x (2 or 8) children x FLOPS_PER_SLAB."""
    from eradiate_kernel_tpu_torch.ops import intersect

    rays = args[0]
    tree = sum(a.numel() * 4 for a in args[1:5])
    inner, leaves = (int(x) for x in stats[:, :2].sum(0))
    nbytes = (rays.shape[0] * (32 + 20) + stats.numel() * 4 + tree
              + tile_bytes(args[5].shape[0]))
    ops = (leaves * intersect.RAY_BLOCK * intersect.TILE_K
           * intersect.FLOPS_PER_TEST
           + inner * intersect.RAY_BLOCK * (8 if wide else 2)
           * intersect.FLOPS_PER_SLAB)
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


def profile_render(scene, render_s, label):
    """Where a full-width render's time goes; prints '#' lines and writes
    the profiler's kernel table to smoke_out/profile_<label>.txt."""
    from eradiate_kernel_tpu_torch import bsdfs, integrators
    from eradiate_kernel_tpu_torch.core import rng
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.render import geometry

    stages = {
        "sweep pre-passes": (intersect, "prepare_sweep"),
        "sweep kernel": (intersect, "sweep"),
        "bvh pre-passes": (intersect, "prepare_bvh"),
        "tile_bvh/tile_bvh8 kernel": (intersect, "traverse"),
        "threefry": (rng, "threefry2x32"),
        "surface interaction": (geometry, "compute_surface_interaction"),
        "bsdf sample": (bsdfs, "bsdf_sample"),
        "bsdf eval": (bsdfs, "bsdf_eval_pdf"),
    }
    with stage_timers(stages) as spent:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integrators.render(scene, seed=0)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    rest = total - sum(spent.values())
    parts = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in spent.items() if v)
    print(f"# {label} render stages (synchronised, ms): total "
          f"{total * 1e3:.1f}: {parts}, other {rest * 1e3:.1f}", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        integrators.render(scene, seed=0)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    avgs = prof.key_averages()
    # device-side rows only: an aten op's row repeats its kernels' time
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    ours = {name: sum(e.self_device_time_total for e in kernels
                      if f"{name}_kernel" in e.key)
            for name in intersect.KERNELS}
    launches = sum(e.count for e in avgs if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    syncs = sum(e.count for e in avgs if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize"))
    os.makedirs("smoke_out", exist_ok=True)
    with open(os.path.join("smoke_out", f"profile_{label}.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=50))
    if device_us == 0:
        print(f"# {label} render profile: the profiler saw no device time "
              "(busy share not measured)", flush=True)
        return
    ours_txt = ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in ours.items())
    print(f"# {label} render profile: device kernel time "
          f"{device_us / 1e3:.1f} ms ({ours_txt}), busy share "
          f"{device_us / 1e6 / render_s:.3f} of the unprofiled render "
          f"({render_s * 1e3:.1f} ms), {device_us / 1e6 / prof_s:.3f} of "
          f"the profiled one ({prof_s * 1e3:.1f} ms); kernel launches "
          f"{launches}, host syncs {syncs}", flush=True)
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)[:8]
    print(f"# {label} render profile, aten ops by device time (ms, calls): "
          + ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.1f} "
                      f"({e.count})" for e in ops), flush=True)


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
        for k in intersect.launches:
            intersect.launches[k] = 0
        counts.update(bounces=0, queries=0)
        t0 = time.perf_counter()
        img = integrators.render(scene, seed=0, **render_kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(intersect.launches)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core.ray import Ray
    from eradiate_kernel_tpu_torch.ops import bvh, intersect
    from eradiate_kernel_tpu_torch.ops.accel import pack_tiles
    from eradiate_kernel_tpu_torch.scene import build, load_dict

    dev = torch.device("cuda")
    print(f"# device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    secs = intersect.build_kernels(verbose=True)
    print(f"# build: {', '.join(f'{k} {v:.2f} s' for k, v in secs.items())}"
          f" (in parallel, {time.perf_counter() - t0:.2f} s in all)",
          flush=True)

    # ---- 2. tile sweep vs plain on the bench terrain --------------------------
    V, F = terrain(256)
    tiles_np = pack_tiles(V, F, np.zeros(len(F), np.int32))
    tiles = {k: torch.as_tensor(v, device=dev) for k, v in tiles_np.items()}
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

    if "--profile" in sys.argv[1:]:
        profile_render(scene, render_s, "terrain")
        profile_render(forest, forest_runs["tile_bvh"]["render_ms"] / 1e3,
                       "forest")

    # ---- 8. report -------------------------------------------------------------
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
            "terrain_primary": bvh_loads[(name, "terrain primary")],
            "terrain_incoherent": bvh_loads[(name, "terrain incoherent")],
            "forest_render": forest_runs[name],
        })
    print(json.dumps({"kernels": kernels}))
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
