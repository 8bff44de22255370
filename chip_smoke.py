"""On-card smoke test of the PyTorch/CUDA port (eradiate_kernel_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. build every CUDA kernel of the path from the repository's sources;
  2. hold the tile-sweep kernel against its plain PyTorch version on the
     bench terrain (terrain(256): 130,050 triangles, 1,017 tiles) with
     2^20 coherent primary rays and 2^20 incoherent rays;
  3. render the terrain scene at full width (256x256 film, 16 spp, path
     tracer with max_depth 6, RPV surface, directional sun) through the
     port's ``load_dict`` and ``integrators.render``, counting kernel
     launches;
  4. render a 64x64, 4 spp version twice, through the kernel and through
     the plain sweep, and compare the films;
  5. print the kernels line, the card's name and power limit, and the
     final ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --profile`` adds, before the report, a breakdown of
the full-width render: host time per stage (each stage synchronised before
and after) and a torch.profiler pass whose kernel table goes to
chiprun_out/profile_render.txt.
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


def sweep_bound(args, visited):
    """Least time (ms) the card could take for one sweep: the larger of
    bytes moved / HBM rate and FP32 operations / FP32 peak. Bytes: rays in,
    each visit's (id, tnear) pair, counts, the tile arrays once, outputs.
    Operations: tiles visited x 256 x 128 tests x FLOPS_PER_TEST."""
    from eradiate_kernel_tpu_torch.ops import intersect

    rays, ids, count = args[0], args[1], args[2]
    n_pad, nb, T = rays.shape[0], count.shape[0], args[4].shape[0]
    visits = int(visited.sum())
    tile_bytes = T * intersect.TILE_K * (9 * 4 + 2 * 4)
    nbytes = (n_pad * 32 + visits * 8 + nb * 4 + tile_bytes
              + n_pad * (4 + 8 + 4 + 4) + nb * 4)
    ops = visits * intersect.RAY_BLOCK * intersect.TILE_K \
        * intersect.FLOPS_PER_TEST
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations"), visits


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


def profile_render(scene, render_s):
    """Where the full-width render's time goes; prints '#' lines and writes
    the profiler's kernel table to chiprun_out/profile_render.txt."""
    from eradiate_kernel_tpu_torch import bsdfs, integrators
    from eradiate_kernel_tpu_torch.core import rng
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.render import geometry

    stages = {
        "sweep pre-passes": (intersect, "prepare_sweep"),
        "sweep kernel": (intersect, "sweep"),
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
    parts = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in spent.items())
    print(f"# render stages (synchronised, ms): total {total * 1e3:.1f}: "
          f"{parts}, other {rest * 1e3:.1f}", flush=True)

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
    sweep_us = sum(e.self_device_time_total for e in kernels
                   if "tile_sweep" in e.key)
    launches = sum(e.count for e in avgs if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    syncs = sum(e.count for e in avgs if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize"))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_render.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=50))
    if device_us == 0:
        print("# render profile: the profiler saw no device time "
              "(busy share not measured)", flush=True)
        return
    print(f"# render profile: device kernel time {device_us / 1e3:.1f} ms "
          f"(tile_sweep {sweep_us / 1e3:.1f} ms), busy share "
          f"{device_us / 1e6 / render_s:.3f} of the unprofiled render "
          f"({render_s * 1e3:.1f} ms), {device_us / 1e6 / prof_s:.3f} of "
          f"the profiled one ({prof_s * 1e3:.1f} ms); kernel launches "
          f"{launches}, host syncs {syncs}", flush=True)
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)[:8]
    print("# render profile, aten ops by device time (ms, calls): "
          + ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.1f} "
                      f"({e.count})" for e in ops), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core.ray import Ray
    from eradiate_kernel_tpu_torch.integrators import path
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.ops.accel import pack_tiles
    from eradiate_kernel_tpu_torch.scene import load_dict

    dev = torch.device("cuda")
    print(f"# device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    intersect.build_kernel(verbose=True)
    print(f"# build: tile_sweep {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 2. kernel vs plain on the bench terrain -----------------------------
    V, F = terrain(256)
    tiles_np = pack_tiles(V, F, np.zeros(len(F), np.int32))
    tiles = {k: torch.as_tensor(v, device=dev) for k, v in tiles_np.items()}
    print(f"# terrain: {len(F)} triangles, {len(tiles_np['lo'])} tiles",
          flush=True)
    n_rays = 1 << 20
    loads = {}
    max_err = 0.0
    for kind in ("primary", "incoherent"):
        o, d = make_rays(n_rays, kind)
        ray = Ray.make(torch.as_tensor(o, device=dev),
                       torch.as_tensor(d, device=dev))
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

    # ---- 3. full-width render through the port's entry points ----------------
    scene = load_dict(terrain_scene(V, F, 256, 256, 16, 6))
    bounces = [0]
    queries = [0]
    traced = [0.0]
    bounce = path._bounce
    prepare = intersect.prepare_sweep

    def counted_bounce(*a, **kw):
        state = bounce(*a, **kw)
        bounces[0] += 1
        traced[0] = float(state.n_rays)
        return state

    def counted_prepare(*a, **kw):
        queries[0] += 1
        return prepare(*a, **kw)

    path._bounce = counted_bounce
    intersect.prepare_sweep = counted_prepare
    try:
        integrators.render(scene, seed=0, spp=1)  # warm-up (allocator)
        bounces[0] = queries[0] = 0
        torch.cuda.synchronize()
        intersect.launches = 0
        t0 = time.perf_counter()
        img = integrators.render(scene, seed=0)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        launches = intersect.launches
    finally:
        path._bounce = bounce
        intersect.prepare_sweep = prepare
    n_samples = 256 * 256 * 16
    mean = float(img.mean())
    print(f"# render 256x256 spp16 max_depth 6: {render_s * 1e3:.1f} ms, "
          f"{n_samples / render_s / 1e6:.3f} Msamples/s, rays traced "
          f"{traced[0]:.0f}, bounces {bounces[0]}, closest-hit queries "
          f"{queries[0]}, tile_sweep launches {launches}, image mean "
          f"{mean:.5f}", flush=True)
    assert img.shape == (256, 256, 3)
    assert bool(torch.isfinite(img).all()), "render: non-finite pixels"
    assert 0.005 < mean < 0.5, f"render: image mean {mean} out of range"
    # every mesh query of the render went through the kernel: one camera or
    # bounce query per bounce, and one shadow query per bounce but the last
    # (a path at max_depth ends before next-event estimation)
    assert launches == queries[0], f"{launches} launches, {queries[0]} queries"
    assert bounces[0] >= 1 and launches >= 2 * bounces[0] - 1, \
        f"{launches} launches for {bounces[0]} bounces"

    # ---- 4. whole path: kernel vs plain sweep --------------------------------
    small = load_dict(terrain_scene(V, F, 64, 64, 4, 6))
    film_k = integrators.render(small, seed=3, develop_film=False)
    with intersect.use_plain_sweep():
        film_p = integrators.render(small, seed=3, develop_film=False)
    flips = films_equivalent(film_p.cpu().numpy(), film_k.cpu().numpy(),
                             max_flips=2)
    print(f"# whole path 64x64 spp4: kernel vs plain films agree "
          f"({flips} pixels over tolerance, budget 2)", flush=True)

    if "--profile" in sys.argv[1:]:
        profile_render(scene, render_s)

    # ---- 5. report -------------------------------------------------------------
    p = loads["primary"]
    kernels = [{
        "name": "tile_sweep", "route": "cuda",
        "source": "eradiate_kernel_tpu_torch/csrc/tile_sweep.cu",
        "replaces": "eradiate_kernel_tpu/ops/pallas_intersect.py:94",
        "launches": launches, "max_abs_err": max_err,
        "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
        "bound_by": p["bound_by"], "library_ms": None,
        "load": "2^20 primary rays on terrain(256)",
        "incoherent": loads["incoherent"],
    }]
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
