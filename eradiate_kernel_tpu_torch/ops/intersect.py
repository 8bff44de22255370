"""Closest-hit ray stream over triangle tiles: the flat tile sweep.

Counterpart of eradiate_kernel_tpu/ops/pallas_intersect.py
(``intersect_tiles`` with its pre-passes). The Pallas ``_kernel``
(pallas_intersect.py:94) becomes the hand-written CUDA kernel
``csrc/tile_sweep.cu``; ``_sweep_plain`` below is its plain PyTorch
version with the same contract, used for tensors on the CPU and to check
the kernel on the card.

Pipeline (all on the rays' device):
  1. cap each ray's maxt at its exit from the root AABB;
  2. for >= SORT_MIN_RAYS rays, sort by a coherence key (octant, origin
     cell, direction cell) and unsort the results afterwards;
  3. pad to whole blocks of RAY_BLOCK rays with dead filler rays;
  4. interval slab test of each block's ray bounds against every tile AABB;
     the admitted tiles of a block are ordered near to far by their entry
     lower bound ``tnear``;
  5. the sweep: each block visits its admitted tiles in order, stopping
     once the block's largest best t is <= the next tile's ``tnear``; each
     visit is a dense 256 x 128 Moller-Trumbore pass with a first-index
     tie-break.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from .accel import TILE_K

RAY_BLOCK = 256              # rays per sweep block (one CUDA thread block)
SORT_MIN_RAYS = 4 * RAY_BLOCK

# launches of the CUDA sweep kernel in this process (the wrapper adds one
# per launch); chip_smoke.py reads it to show the main path ran the kernel
launches = 0

# test hook: run the plain version on CUDA tensors too (phase 4 of
# chip_smoke.py renders the same scene through both); see use_plain_sweep
_FORCE_PLAIN = False

# Moller-Trumbore float ops per (ray, triangle) test: 6 mul + 3 sub (pvec),
# 3 mul + 2 add (det), 1 div, 3 sub (tvec), 3 mul + 2 add + 1 mul (u),
# 6 mul + 3 sub (qvec), 3 mul + 2 add + 1 mul (v), 3 mul + 2 add + 1 mul (t),
# 1 add (u + v)
FLOPS_PER_TEST = 46


@contextlib.contextmanager
def use_plain_sweep():
    """Route CUDA tensors through the plain version for the duration (for
    the whole-path kernel-vs-plain check only)."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


# =============================================================================
# Pre-passes (bit-equal to the reference's XLA code)
# =============================================================================

def _part1by2(x):
    """Spread the low 10 bits of x across every third bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _coherence_keys(rays, lo, hi):
    """Per-ray sort key (int64 holding uint32): direction octant above a
    coarse origin Morton cell (5 bits/axis) above a direction Morton cell
    (4 bits/axis on |d|). Dead rays (maxt <= mint) key to 0xFFFFFFFF."""
    o = rays[:, 0:3]
    d = rays[:, 3:6]
    i64 = torch.int64
    octant = (((d[:, 0] < 0).to(i64) << 2) | ((d[:, 1] < 0).to(i64) << 1)
              | (d[:, 2] < 0).to(i64))
    ext = torch.clamp(hi - lo, min=1e-30)
    q = torch.clamp((o - lo) / ext * 32.0, 0.0, 31.0).to(i64)
    omorton = ((_part1by2(q[:, 0]) << 2) | (_part1by2(q[:, 1]) << 1)
               | _part1by2(q[:, 2]))
    qd = torch.clamp(torch.abs(d) * 16.0, 0.0, 15.0).to(i64)
    dmorton = ((_part1by2(qd[:, 0]) << 2) | (_part1by2(qd[:, 1]) << 1)
               | _part1by2(qd[:, 2]))
    key = (octant << 27) | (omorton << 12) | dmorton
    dead = rays[:, 7] <= rays[:, 6]
    return torch.where(dead, 0xFFFFFFFF, key)


def _maybe_sorted(rays, lo, hi):
    """Coherence sort for loads of >= SORT_MIN_RAYS rays. Returns (sorted
    rays, unsort index or None)."""
    n = rays.shape[0]
    if n < SORT_MIN_RAYS:
        return rays, None
    # stable: keeps the existing (camera) order inside equal keys
    order = torch.argsort(_coherence_keys(rays, lo, hi), stable=True)
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(n, device=rays.device)
    return rays[order], unsort


def _cap_maxt_to_root(rays, lo, hi):
    """Clamp maxt to the exit distance from the root AABB (x1.0001 + 1e-4);
    rays that miss the root get maxt = mint. Conservative: every triangle
    lies inside the root box. It lets the sweep's early exit fire for
    blocks holding sky rays."""
    o = rays[:, 0:3]
    d = rays[:, 3:6]
    mint = rays[:, 6]
    maxt = rays[:, 7]
    sgn = torch.where(d < 0, -1.0, 1.0)
    inv = sgn / torch.clamp(torch.abs(d), min=1e-30)
    t0 = (lo[None, :] - o) * inv
    t1 = (hi[None, :] - o) * inv
    near = torch.amax(torch.minimum(t0, t1), dim=1)
    far = torch.amin(torch.maximum(t0, t1), dim=1)
    hit = (near <= far) & (far >= mint)
    cap = torch.where(hit, far * 1.0001 + 1e-4, mint)
    out = rays.clone()
    out[:, 7] = torch.minimum(maxt, torch.maximum(cap, mint))
    return out


def _block_tile_mask(rays, lo, hi):
    """Conservative per-(ray block, tile) visibility: interval-arithmetic
    slab test of each block's ray bounds against every tile AABB, plus a
    reachability bound on sign-mixed direction axes. False positives only
    cost a visit. rays: (N, 8), N a multiple of RAY_BLOCK; lo/hi: (T, 3).
    Returns (mask (nb, T) bool, tnear lower bound (nb, T) f32)."""
    nb = rays.shape[0] // RAY_BLOCK
    r = rays.reshape(nb, RAY_BLOCK, 8)
    o_lo = torch.amin(r[..., 0:3], dim=1)       # (nb, 3)
    o_hi = torch.amax(r[..., 0:3], dim=1)
    d_lo = torch.amin(r[..., 3:6], dim=1)
    d_hi = torch.amax(r[..., 3:6], dim=1)
    maxt_ub = torch.amax(r[..., 7], dim=1)      # (nb,)

    big = 3.4e38
    mixed = (d_lo <= 0) & (d_hi >= 0)
    i1 = 1.0 / torch.where(mixed, 1.0, d_lo)
    i2 = 1.0 / torch.where(mixed, 1.0, d_hi)
    inv_lo = torch.where(mixed, -big, torch.minimum(i1, i2))   # (nb, 3)
    inv_hi = torch.where(mixed, big, torch.maximum(i1, i2))

    a_lo = lo[None, :, :] - o_hi[:, None, :]               # (nb, T, 3)
    a_hi = lo[None, :, :] - o_lo[:, None, :]
    b_lo = hi[None, :, :] - o_hi[:, None, :]
    b_hi = hi[None, :, :] - o_lo[:, None, :]

    def iprod(x_lo, x_hi, y_lo, y_hi):
        cands = torch.stack([x_lo * y_lo, x_lo * y_hi, x_hi * y_lo,
                             x_hi * y_hi])
        return torch.amin(cands, dim=0), torch.amax(cands, dim=0)

    il = inv_lo[:, None, :]
    ih = inv_hi[:, None, :]
    t0_lo, t0_hi = iprod(a_lo, a_hi, il, ih)
    t1_lo, t1_hi = iprod(b_lo, b_hi, il, ih)
    tnear_lb = torch.minimum(t0_lo, t1_lo)                 # (nb, T, 3)
    tfar_ub = torch.maximum(t0_hi, t1_hi)
    tnear_lb = torch.clamp(torch.amax(tnear_lb, dim=-1), min=0.0)  # (nb, T)
    tfar_ub = torch.minimum(torch.amin(tfar_ub, dim=-1), maxt_ub[:, None])
    ok = tnear_lb <= tfar_ub

    # sign-mixed axes threw their slab constraint away above (fatal for
    # axis-aligned camera rays); recover it with a reachability bound
    dist_lb = torch.clamp(torch.maximum(lo[None, :, :] - o_hi[:, None, :],
                                        o_lo[:, None, :] - hi[None, :, :]),
                          min=0.0)                         # (nb, T, 3)
    speed_ub = torch.maximum(torch.abs(d_lo), torch.abs(d_hi))[:, None, :]
    # clamp inf maxt: inf * speed(=0) would be NaN and reject everything
    maxt_c = torch.clamp(maxt_ub, max=1e30)[:, None, None]
    reach = dist_lb <= maxt_c * speed_ub + 1e-6
    ok = ok & torch.all(torch.where(mixed[:, None, :], reach, True), dim=-1)
    return ok, tnear_lb


def _admitted_tiles(rays, lo, hi):
    """Each block's admitted tiles, near to far: (ids (nb, T) i32, tnear
    (nb, T) f32, count (nb,) i32). Entries past count are not admitted."""
    mask, tnear_lb = _block_tile_mask(rays, lo, hi)
    key = torch.where(mask, tnear_lb, float("inf"))
    ids = torch.argsort(key, dim=1, stable=True)
    tnear = torch.gather(key, 1, ids)
    count = mask.sum(dim=1, dtype=torch.int32)
    return ids.to(torch.int32).contiguous(), tnear.contiguous(), count


# =============================================================================
# The sweep: plain version and CUDA kernel, one contract
# =============================================================================
#
# In:  rays (nb*RAY_BLOCK, 8) f32 [o, d, mint, maxt]; ids/tnear (nb, T);
#      count (nb,) i32; v0/e1/e2 (T, K, 3) f32; prim/shape (T, K) i32.
# Out: t (n,) f32 (inf on a miss), uv (n, 2) f32, prim (n,) i32,
#      shape (n,) i32 (-1 on a miss), visited (nb,) i32 tiles swept per block.

# cap on the (blocks, RAY_BLOCK, TILE_K) temporaries of the plain version
_PLAIN_MAX_ELEMS = 1 << 25


def _sweep_plain(rays, ids, count, tnear, v0, e1, e2, prim, shape):
    n = rays.shape[0]
    nb = count.shape[0]
    r = rays.reshape(nb, RAY_BLOCK, 8)
    best_t = r[..., 7].clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_prim = torch.zeros(nb, RAY_BLOCK, dtype=torch.int32,
                            device=rays.device)
    best_shape = torch.full_like(best_prim, -1)
    visited = torch.zeros(nb, dtype=torch.int32, device=rays.device)
    chunk = max(1, _PLAIN_MAX_ELEMS // (RAY_BLOCK * TILE_K))
    for c0 in range(0, nb, chunk):
        blk = torch.arange(c0, min(c0 + chunk, nb), device=rays.device)
        bt_ub = torch.amax(best_t[blk], dim=1)
        running = torch.ones_like(blk, dtype=torch.bool)
        k = 0
        while True:
            kc = min(k, ids.shape[1] - 1)
            running &= (k < count[blk]) & (bt_ub > tnear[blk, kc])
            if not bool(running.any()):
                break
            b = blk[running]
            j = ids[b, k].long()
            rb = r[b]
            ox, oy, oz = rb[..., 0:1], rb[..., 1:2], rb[..., 2:3]
            dx, dy, dz = rb[..., 3:4], rb[..., 4:5], rb[..., 5:6]
            mint = rb[..., 6:7]
            tv0, te1, te2 = v0[j][:, None], e1[j][:, None], e2[j][:, None]
            v0x, v0y, v0z = tv0[..., 0], tv0[..., 1], tv0[..., 2]
            e1x, e1y, e1z = te1[..., 0], te1[..., 1], te1[..., 2]
            e2x, e2y, e2z = te2[..., 0], te2[..., 1], te2[..., 2]
            # pvec = d x e2 -> (A, B, K)
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
            tx = ox - v0x
            ty = oy - v0y
            tz = oz - v0z
            u = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            bt = best_t[b]
            ok = ((torch.abs(det) >= 1e-12) & (u >= 0) & (v >= 0)
                  & (u + v <= 1.0) & (prim[j][:, None, :] >= 0)
                  & (t >= mint) & (t < bt[..., None]))
            t = torch.where(ok, t, float("inf"))
            t_min, k_best = torch.min(t, dim=2)        # first index on ties
            hit = t_min < bt
            pick = lambda a: torch.gather(a, 2, k_best[..., None])[..., 0]
            kb = k_best
            best_t[b] = torch.where(hit, t_min, bt)
            best_u[b] = torch.where(hit, pick(u), best_u[b])
            best_v[b] = torch.where(hit, pick(v), best_v[b])
            best_prim[b] = torch.where(hit, torch.gather(prim[j], 1, kb),
                                       best_prim[b])
            best_shape[b] = torch.where(hit, torch.gather(shape[j], 1, kb),
                                        best_shape[b])
            visited[b] += 1
            bt_ub[running] = torch.amax(best_t[b], dim=1)
            k += 1
    maxt = r[..., 7]
    no_hit = best_t >= maxt
    t_out = torch.where(no_hit, float("inf"), best_t).reshape(n)
    uv = torch.stack([best_u, best_v], dim=-1).reshape(n, 2)
    shape_out = torch.where(no_hit, -1, best_shape).reshape(n)
    return t_out, uv, best_prim.reshape(n), shape_out, visited


_lib = None


def _source_path():
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc", "tile_sweep.cu")


def build_kernel(verbose=False):
    """Compile csrc/tile_sweep.cu for sm_90a (once per process and source
    version) into the package's build/ directory and load it. Returns the
    ctypes library. Raises if nvcc fails."""
    global _lib
    if _lib is not None:
        return _lib
    src = _source_path()
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    build_dir = os.path.join(os.path.dirname(os.path.dirname(src)), "build")
    os.makedirs(build_dir, exist_ok=True)
    so_path = os.path.join(build_dir, f"tile_sweep_{tag}.so")
    if not os.path.exists(so_path):
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = f"{so_path}.{os.getpid()}.tmp"
        # -fmad=false: no a*b+c contraction, so the kernel rounds every
        # product and sum like the plain version's eager torch ops do
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-fmad=false", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp, src]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.tile_sweep_launch.restype = ctypes.c_int
    lib.tile_sweep_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 6)
    _lib = lib
    return lib


def _sweep_cuda(rays, ids, count, tnear, v0, e1, e2, prim, shape):
    """Launch csrc/tile_sweep.cu on the current stream (no sync)."""
    global launches
    lib = build_kernel()
    nb, T = ids.shape
    dev = rays.device
    expect = {
        "rays": (rays, torch.float32, (nb * RAY_BLOCK, 8)),
        "ids": (ids, torch.int32, (nb, T)),
        "count": (count, torch.int32, (nb,)),
        "tnear": (tnear, torch.float32, (nb, T)),
        "v0": (v0, torch.float32, (T, TILE_K, 3)),
        "e1": (e1, torch.float32, (T, TILE_K, 3)),
        "e2": (e2, torch.float32, (T, TILE_K, 3)),
        "prim": (prim, torch.int32, (T, TILE_K)),
        "shape": (shape, torch.int32, (T, TILE_K)),
    }
    for name, (a, dtype, shp) in expect.items():
        if (a.device != dev or a.dtype != dtype or tuple(a.shape) != shp
                or not a.is_contiguous()):
            raise ValueError(
                f"tile_sweep: {name} must be a contiguous {dtype} tensor of "
                f"shape {shp} on {dev}, got {a.dtype} {tuple(a.shape)} on "
                f"{a.device}")
    n = nb * RAY_BLOCK
    t = torch.empty(n, dtype=torch.float32, device=dev)
    uv = torch.empty(n, 2, dtype=torch.float32, device=dev)
    prim_o = torch.empty(n, dtype=torch.int32, device=dev)
    shape_o = torch.empty(n, dtype=torch.int32, device=dev)
    visited = torch.empty(nb, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tile_sweep_launch(
        rays.data_ptr(), ids.data_ptr(), count.data_ptr(), tnear.data_ptr(),
        v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), prim.data_ptr(),
        shape.data_ptr(), nb, T, t.data_ptr(), uv.data_ptr(),
        prim_o.data_ptr(), shape_o.data_ptr(), visited.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tile_sweep launch failed: cudaError {err}")
    launches += 1
    return t, uv, prim_o, shape_o, visited


def sweep(rays, ids, count, tnear, v0, e1, e2, prim, shape):
    """The sweep on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors (or under use_plain_sweep)."""
    if rays.device.type == "cpu" or _FORCE_PLAIN:
        return _sweep_plain(rays, ids, count, tnear, v0, e1, e2, prim, shape)
    if rays.device.type != "cuda":
        raise ValueError(f"tile_sweep: unsupported device {rays.device}")
    return _sweep_cuda(rays, ids, count, tnear, v0, e1, e2, prim, shape)


def prepare_sweep(tiles, ray):
    """The pre-passes of intersect_tiles: -> (sweep arguments, unsort index
    or None, number of real rays)."""
    n = ray.o.shape[0]
    rays = torch.cat([ray.o, ray.d, ray.mint[:, None], ray.maxt[:, None]],
                     dim=-1).to(torch.float32)
    root_lo = torch.amin(tiles["lo"], dim=0)
    root_hi = torch.amax(tiles["hi"], dim=0)
    rays = _cap_maxt_to_root(rays, root_lo, root_hi)
    rays, unsort = _maybe_sorted(rays, root_lo, root_hi)
    pad = -n % RAY_BLOCK
    if pad:
        filler = torch.zeros(pad, 8, dtype=rays.dtype, device=rays.device)
        filler[:, 5] = 1.0
        rays = torch.cat([rays, filler], dim=0)
    rays = rays.contiguous()
    ids, tnear, count = _admitted_tiles(rays, tiles["lo"], tiles["hi"])
    args = (rays, ids, count, tnear, tiles["v0"], tiles["e1"], tiles["e2"],
            tiles["prim"], tiles["shape"])
    return args, unsort, n


def intersect_tiles(tiles, ray, return_visited=False):
    """Closest-hit query over the tile set.

    tiles: dict of tensors in the ops.accel.pack_tiles layout; ray: core.ray
    Ray with (N,)-shaped fields. Returns (t, uv, prim, shape) with t = inf
    and shape = -1 on a miss; with ``return_visited`` also the (nb,) count
    of tiles each ray block swept.
    """
    args, unsort, n = prepare_sweep(tiles, ray)
    t, uv, prim, shape, visited = sweep(*args)
    if unsort is not None:
        out = (t[unsort], uv[unsort], prim[unsort], shape[unsort])
    else:
        out = (t[:n], uv[:n], prim[:n], shape[:n])
    return out + (visited,) if return_visited else out
