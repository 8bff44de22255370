"""Closest-hit ray streams over triangle tiles: the flat tile sweep and the
binary and 8-wide tile-BVH traversals.

Counterpart of eradiate_kernel_tpu/ops/pallas_intersect.py
(``intersect_tiles``, ``intersect_bvh`` and ``intersect_bvh8`` with their
pre-passes). Each Pallas kernel becomes a hand-written CUDA kernel under
``csrc/``; beside each is its plain PyTorch version with the same
contract, used for tensors on the CPU and to check the kernel on the card:

  Pallas kernel (pallas_intersect.py)   CUDA kernel      plain version
  ``_kernel`` :94                       tile_sweep.cu    ``_sweep_plain``,
                                                         ``_sweep_small_plain``
  ``_bvh_kernel`` :206                  tile_bvh.cu      ``_bvh_plain``
  ``_bvh8_kernel`` :718                 tile_bvh8.cu     ``_bvh8_plain``

Sweep pipeline (all on the rays' device), for tile sets of more than
SWEEP_FUSED_MAX_TILES tiles or loads of more than SWEEP_FUSED_MAX_RAY_TILES
rays x tiles:
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
Smaller loads (the atmosphere's one-tile cube under its 32,768-lane pool)
take steps 1 and 3-5 in one launch of the fused entry, without the
coherence sort: with one tile the ray order changes no result, and with a
few the closest t does not depend on it (a tie between triangles at the
same t may pick another one, Queue 2's contract). The root box and the
packed triangle rows the kernels stage are built once per scene
(render/geometry.py::Geometry: the box at load, the rows at the first
sweep query).

The BVH traversals share steps 1 (binary only), 2 and 3, then walk the
tree per group of BVH_GROUP rays (one warp): one stack per group, a
group-wide slab test of the children at each inner node, and at each leaf
the rays moved into the leaf's instance space and the dense tile pass of
step 5 on the packed rows.
"""

from __future__ import annotations

import contextlib

import torch

from . import _build
from .accel import TILE_K

RAY_BLOCK = 256              # rays per block (one CUDA thread block)
SORT_MIN_RAYS = 4 * RAY_BLOCK
# the fused one-launch query serves at most SWEEP_FUSED_MAX_TILES tiles (its
# capacity: one warp ranks a block's tiles, csrc/tile_sweep.cu, whose entry
# refuses more) and at most SWEEP_FUSED_MAX_RAY_TILES rays x tiles. Without
# the coherence sort its blocks of incoherent rays visit every tile, so its
# time grows with rays x tiles; the sorted pipeline pays ~3 ms of eager
# passes at any size, host time that varies with the host. On an H100 at
# 2^20 incoherent rays the fused query took 0.38-0.88x the sorted
# pipeline's time at 8 tiles and 0.96-1.49x at 16 (two runs); at 32,768
# rays, 0.02-0.11x up to 32 tiles (chip_smoke.py, PERF.md)
SWEEP_FUSED_MAX_TILES = 32
SWEEP_FUSED_MAX_RAY_TILES = 1 << 23
STACK_SIZE = 64              # traversal stack per group (both BVH kernels)
# rays a BVH group walks together (RAY_BLOCK's counterpart for the BVH
# kernels, kGroup of csrc/tile_walk.cuh): one warp. On an H100 the TPU's
# 256-ray group took 1.3-4x the warp's time on every load (forest render:
# 23.5 against 5.9 ms a launch; PERF.md), so it is not built
BVH_GROUP = 32
LEAF_INST_BITS = 12          # BVH8 leaf entries: -((tile << 12) | (inst+1)) - 1

# launches of each CUDA kernel in this process (its wrapper adds one per
# launch), the float64 entries of the double variants under "<name>_f64";
# chip_smoke.py reads them to show the main path ran the kernels
launches = {"tile_sweep": 0, "tile_bvh": 0, "tile_bvh8": 0,
            "tile_sweep_f64": 0, "tile_bvh_f64": 0, "tile_bvh8_f64": 0}

# test hook: run the plain versions on CUDA tensors too (chip_smoke.py
# renders the same scene through both); see use_plain
_FORCE_PLAIN = False

# Moller-Trumbore float ops per (ray, triangle) test: 6 mul + 3 sub (pvec),
# 3 mul + 2 add (det), 1 div, 3 sub (tvec), 3 mul + 2 add + 1 mul (u),
# 6 mul + 3 sub (qvec), 3 mul + 2 add + 1 mul (v), 3 mul + 2 add + 1 mul (t),
# 1 add (u + v)
FLOPS_PER_TEST = 46
# slab-test float ops per (ray, box): 6 sub + 6 mul, 3 min + 3 max (slab
# ends), 3 max (near, with mint), 4 min (far, with maxt and the block
# bound), 1 compare
FLOPS_PER_SLAB = 26


@contextlib.contextmanager
def use_plain():
    """Route CUDA tensors through the plain versions for the duration (for
    the whole-path kernel-vs-plain checks only)."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def _on_plain(t, name):
    """True if the plain version serves tensor t; raises for a device that
    is neither the CPU nor CUDA."""
    if t.device.type == "cpu" or _FORCE_PLAIN:
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


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


def root_box(lo, hi):
    """(2, 3) [lo; hi] box around tile boxes lo/hi (T, 3), T >= 1."""
    return torch.stack([torch.amin(lo, dim=0), torch.amax(hi, dim=0)])


def tile_rows(v0, e1, e2, prim, shape):
    """(T, K, 12) packed triangles of v0's dtype, the layout every tile
    kernel reads: [v0x v0y v0z e1x | e1y e1z e2x e2y | e2z prim shape 0].
    In float32 prim and shape are int32 bits (three 16-byte loads a
    triangle); in float64 they are exact doubles (six 16-byte loads), which
    the kernels and row_views read back as the same integers."""
    ids = torch.stack([prim, shape, torch.zeros_like(prim)], dim=-1)
    ids = (ids.view(torch.float32) if v0.dtype == torch.float32
           else ids.to(v0.dtype))
    return torch.cat([v0, e1, e2, ids], dim=-1).contiguous()


def row_views(rows):
    """(v0, e1, e2, prim, shape) of packed rows: the pack_tiles arrays that
    tile_rows packed, views (no copy) in float32; in float64 the ids are
    int32 copies."""
    if rows.dtype == torch.float32:
        prim, shape = rows[..., 9].view(torch.int32), rows[..., 10].view(
            torch.int32)
    else:
        prim, shape = (rows[..., 9].to(torch.int32),
                       rows[..., 10].to(torch.int32))
    return rows[..., 0:3], rows[..., 3:6], rows[..., 6:9], prim, shape


def packed_rows(tiles):
    """The tile set's packed rows: 'rows' where the dict carries them (a
    scene's Geometry, built once at load), else packed here."""
    rows = tiles.get("rows")
    if rows is None:
        rows = tile_rows(tiles["v0"], tiles["e1"], tiles["e2"],
                         tiles["prim"], tiles["shape"])
    return rows


def sweep_tables(tiles):
    """The sweep's per-tile-set tables: (root box (2, 3), packed rows (T,
    K, 12)). Geometry.tiles() carries both, built once per scene ('root',
    'rows'); a bare ops.accel.pack_tiles dict gets them here."""
    root = tiles.get("root")
    if root is None:
        root = root_box(tiles["lo"], tiles["hi"])
    return root, packed_rows(tiles)


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
# The leaf: a dense pass of tiles over ray blocks (plain version)
# =============================================================================

def _leaf_plain(o, d, mint, bt, j, v0, e1, e2, prim):
    """Tiles j (A,) against their ray blocks: o, d (A, B, 3), mint and the
    entry best t bt (A, B). Returns (hit (A, B), t_min, u, v, k_best), the
    first index on ties. Same float32 expressions, in the same order, as
    the kernels' leaf (csrc/tile_common.cuh)."""
    ox, oy, oz = o[..., 0:1], o[..., 1:2], o[..., 2:3]
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
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
    ok = ((torch.abs(det) >= 1e-12) & (u >= 0) & (v >= 0)
          & (u + v <= 1.0) & (prim[j][:, None, :] >= 0)
          & (t >= mint[..., None]) & (t < bt[..., None]))
    t = torch.where(ok, t, float("inf"))
    t_min, k_best = torch.min(t, dim=2)        # first index on ties
    pick = lambda a: torch.gather(a, 2, k_best[..., None])[..., 0]
    return t_min < bt, t_min, pick(u), pick(v), k_best


class _Best:
    """Per-ray closest hits of nb blocks, updated block by block."""

    def __init__(self, r):
        nb = r.shape[0]
        self.maxt = r[..., 7]
        self.t = self.maxt.clone()
        self.u = torch.zeros_like(self.t)
        self.v = torch.zeros_like(self.t)
        self.prim = torch.zeros(nb, r.shape[1], dtype=torch.int32,
                                device=r.device)
        self.shape = torch.full_like(self.prim, -1)

    def leaf(self, b, o, d, mint, j, v0, e1, e2, prim, shape, shape_off=0):
        """Fold tiles j (A,) into blocks b (A,) for rays o, d (A, B, 3)."""
        bt = self.t[b]
        hit, t_min, u, v, kb = _leaf_plain(o, d, mint, bt, j, v0, e1, e2,
                                           prim)
        self.t[b] = torch.where(hit, t_min, bt)
        self.u[b] = torch.where(hit, u, self.u[b])
        self.v[b] = torch.where(hit, v, self.v[b])
        self.prim[b] = torch.where(hit, torch.gather(prim[j], 1, kb),
                                   self.prim[b])
        self.shape[b] = torch.where(
            hit, torch.gather(shape[j], 1, kb) + shape_off, self.shape[b])

    def result(self):
        n = self.t.numel()
        no_hit = self.t >= self.maxt
        return (torch.where(no_hit, float("inf"), self.t).reshape(n),
                torch.stack([self.u, self.v], dim=-1).reshape(n, 2),
                self.prim.reshape(n),
                torch.where(no_hit, -1, self.shape).reshape(n))


# cap on the (blocks, RAY_BLOCK, TILE_K) temporaries of the plain versions
_PLAIN_MAX_ELEMS = 1 << 25
_PLAIN_CHUNK = max(1, _PLAIN_MAX_ELEMS // (RAY_BLOCK * TILE_K))


# =============================================================================
# The sweep: plain versions and CUDA kernel, one contract per entry
# =============================================================================
#
# sweep (after prepare_sweep's pre-passes):
# In:  rays (nb*RAY_BLOCK, 8) f32 [o, d, mint, maxt]; ids/tnear (nb, T);
#      count (nb,) i32; rows (T, K, 12) f32 packed triangles (tile_rows;
#      the plain version reads their row_views).
# Out: t (n,) f32 (inf on a miss), uv (n, 2) f32, prim (n,) i32,
#      shape (n,) i32 (-1 on a miss), visited (nb,) i32 tiles swept per block.
#
# sweep_small (the fused query, 1 <= T <= SWEEP_FUSED_MAX_TILES):
# In:  o, d (n, 3), mint, maxt (n,) f32 as the Ray holds them; root (2, 3);
#      lo/hi (T, 3) f32; rows as above.
# Out: t, uv, prim, shape of the n rays (no padding), visited (nb,).

def _sweep_plain(rays, ids, count, tnear, rows):
    nb = count.shape[0]
    r = rays.reshape(nb, RAY_BLOCK, 8)
    best = _Best(r)
    tris = row_views(rows)
    visited = torch.zeros(nb, dtype=torch.int32, device=rays.device)
    for c0 in range(0, nb, _PLAIN_CHUNK):
        blk = torch.arange(c0, min(c0 + _PLAIN_CHUNK, nb),
                           device=rays.device)
        bt_ub = torch.amax(best.t[blk], dim=1)
        running = torch.ones_like(blk, dtype=torch.bool)
        k = 0
        while True:
            kc = min(k, ids.shape[1] - 1)
            running &= (k < count[blk]) & (bt_ub > tnear[blk, kc])
            if not bool(running.any()):
                break
            b = blk[running]
            rb = r[b]
            best.leaf(b, rb[..., 0:3], rb[..., 3:6], rb[..., 6],
                      ids[b, k].long(), *tris)
            visited[b] += 1
            bt_ub[running] = torch.amax(best.t[b], dim=1)
            k += 1
    return best.result() + (visited,)


def _sweep_small_plain(o, d, mint, maxt, root, lo, hi, rows):
    """The fused query's plain version: the eager pre-passes without the
    coherence sort, then _sweep_plain."""
    n = o.shape[0]
    rays = torch.cat([o, d, mint[:, None], maxt[:, None]], dim=-1)
    rays = _pad_blocks(_cap_maxt_to_root(rays, root[0], root[1]))
    ids, tnear, count = _admitted_tiles(rays, lo, hi)
    t, uv, prim_o, shape_o, visited = _sweep_plain(rays, ids, count, tnear,
                                                   rows)
    return t[:n], uv[:n], prim_o[:n], shape_o[:n], visited


def _hit_outputs(n, dev, dtype):
    return (torch.empty(n, dtype=dtype, device=dev),
            torch.empty(n, 2, dtype=dtype, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))


_SUFFIX = _build.FLOAT_SUFFIX


def _entry(name, fn, rows):
    """The ctypes entry ``fn`` of kernel ``name`` for the rows' float type
    (its _f64 twin for float64 rows); raises for another type."""
    if rows.dtype not in _SUFFIX:
        raise ValueError(f"{name}: rows must be float32 or float64, got "
                         f"{rows.dtype}")
    return _build.entry(name, fn + _SUFFIX[rows.dtype])


def _rows_spec(rows, T, name):
    """The packed rows' check; the kernels read them 16 bytes at a time."""
    if rows.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned")
    return {"rows": (rows, rows.dtype, (T, TILE_K, 12))}


def _sweep_cuda(rays, ids, count, tnear, rows):
    """Launch csrc/tile_sweep.cu's sweep on the current stream (no sync);
    every float argument of the rows' type (float32, or float64 through the
    _f64 entry)."""
    fn = _entry("tile_sweep", "tile_sweep_launch", rows)
    nb, T = ids.shape
    dev = rays.device
    f = rows.dtype
    _build.check("tile_sweep", {
        "rays": (rays, f, (nb * RAY_BLOCK, 8)),
        "ids": (ids, torch.int32, (nb, T)),
        "count": (count, torch.int32, (nb,)),
        "tnear": (tnear, f, (nb, T)),
        **_rows_spec(rows, T, "tile_sweep")}, dev)
    t, uv, prim_o, shape_o = _hit_outputs(nb * RAY_BLOCK, dev, f)
    visited = torch.empty(nb, dtype=torch.int32, device=dev)
    err = fn(rays.data_ptr(), ids.data_ptr(), count.data_ptr(),
             tnear.data_ptr(), rows.data_ptr(), nb, T, t.data_ptr(),
             uv.data_ptr(), prim_o.data_ptr(), shape_o.data_ptr(),
             visited.data_ptr(), _build.stream(dev.index))
    if err != 0:
        raise RuntimeError(f"tile_sweep launch failed: cudaError {err}")
    launches["tile_sweep" + _SUFFIX[f]] += 1
    return t, uv, prim_o, shape_o, visited


def _sweep_small_cuda(o, d, mint, maxt, root, lo, hi, rows):
    """Launch csrc/tile_sweep.cu's fused query on the current stream (no
    sync); counted as a tile_sweep launch. Float arguments of the rows'
    type, as for _sweep_cuda."""
    fn = _entry("tile_sweep", "tile_sweep_small_launch", rows)
    n, T = o.shape[0], lo.shape[0]
    dev = o.device
    f = rows.dtype
    _build.check("tile_sweep", {
        "o": (o, f, (n, 3)), "d": (d, f, (n, 3)), "mint": (mint, f, (n,)),
        "maxt": (maxt, f, (n,)), "root": (root, f, (2, 3)),
        "lo": (lo, f, (T, 3)), "hi": (hi, f, (T, 3)),
        **_rows_spec(rows, T, "tile_sweep")}, dev)
    nb = -(-n // RAY_BLOCK)
    t, uv, prim_o, shape_o = _hit_outputs(n, dev, f)
    visited = torch.empty(nb, dtype=torch.int32, device=dev)
    if n == 0:
        return t, uv, prim_o, shape_o, visited
    err = fn(o.data_ptr(), d.data_ptr(), mint.data_ptr(), maxt.data_ptr(), n,
             root.data_ptr(), lo.data_ptr(), hi.data_ptr(), T,
             rows.data_ptr(), t.data_ptr(), uv.data_ptr(), prim_o.data_ptr(),
             shape_o.data_ptr(), visited.data_ptr(), _build.stream(dev.index))
    if err != 0:
        # the entry range-checks the tile count (cudaErrorInvalidValue)
        raise RuntimeError(f"tile_sweep fused query on {T} tiles failed: "
                           f"cudaError {err}")
    launches["tile_sweep" + _SUFFIX[f]] += 1
    return t, uv, prim_o, shape_o, visited


def sweep(rays, ids, count, tnear, rows):
    """The sweep on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors (or under use_plain)."""
    args = (rays, ids, count, tnear, rows)
    if _on_plain(rays, "tile_sweep"):
        return _sweep_plain(*args)
    return _sweep_cuda(*args)


def sweep_small(o, d, mint, maxt, root, lo, hi, rows):
    """The fused query (prepare_small's arguments) on the tensors' device:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors (or
    under use_plain)."""
    args = (o, d, mint, maxt, root, lo, hi, rows)
    if _on_plain(o, "tile_sweep"):
        return _sweep_small_plain(*args)
    return _sweep_small_cuda(*args)


def _ray_rows(ray, dtype=torch.float32):
    """(N, 8) rows [o, d, mint, maxt] of a Ray in ``dtype`` (the tile
    set's)."""
    return torch.cat([ray.o, ray.d, ray.mint[:, None], ray.maxt[:, None]],
                     dim=-1).to(dtype)


def _pad_blocks(rays):
    """Pad to whole blocks with dead filler rays (d = +z, maxt = mint = 0)."""
    pad = -rays.shape[0] % RAY_BLOCK
    if pad:
        filler = torch.zeros(pad, 8, dtype=rays.dtype, device=rays.device)
        filler[:, 5] = 1.0
        rays = torch.cat([rays, filler], dim=0)
    return rays.contiguous()


def _unsorted(out, unsort, n):
    if unsort is not None:
        return tuple(a[unsort] for a in out)
    return tuple(a[:n] for a in out)


def prepare_sweep(tiles, ray):
    """The pre-passes of intersect_tiles_sorted: -> (sweep arguments,
    unsort index or None, number of real rays)."""
    n = ray.o.shape[0]
    root, rows = sweep_tables(tiles)
    rays = _cap_maxt_to_root(_ray_rows(ray, rows.dtype), root[0], root[1])
    rays, unsort = _maybe_sorted(rays, root[0], root[1])
    rays = _pad_blocks(rays)
    ids, tnear, count = _admitted_tiles(rays, tiles["lo"], tiles["hi"])
    args = (rays, ids, count, tnear, rows)
    return args, unsort, n


def prepare_small(tiles, ray):
    """The fused query's arguments (no eager pre-pass: the ray fields as
    the Ray holds them, the tile set's tables)."""
    root, rows = sweep_tables(tiles)
    cast = lambda a: a.to(rows.dtype).contiguous()
    return (cast(ray.o), cast(ray.d), cast(ray.mint), cast(ray.maxt), root,
            tiles["lo"], tiles["hi"], rows)


def intersect_tiles_sorted(tiles, ray, return_visited=False):
    """The sweep pipeline with its eager pre-passes and the coherence sort
    (any number of tiles); intersect_tiles' path above the fused query's
    reach."""
    args, unsort, n = prepare_sweep(tiles, ray)
    t, uv, prim, shape, visited = sweep(*args)
    out = _unsorted((t, uv, prim, shape), unsort, n)
    return out + (visited,) if return_visited else out


def intersect_tiles(tiles, ray, return_visited=False):
    """Closest-hit query over the tile set.

    tiles: dict of tensors in the ops.accel.pack_tiles layout, optionally
    with the sweep_tables 'root' and 'rows'; ray: core.ray Ray with
    (N,)-shaped fields. Returns (t, uv, prim, shape) with t = inf and
    shape = -1 on a miss; with ``return_visited`` also the (nb,) count of
    tiles each ray block swept. Up to SWEEP_FUSED_MAX_TILES tiles and
    SWEEP_FUSED_MAX_RAY_TILES rays x tiles: the fused query (one kernel
    launch on the card); above: the sorted pipeline.
    """
    T = tiles["v0"].shape[0]
    if (T > SWEEP_FUSED_MAX_TILES
            or ray.o.shape[0] * T > SWEEP_FUSED_MAX_RAY_TILES):
        return intersect_tiles_sorted(tiles, ray, return_visited)
    out = sweep_small(*prepare_small(tiles, ray))
    return out if return_visited else out[:4]


# =============================================================================
# The CUDA kernels (built by ops/_build.py at first use)
# =============================================================================

# kernel -> its launch function's ctypes argument types
_P, _I, _L = _build.PTR, _build.INT, _build.LONG
_ENTRIES = {
    "tile_sweep": {
        "tile_sweep_launch": [_P] * 5 + [_I] * 2 + [_P] * 6,
        "tile_sweep_small_launch": [_P] * 4 + [_L] + [_P] * 3 + [_I]
                                   + [_P] * 7},
    "tile_bvh": {"tile_bvh_launch": [_P] * 6 + [_I] + [_P] * 6},
    "tile_bvh8": {"tile_bvh8_launch": [_P] * 6 + [_I] + [_P] * 6},
}
for _name, _entries in _ENTRIES.items():
    _build.register(_name, _entries, headers=(
        ("tile_common.cuh",) if _name == "tile_sweep"
        else ("tile_common.cuh", "tile_walk.cuh")))
KERNELS = tuple(_ENTRIES)


# =============================================================================
# Tile-BVH traversals: plain versions and CUDA kernels, one contract
# =============================================================================
#
# In:  rays (nb*RAY_BLOCK, 8) f32; the tree (binary: nbox (N, 1, 8) f32 and
#      nmeta (N, 4) i32; 8-wide: cbox (N8, 8, 8) f32 and cmeta (N8, 8, 4)
#      i32, the ops/bvh.py layouts); xf (I+1, 12) f32 world-to-local affine
#      rows (row 0 the identity) and sbase (I+1,) i32 shape bases, indexed
#      by inst + 1; rows (T, K, 12) f32 packed triangles (tile_rows; the
#      plain versions read their row_views).
# Out: t, uv, prim, shape as for the sweep; stats (n / BVH_GROUP, 3) i32 per
#      group: [inner nodes visited, leaves visited, deepest stack]. A
#      deepest stack of STACK_SIZE + 1 marks an overflow, which ends that
#      group's walk; the wrappers raise on it.
#
# Both plain versions walk each group's tree exactly as the kernels do:
# one (groups, STACK_SIZE) stack, one pop per running group per step, leaf
# and inner steps in the same order, the same float32 expressions and the
# same culling bound (the group's largest best t).

def _rcp(d):
    """Per-ray reciprocal direction, finite for zero components."""
    return torch.where(d < 0, -1.0, 1.0) / torch.clamp(torch.abs(d),
                                                      min=1e-30)


def _slab_plain(box, o, inv, mint, far_cap):
    """Slab tests of boxes (..., 8) against rays o, inv (..., B, 3): box
    dims broadcast against the rays'. Returns (ok, near) of shape (..., B)."""
    lo, hi = box[..., None, 0:3], box[..., None, 3:6]
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    mn = torch.minimum(t0, t1)
    mx = torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]),
                         torch.maximum(mn[..., 2], mint))
    far = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]),
                        torch.minimum(mx[..., 2], far_cap))
    return near <= far, near


class _Walk:
    """Group-uniform traversal state of nb groups: per-group stacks,
    stack pointers, culling bounds and stats."""

    def __init__(self, r, best):
        nb = r.shape[0]
        dev = r.device
        self.r = r
        self.inv = _rcp(r[..., 3:6])
        self.best = best
        self.stack = torch.zeros(nb, STACK_SIZE, dtype=torch.int64,
                                 device=dev)   # slot 0 = root, node 0
        self.sp = torch.ones(nb, dtype=torch.int64, device=dev)
        self.bt_ub = torch.amax(r[..., 7], dim=1)
        self.stats = torch.zeros(nb, 3, dtype=torch.int32, device=dev)
        self.stats[:, 2] = 1

    def pop(self, blk):
        """Pop one entry of every running block of blk: (blocks, entries),
        or None once all have finished."""
        b = blk[self.sp[blk] > 0]
        if b.numel() == 0:
            return None
        self.sp[b] -= 1
        return b, self.stack[b, self.sp[b]]

    def leaf(self, b, tile, k, xf, sbase, tris):
        """Leaves (tile, inst + 1 = k) of blocks b: the rays moved into
        instance space by xf[k], then the dense tile pass."""
        rb = self.r[b]
        m = xf[k][:, :, None]                      # (A, 12, 1)
        ox, oy, oz = rb[..., 0], rb[..., 1], rb[..., 2]
        dx, dy, dz = rb[..., 3], rb[..., 4], rb[..., 5]
        o = torch.stack(
            [m[:, 0] * ox + m[:, 1] * oy + m[:, 2] * oz + m[:, 3],
             m[:, 4] * ox + m[:, 5] * oy + m[:, 6] * oz + m[:, 7],
             m[:, 8] * ox + m[:, 9] * oy + m[:, 10] * oz + m[:, 11]], dim=-1)
        d = torch.stack([m[:, 0] * dx + m[:, 1] * dy + m[:, 2] * dz,
                         m[:, 4] * dx + m[:, 5] * dy + m[:, 6] * dz,
                         m[:, 8] * dx + m[:, 9] * dy + m[:, 10] * dz], dim=-1)
        self.best.leaf(b, o, d, rb[..., 6], tile, *tris,
                       shape_off=sbase[k][:, None])
        self.bt_ub[b] = torch.amax(self.best.t[b], dim=1)
        self.stats[b, 1] += 1

    def enter(self, b, boxes):
        """Block-wide slab tests of boxes (A, C, 8) for blocks b (A,):
        (some ray enters (A, C), block-min entry distance (A, C))."""
        self.stats[b, 0] += 1
        rb = self.r[b][:, None]
        far_cap = torch.minimum(rb[..., 7], self.bt_ub[b][:, None, None])
        ok, near = _slab_plain(boxes, rb[..., 0:3], self.inv[b][:, None],
                               rb[..., 6], far_cap)
        return ok.any(dim=-1), torch.amin(
            torch.where(ok, near, float("inf")), dim=-1)

    def push(self, b, entries, count):
        """Push entries (A, C) in column order, the first count (A,) of each
        row, onto blocks b; a push past STACK_SIZE ends the block's walk
        with an overflow mark instead."""
        sp = self.sp[b]
        top = sp + count
        over = top > STACK_SIZE
        cols = torch.arange(entries.shape[1], device=b.device)
        put = (cols[None] < count[:, None]) & ~over[:, None]
        rows = b[:, None].expand_as(entries)[put]
        self.stack[rows, (sp[:, None] + cols[None])[put]] = entries[put]
        self.sp[b] = torch.where(over, 0, top)
        self.stats[b, 2] = torch.where(
            over, STACK_SIZE + 1,
            torch.maximum(self.stats[b, 2], top.to(torch.int32)))


# groups a plain walk takes at once (its temporaries under _PLAIN_MAX_ELEMS)
_BVH_CHUNK = _PLAIN_MAX_ELEMS // (BVH_GROUP * TILE_K)


def _bvh_plain(rays, nbox, nmeta, xf, sbase, rows):
    r = rays.reshape(-1, BVH_GROUP, 8)
    nb = r.shape[0]
    best = _Best(r)
    walk = _Walk(r, best)
    box = nbox.reshape(-1, 8)
    meta = nmeta.long()
    tris = row_views(rows)
    for c0 in range(0, nb, _BVH_CHUNK):
        blk = torch.arange(c0, min(c0 + _BVH_CHUNK, nb), device=rays.device)
        while (popped := walk.pop(blk)) is not None:
            b, node = popped
            m = meta[node]
            is_leaf = m[:, 2] >= 0
            if bool(is_leaf.any()):
                walk.leaf(b[is_leaf], m[is_leaf, 2], m[is_leaf, 3] + 1, xf,
                          sbase, tris)
            if bool(is_leaf.all()):
                continue
            b, m = b[~is_leaf], m[~is_leaf]
            hit, near = walk.enter(b, box[m[:, 0:2]])
            left, right = m[:, 0], m[:, 1]
            # the near child on top (popped first); both missed: left first
            l_first = near[:, 0] <= near[:, 1]
            first = torch.where(l_first, left, right)
            second = torch.where(l_first, right, left)
            push_first = torch.where(l_first, hit[:, 0], hit[:, 1])
            push_second = torch.where(l_first, hit[:, 1], hit[:, 0])
            # pushed in order: the far child if entered, then the near one
            entries = torch.stack([torch.where(push_second, second, first),
                                   torch.where(push_second, first, second)],
                                  dim=1)
            walk.push(b, entries, push_first.long() + push_second.long())
    return best.result() + (walk.stats,)


def _bvh8_plain(rays, cbox, cmeta, xf, sbase, rows):
    r = rays.reshape(-1, BVH_GROUP, 8)
    nb = r.shape[0]
    best = _Best(r)
    walk = _Walk(r, best)
    meta = cmeta.long()
    tris = row_views(rows)
    for c0 in range(0, nb, _BVH_CHUNK):
        blk = torch.arange(c0, min(c0 + _BVH_CHUNK, nb), device=rays.device)
        while (popped := walk.pop(blk)) is not None:
            b, enc = popped
            is_leaf = enc < 0
            if bool(is_leaf.any()):
                code = -enc[is_leaf] - 1
                walk.leaf(b[is_leaf], code >> LEAF_INST_BITS,
                          code & ((1 << LEAF_INST_BITS) - 1), xf, sbase, tris)
            if bool(is_leaf.all()):
                continue
            b, node = b[~is_leaf], enc[~is_leaf]
            hit, near = walk.enter(b, cbox[node])          # (A, 8)
            m8 = meta[node]                                 # (A, 8, 4)
            cid, tile8, inst8 = m8[..., 0], m8[..., 1], m8[..., 2]
            hit &= (cid >= 0) | (tile8 >= 0)
            enc8 = torch.where(
                cid >= 0, cid,
                -((tile8 << LEAF_INST_BITS) | (inst8 + 1)) - 1)
            # far to near: the largest entry distance among those left,
            # ties to the highest slot, so the nearest child pops first
            # (slots reversed, then a stable sort, keeps ties high slot first)
            key = torch.where(hit, near, float("-inf")).flip(1)
            order = 7 - torch.sort(key, dim=1, descending=True,
                                   stable=True)[1]
            walk.push(b, torch.gather(enc8, 1, order), hit.sum(dim=1))
    return best.result() + (walk.stats,)


def _traverse_cuda(name, rays, tree_box, tree_meta, xf, sbase, rows):
    """Launch csrc/<name>.cu (tile_bvh or tile_bvh8) on the current stream
    (no sync); float arguments of the rows' type (float32, or float64
    through the _f64 entry)."""
    fn = _entry(name, f"{name}_launch", rows)
    nb = rays.shape[0] // RAY_BLOCK
    dev = rays.device
    f = rows.dtype
    N, I1 = tree_box.shape[0], xf.shape[0]
    box_shape, meta_shape = (((N, 1, 8), (N, 4)) if name == "tile_bvh"
                             else ((N, 8, 8), (N, 8, 4)))
    _build.check(name, {
        "rays": (rays, f, (nb * RAY_BLOCK, 8)),
        "box": (tree_box, f, box_shape),
        "meta": (tree_meta, torch.int32, meta_shape),
        "xf": (xf, f, (I1, 12)),
        "sbase": (sbase, torch.int32, (I1,)),
        **_rows_spec(rows, rows.shape[0], name)}, dev)
    if tree_meta.data_ptr() % 16:
        raise ValueError(f"{name}: meta must be 16-byte aligned")
    t, uv, prim_o, shape_o = _hit_outputs(nb * RAY_BLOCK, dev, f)
    stats = torch.empty(nb * RAY_BLOCK // BVH_GROUP, 3, dtype=torch.int32,
                        device=dev)
    err = fn(
        rays.data_ptr(), tree_box.data_ptr(), tree_meta.data_ptr(),
        xf.data_ptr(), sbase.data_ptr(), rows.data_ptr(), nb, t.data_ptr(), uv.data_ptr(), prim_o.data_ptr(), shape_o.data_ptr(),
        stats.data_ptr(), _build.stream(dev.index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name + _SUFFIX[f]] += 1
    return t, uv, prim_o, shape_o, stats


_PLAIN_WALKS = {"tile_bvh": _bvh_plain, "tile_bvh8": _bvh8_plain}


def traverse(name, rays, tree_box, tree_meta, xf, sbase, rows):
    """The BVH traversal ``name`` (tile_bvh: binary tree nbox/nmeta;
    tile_bvh8: 8-wide tree cbox/cmeta) on the tensors' device: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors (or under
    use_plain). Raises on a stack overflow."""
    args = (rays, tree_box, tree_meta, xf, sbase, rows)
    if _on_plain(rays, name):
        out = _PLAIN_WALKS[name](*args)
    else:
        out = _traverse_cuda(name, *args)
    stats = out[4]
    if stats.numel() and int(stats[:, 2].max()) > STACK_SIZE:
        raise RuntimeError(
            f"{name}: a group's traversal stack overflowed its "
            f"{STACK_SIZE} entries")
    return out


def _identity_xf(dev, dtype=torch.float32):
    """The instancing rows of a scene without instances: the identity
    (pallas_intersect.py:434-438) and shape base 0."""
    return (torch.tensor([[1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]],
                         dtype=dtype, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def prepare_bvh(tiles, ray, wide=False):
    """The pre-passes of intersect_bvh (``wide``: intersect_bvh8) ->
    (traversal arguments, unsort index or None, number of real rays).

    The binary traversal caps maxt at the root box (nbox[0]); the 8-wide
    one does not, and takes its sort bounds from the root's 8 slots, where
    empty slots' inverted boxes drop out of the min/max."""
    n = ray.o.shape[0]
    rays = _ray_rows(ray, tiles["lo"].dtype)
    if wide:
        root = tiles["cbox"][0]
        lo = torch.amin(root[:, 0:3], dim=0)
        hi = torch.amax(root[:, 3:6], dim=0)
    else:
        root = tiles["nbox"][0, 0]
        lo, hi = root[0:3], root[3:6]
        rays = _cap_maxt_to_root(rays, lo, hi)
    rays, unsort = _maybe_sorted(rays, lo, hi)
    rays = _pad_blocks(rays)
    if tiles.get("xf") is None:
        xf, sbase = _identity_xf(rays.device, rays.dtype)
    else:
        xf, sbase = tiles["xf"], tiles["sbase"]
    tree = ((tiles["cbox"], tiles["cmeta"]) if wide
            else (tiles["nbox"], tiles["nmeta"]))
    args = (rays,) + tree + (xf, sbase, packed_rows(tiles))
    return args, unsort, n


def intersect_bvh(tiles, ray, return_stats=False, wide=False):
    """Closest-hit query through the binary tile BVH (``wide``: the 8-wide
    one, 'cbox'/'cmeta' from ops.bvh.collapse_to_bvh8).

    tiles: the pack_tiles tensors plus 'nbox' (N,1,8) / 'nmeta' (N,4);
    instanced scenes add 'xf' (I+1, 12) world-to-local affine rows (row 0
    the identity) and 'sbase' (I+1,) shape bases. Same contract as
    intersect_tiles; 'rows' (packed_rows) where the dict carries them.
    ``return_stats`` adds the (n / BVH_GROUP, 3) per-group [inner nodes,
    leaves, deepest stack]."""
    args, unsort, n = prepare_bvh(tiles, ray, wide)
    t, uv, prim, shape, stats = traverse(
        "tile_bvh8" if wide else "tile_bvh", *args)
    out = _unsorted((t, uv, prim, shape), unsort, n)
    return out + (stats,) if return_stats else out


def intersect_bvh8(tiles, ray, return_stats=False):
    """Closest-hit query through the 8-wide tile BVH; as intersect_bvh."""
    return intersect_bvh(tiles, ray, return_stats, wide=True)
