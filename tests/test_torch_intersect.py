"""The port's tile sweep against eradiate_kernel_tpu/ops/pallas_intersect.py.

Host-side pieces (tile packing and the sweep's pre-passes) must be
bit-equal. The plain sweep must match the Pallas kernel run in interpret
mode: t within rtol 1e-6 (both evaluate the same float32 expression),
widened only for ill-conditioned hits by the rounding bound of XLA's fused
multiply-adds; the same miss set; and the same prim/shape wherever the hit
t is unique.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_mesh import terrain
from eradiate_kernel_tpu.core.ray import Ray as JRay
from eradiate_kernel_tpu.ops import accel as jaccel
from eradiate_kernel_tpu.ops import pallas_intersect as jpi
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.ops import accel, intersect
from eradiate_kernel_tpu_torch.render.geometry import moller_trumbore


def soup(F=500, seed=0):
    """Random triangle soup in [-1.15, 1.15]^3 (tests/test_accel.py:14)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (F, 3))
    verts = (centers[:, None, :]
             + rng.uniform(-0.15, 0.15, (F, 3, 3))).reshape(-1, 3)
    return verts.astype(np.float32), np.arange(3 * F, dtype=np.int32
                                               ).reshape(F, 3)


MESHES = {"soup": lambda: soup(500), "terrain": lambda: terrain(33)}


def _rays(n, seed=2):
    """Rays aimed at the mesh region, some axis-aligned, some with finite
    maxt, plus a few dead (maxt <= mint) lanes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:32] = (np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
              * rng.choice([-1.0, 1.0], 32)[:, None])
    mint = np.full(n, 1.8e-4, np.float32)
    maxt = np.full(n, np.inf, np.float32)
    maxt[n // 2:] = rng.uniform(0.5, 6.0, n - n // 2)
    maxt[-8:] = 0.0
    return o, d.astype(np.float32), mint, maxt


def _t_condition(V, F, prim, o, d):
    """Condition number of Moller-Trumbore's t on each ray's hit triangle
    (float64): relative rounding error of t per unit rounding of its
    inputs, |e1||e2| (|o - v0| / |e2.q| + 1 / |det|)."""
    f = F[np.maximum(prim, 0)].astype(np.int64)
    v0, v1, v2 = (V[f[:, i]].astype(np.float64) for i in range(3))
    e1, e2 = v1 - v0, v2 - v0
    tv = o - v0
    q = np.cross(tv, e1)
    det = np.sum(e1 * np.cross(d, e2), -1)
    n1, n2 = np.linalg.norm(e1, axis=-1), np.linalg.norm(e2, axis=-1)
    return n1 * n2 * (np.linalg.norm(tv, axis=-1)
                      / np.abs(np.sum(e2 * q, -1)) + 1 / np.abs(det))


def _tiles(name):
    V, F = MESHES[name]()
    return V, F, accel.pack_tiles(V, None, F, np.zeros(len(F), np.int32))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_pack_tiles_bit_equal(name):
    V, F, tiles = _tiles(name)
    ref = jaccel.pack_tiles(V, None, F, np.zeros(len(F), np.int32))
    assert set(tiles) == set(ref)
    for k in ref:
        assert tiles[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(tiles[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_prepasses_bit_equal(name):
    V, F, tiles = _tiles(name)
    n = 3 * intersect.RAY_BLOCK
    o, d, mint, maxt = _rays(n)
    rays = np.concatenate([o, d, mint[:, None], maxt[:, None]], 1)
    lo, hi = tiles["lo"], tiles["hi"]
    rlo, rhi = lo.min(0), hi.max(0)

    capped = intersect._cap_maxt_to_root(torch.as_tensor(rays),
                                         torch.as_tensor(rlo),
                                         torch.as_tensor(rhi))
    ref_capped = np.asarray(jpi._cap_maxt_to_root(jnp.asarray(rays),
                                                  jnp.asarray(rlo),
                                                  jnp.asarray(rhi)))
    np.testing.assert_array_equal(capped.numpy(), ref_capped)

    keys = intersect._coherence_keys(capped, torch.as_tensor(rlo),
                                     torch.as_tensor(rhi))
    ref_keys = np.asarray(jpi._coherence_keys(jnp.asarray(ref_capped),
                                              jnp.asarray(rlo),
                                              jnp.asarray(rhi)))
    np.testing.assert_array_equal(keys.numpy(), ref_keys.astype(np.int64))

    mask, tnear = intersect._block_tile_mask(capped, torch.as_tensor(lo),
                                             torch.as_tensor(hi))
    ref_mask, ref_tnear = jpi._block_tile_mask(
        jnp.asarray(ref_capped), jnp.asarray(lo), jnp.asarray(hi),
        return_tnear=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask) == 1)
    np.testing.assert_array_equal(tnear.numpy(), np.asarray(ref_tnear))
    assert mask.any()


def _assert_matches_pallas(V, F, tiles, o, d, mint, maxt, out):
    """The port's (t, uv, prim, shape, visited) against the Pallas kernel
    in interpret mode on the same rays, under Queue 2's contract."""
    n = o.shape[0]
    t, uv, prim, shape, visited = out
    jray = JRay.make(jnp.asarray(o), jnp.asarray(d), mint=jnp.asarray(mint),
                     maxt=jnp.asarray(maxt), wavelengths=jnp.zeros((n, 0)))
    rt, ruv, rprim, rshape = (np.asarray(a) for a in jpi.intersect_tiles(
        {k: jnp.asarray(v) for k, v in tiles.items()}, jray,
        interpret=True))
    t = t.numpy()
    hit = np.isfinite(rt)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    assert hit.sum() > n // 10
    # rtol 1e-6, widened where the triple products cancel: XLA on the CPU
    # fuses multiply-adds and eager torch does not, and the two roundings
    # may differ by a few ulps times the condition number of t = e2.q/det
    err = np.abs(t[hit] - rt[hit]) / np.abs(rt[hit])
    bound = 2 * np.finfo(np.float32).eps * _t_condition(V, F, rprim, o, d)
    assert (err > 1e-6).mean() <= 0.01
    np.testing.assert_array_less(err, np.maximum(1e-6, bound[hit]) + 1e-12)
    # u, v are ratios of triple products that cancel (origins up to 4
    # units away); both sides sit ~1e-5 from a float64 evaluation, and XLA
    # rounds its fused multiply-adds differently from eager torch
    np.testing.assert_allclose(uv.numpy()[hit], ruv[hit], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(shape.numpy(), rshape)
    # prim must agree wherever no other triangle reaches the same t
    unique = _unique_hits(V, F, o, d, t)
    assert unique.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(prim.numpy()[unique], rprim[unique])
    # the early exit leaves the visit count at or below the admitted count
    assert int(visited.sum()) > 0


def _unique_hits(V, F, o, d, t):
    """Rays whose hit t no other triangle of the mesh reaches (within
    1e-6 relative)."""
    n = o.shape[0]
    tt, _, _, ok = moller_trumbore(
        torch.as_tensor(o)[:, None], torch.as_tensor(d)[:, None],
        *(torch.as_tensor(V[F[:, i]]) for i in range(3)))
    tt = torch.where(ok, tt, float("inf")).numpy()
    hit = np.isfinite(t)
    ties = np.zeros(n, np.int64)
    ties[hit] = (np.abs(tt[hit] - t[hit, None])
                 <= 1e-6 * np.abs(t[hit, None])).sum(1)
    return ties == 1


def _ray(o, d, mint, maxt):
    return Ray(o=torch.as_tensor(o), d=torch.as_tensor(d),
               mint=torch.as_tensor(mint), maxt=torch.as_tensor(maxt),
               time=torch.zeros(o.shape[0]))


# both tile sets are fused-query sized (4 and 16 tiles): intersect_tiles
# takes the fused query's plain version, unsorted at either ray count
@pytest.mark.parametrize("n", [600, 1100])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_plain_sweep_matches_pallas(name, n):
    V, F, tiles = _tiles(name)
    o, d, mint, maxt = _rays(n, seed=n)
    out = intersect.intersect_tiles(
        {k: torch.as_tensor(v) for k, v in tiles.items()},
        _ray(o, d, mint, maxt), return_visited=True)
    _assert_matches_pallas(V, F, tiles, o, d, mint, maxt, out)


# a one-tile set (100 triangles, the atmosphere cube's case) and an
# eight-tile one (1,000 triangles)
SMALL = {"tile1": lambda: soup(100, seed=5), "tiles8": lambda: soup(1000)}


@pytest.mark.parametrize("path", ["fused", "sorted"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_tile_sets_match_pallas(name, path):
    """The fused query's plain version (unsorted) and the sorted pipeline
    against the Pallas kernel; 1,100 rays are past SORT_MIN_RAYS, so the
    sorted pipeline sorts."""
    V, F = SMALL[name]()
    tiles = accel.pack_tiles(V, None, F, np.zeros(len(F), np.int32))
    assert len(tiles["lo"]) == {"tile1": 1, "tiles8": 8}[name]
    o, d, mint, maxt = _rays(1100, seed=11)
    query = {"fused": intersect.intersect_tiles,
             "sorted": intersect.intersect_tiles_sorted}[path]
    out = query({k: torch.as_tensor(v) for k, v in tiles.items()},
                _ray(o, d, mint, maxt), return_visited=True)
    _assert_matches_pallas(V, F, tiles, o, d, mint, maxt, out)


@pytest.mark.parametrize("name", sorted(SMALL) + ["terrain"])
def test_fused_query_matches_sorted_pipeline(name):
    """Without the coherence sort the blocks hold other rays and visit
    tiles in another order: t is the same exactly, prim, shape and uv
    wherever the hit t is unique."""
    V, F = {**SMALL, **MESHES}[name]()
    tiles = {k: torch.as_tensor(v) for k, v in accel.pack_tiles(
        V, None, F, np.arange(len(F), dtype=np.int32) % 3).items()}
    o, d, mint, maxt = _rays(1100, seed=12)
    ray = _ray(o, d, mint, maxt)
    fused = intersect.intersect_tiles(tiles, ray)
    ref = intersect.intersect_tiles_sorted(tiles, ray)
    np.testing.assert_array_equal(fused[0].numpy(), ref[0].numpy())
    assert np.isfinite(ref[0].numpy()).sum() > 100
    unique = _unique_hits(V, F, o, d, ref[0].numpy())
    for a, b in zip(fused[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy()[unique], b.numpy()[unique])
    np.testing.assert_array_equal(fused[3].numpy() >= 0,
                                  ref[3].numpy() >= 0)


def test_sweep_tables_built_once_at_load():
    """A scene's Geometry carries the root box (amin of the tile boxes' lo,
    amax of their hi) and the packed rows; the query reads them from
    tiles() instead of reducing per query."""
    from eradiate_kernel_tpu_torch.scene import load_dict

    V, F = terrain(17)
    scene = load_dict({
        "type": "scene",
        "m": {"type": "mesh", "vertices": V, "faces": F},
        "camera": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}}},
        "integrator": {"type": "path"}}, device="cpu")
    geo = scene.geo
    tiles = geo.tiles()
    assert tiles["root"] is geo.tiles_root
    np.testing.assert_array_equal(
        tiles["root"].numpy(),
        np.stack([geo.tiles_lo.numpy().min(0), geo.tiles_hi.numpy().max(0)]))
    rows = tiles["rows"].numpy()
    assert rows.shape == (len(geo.tiles_lo), intersect.TILE_K, 12)
    np.testing.assert_array_equal(rows[..., 0:3], geo.tiles_v0.numpy())
    np.testing.assert_array_equal(rows[..., 3:6], geo.tiles_e1.numpy())
    np.testing.assert_array_equal(rows[..., 6:9], geo.tiles_e2.numpy())
    ids = rows[..., 9:12].view(np.int32)
    np.testing.assert_array_equal(ids[..., 0], geo.tiles_prim.numpy())
    np.testing.assert_array_equal(ids[..., 1], geo.tiles_shape.numpy())
    assert not ids[..., 2].any()
    # the same hits as a query that builds the tables itself
    o, d, mint, maxt = _rays(300, seed=3)
    ray = _ray(o, d, mint, maxt)
    bare = {k: v for k, v in tiles.items() if k not in ("root", "rows")}
    for a, b in zip(intersect.intersect_tiles(tiles, ray),
                    intersect.intersect_tiles(bare, ray)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_tiles, n_rays, path", [
    (1, 1 << 15, "fused"),    # the atmosphere's cube under its lane pool
    (32, 1 << 15, "fused"),
    (8, 1 << 20, "fused"),    # 2^23 rays x tiles, at the limit
    (16, 1 << 20, "sorted"),
    (1, (1 << 23) + 1, "sorted"),
    (33, 16, "sorted"),       # past the fused entry's capacity
])
def test_fused_query_reach(monkeypatch, n_tiles, n_rays, path):
    """intersect_tiles takes the fused query up to SWEEP_FUSED_MAX_TILES
    tiles and SWEEP_FUSED_MAX_RAY_TILES rays x tiles, else the sorted
    pipeline."""
    import types

    taken = []
    monkeypatch.setattr(intersect, "prepare_small", lambda t, r: ())
    monkeypatch.setattr(intersect, "sweep_small",
                        lambda *a: taken.append("fused") or (None,) * 5)
    monkeypatch.setattr(intersect, "intersect_tiles_sorted",
                        lambda t, r, v: taken.append("sorted"))
    intersect.intersect_tiles({"v0": torch.empty(n_tiles, 0, 3)},
                              types.SimpleNamespace(o=torch.empty(n_rays, 0)))
    assert taken == [path]


@pytest.mark.parametrize("accel", ["bvh", "bvh8"])
def test_bvh_scenes_build_no_sweep_rows(monkeypatch, accel):
    """A scene holds one copy of its triangles: the packed rows, built once
    at load, which the sweep and both BVH kernels read; the pack_tiles
    fields are views of them, and a BVH query reads the same tensor as a
    sweep query and finds the same hits."""
    from eradiate_kernel_tpu_torch.render.geometry import (
        ray_intersect_preliminary)
    from eradiate_kernel_tpu_torch.scene import load_dict

    V, F = terrain(17)
    geo = load_dict({
        "type": "scene",
        "m": {"type": "mesh", "vertices": V, "faces": F},
        "camera": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}}},
        "integrator": {"type": "path"}}, device="cpu").geo
    rows = geo.tiles_rows
    base = rows.untyped_storage().data_ptr()
    for name in ("tiles_v0", "tiles_e1", "tiles_e2", "tiles_prim",
                 "tiles_shape"):
        assert getattr(geo, name).untyped_storage().data_ptr() == base, name
    o, d, mint, maxt = _rays(300, seed=4)
    ray = _ray(o, d, mint, maxt)
    seen = []
    traverse = intersect.traverse
    monkeypatch.setattr(intersect, "traverse",
                        lambda *a, **kw: seen.append(a[6]) or traverse(*a,
                                                                       **kw))
    monkeypatch.setenv("ERT_ACCEL", accel)
    assert geo.tiles()["rows"] is rows
    via_bvh = ray_intersect_preliminary(geo, ray)
    assert len(seen) == 1 and seen[0] is rows
    monkeypatch.setenv("ERT_ACCEL", "tiles")
    via_sweep = ray_intersect_preliminary(geo, ray)
    assert geo.tiles_rows is rows and geo.tiles()["rows"] is rows
    np.testing.assert_array_equal(via_bvh.t.numpy(), via_sweep.t.numpy())


def _geo(n_tiles, n_instances=0, n_bvh8=1):
    """The fields _accel_mode reads, at the given sizes."""
    import types

    return types.SimpleNamespace(
        tiles_v0=torch.empty(n_tiles, 0, 3), n_instances=n_instances,
        bvh8_box=torch.empty(n_bvh8, 8, 8))


def test_sweep_size_policy(monkeypatch):
    """The sweep up to MAX_SWEEP_TILES tiles, the binary BVH above and for
    every instanced scene (the reference's policy on its TPU)."""
    from eradiate_kernel_tpu_torch.render.geometry import (MAX_SWEEP_TILES,
                                                           _accel_mode)

    monkeypatch.delenv("ERT_ACCEL", raising=False)
    monkeypatch.delenv("ERT_BVH_WIDE", raising=False)
    assert MAX_SWEEP_TILES == 2048
    assert _accel_mode(_geo(2048)) == "tiles"
    assert _accel_mode(_geo(2049)) == "bvh"
    assert _accel_mode(_geo(3, n_instances=2)) == "bvh"


@pytest.mark.parametrize("env, geo, mode", [
    ({"ERT_BVH_WIDE": "1"}, _geo(2049), "bvh8"),
    ({"ERT_BVH_WIDE": "1"}, _geo(2049, n_bvh8=0), "bvh"),
    ({"ERT_BVH_WIDE": "1"}, _geo(12), "tiles"),
    ({"ERT_ACCEL": "tiles"}, _geo(5000), "tiles"),
    ({"ERT_ACCEL": "tiles"}, _geo(12, n_instances=1), "bvh"),
    ({"ERT_ACCEL": "bvh"}, _geo(12), "bvh"),
    ({"ERT_ACCEL": "bvh8"}, _geo(12), "bvh8"),
    ({"ERT_ACCEL": "bvh8"}, _geo(12, n_bvh8=0), "bvh"),
])
def test_accel_mode_overrides(monkeypatch, env, geo, mode):
    from eradiate_kernel_tpu_torch.render.geometry import _accel_mode

    monkeypatch.delenv("ERT_ACCEL", raising=False)
    monkeypatch.delenv("ERT_BVH_WIDE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _accel_mode(geo) == mode


def test_accel_mode_refuses_naive(monkeypatch):
    from eradiate_kernel_tpu_torch.render.geometry import _accel_mode

    monkeypatch.setenv("ERT_ACCEL", "naive")
    with pytest.raises(ValueError, match="brute-force"):
        _accel_mode(_geo(12))
