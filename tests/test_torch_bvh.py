"""The port's tile BVH against eradiate_kernel_tpu/ops/bvh.py and
eradiate_kernel_tpu/ops/pallas_intersect.py.

The BVH arrays must be bit-equal. The plain traversals (binary and
8-wide) must match the Pallas kernels run in interpret mode (the pattern
of tests/test_accel.py:142-200): the same miss set, t within rtol 1e-6
widened only by the rounding bound of XLA's fused multiply-adds
(test_torch_intersect.py), the same shape everywhere and the same prim
wherever the hit t is unique (across tiles, the visit order picks the
winner of a tie).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu.core.ray import Ray as JRay
from eradiate_kernel_tpu.ops import accel as jaccel
from eradiate_kernel_tpu.ops import bvh as jbvh
from eradiate_kernel_tpu.ops import pallas_intersect as jpi
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.ops import accel, bvh, intersect
from eradiate_kernel_tpu_torch.render.geometry import moller_trumbore
from test_torch_intersect import _t_condition, soup


def _payloads(T, seed):
    """Leaf payloads of an instanced scene: shuffled tiles, instances."""
    rng = np.random.default_rng(seed)
    return (rng.permutation(T).astype(np.int32),
            rng.integers(-1, 5, T).astype(np.int32))


def _deep_leaves(T=120):
    """Zero-area leaves along x: every SAH cost is 0, so each split peels
    one leaf off until MAX_DEPTH forces median splits."""
    lo = np.zeros((T, 3), np.float32)
    lo[:, 0] = np.arange(T)
    return lo, lo.copy()


CASES = {
    "soup100": lambda: soup(100, seed=1),
    "soup1500": lambda: soup(1500, seed=1),
}


def _leaf_boxes(name):
    V, F = CASES[name]()
    tiles = accel.pack_tiles(V, None, F, np.zeros(len(F), np.int32))
    return tiles["lo"], tiles["hi"]


@pytest.mark.parametrize("case", ["soup100", "soup1500", "payload", "deep"])
def test_build_bit_equal(case):
    payload = (None, None)
    if case == "deep":
        lo, hi = _deep_leaves()
    else:
        lo, hi = _leaf_boxes("soup1500" if case == "payload" else case)
        if case == "payload":
            payload = _payloads(len(lo), seed=3)
    nbox, nmeta, depth = bvh.build_tile_bvh(lo, hi, *payload)
    rbox, rmeta, rdepth = jbvh.build_tile_bvh(lo, hi, *payload)
    assert depth == rdepth
    for a, b in ((nbox, rbox), (nmeta, rmeta)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if case == "deep":
        assert depth >= bvh.MAX_DEPTH - 2
    cbox, cmeta = bvh.collapse_to_bvh8(nbox, nmeta)
    rcbox, rcmeta = jbvh.collapse_to_bvh8(rbox, rmeta)
    for a, b in ((cbox, rcbox), (cmeta, rcmeta)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _bvh_tiles(V, F):
    tiles = accel.pack_tiles(V, None, F, np.zeros(len(F), np.int32))
    nbox, nmeta, _ = bvh.build_tile_bvh(tiles["lo"], tiles["hi"])
    cbox, cmeta = bvh.collapse_to_bvh8(nbox, nmeta)
    return dict(tiles, nbox=nbox, nmeta=nmeta, cbox=cbox, cmeta=cmeta)


def _rays(n=600, seed=2):
    """tests/test_accel.py:155-167's load: rays aimed into the soup, 32
    axis-aligned, half with a finite maxt."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:32] = (np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
              * rng.choice([-1.0, 1.0], 32)[:, None])
    maxt = np.full(n, np.inf, np.float32)
    maxt[n // 2:] = rng.uniform(0.5, 6.0, n - n // 2)
    return o, d.astype(np.float32), maxt


def _both(tiles, o, d, maxt, wide):
    """(port plain traversal, Pallas kernel in interpret mode) outputs."""
    n = len(o)
    ray = Ray.make(torch.as_tensor(o), torch.as_tensor(d),
                   maxt=torch.as_tensor(maxt))
    fn = intersect.intersect_bvh8 if wide else intersect.intersect_bvh
    out = fn({k: torch.as_tensor(np.array(v)) for k, v in tiles.items()},
             ray, return_stats=True)
    jray = JRay.make(jnp.asarray(o), jnp.asarray(d), maxt=jnp.asarray(maxt),
                     wavelengths=jnp.zeros((n, 0)))
    jfn = jpi.intersect_bvh8 if wide else jpi.intersect_bvh
    ref = jfn({k: jnp.asarray(v) for k, v in tiles.items()}, jray,
              interpret=True)
    return ([a.numpy() for a in out[:4]], out[4].numpy(),
            [np.asarray(a) for a in ref])


def _assert_close_hits(port, ref, cond, tt):
    """Hit-by-hit agreement; cond: t's condition number per ray, tt: the
    brute-force (n, F) t of every triangle (inf where missed)."""
    t, uv, prim, shape = port
    rt, ruv, rprim, rshape = ref
    hit = np.isfinite(rt)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    assert hit.sum() > len(t) // 12
    err = np.abs(t[hit] - rt[hit]) / np.abs(rt[hit])
    bound = 2 * np.finfo(np.float32).eps * cond
    assert (err > 1e-6).sum() <= max(1, hit.sum() // 100)
    np.testing.assert_array_less(err, np.maximum(1e-6, bound[hit]) + 1e-12)
    np.testing.assert_allclose(uv[hit], ruv[hit], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(shape, rshape)
    ties = np.zeros(len(t), np.int64)
    ties[hit] = (np.abs(tt[hit] - t[hit, None])
                 <= 1e-6 * np.abs(t[hit, None])).sum(1)
    unique = ties == 1
    assert unique.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(prim[unique], rprim[unique])


def _brute_t(V, F, o, d):
    tt, _, _, ok = moller_trumbore(
        torch.as_tensor(o)[:, None], torch.as_tensor(d)[:, None],
        *(torch.as_tensor(V[F[:, i]]) for i in range(3)))
    return torch.where(ok, tt, float("inf")).numpy()


@pytest.mark.parametrize("wide", [False, True], ids=["bvh", "bvh8"])
@pytest.mark.parametrize("nfaces", [100, 1500])
def test_plain_traversal_matches_pallas(nfaces, wide):
    """Each plain walk, in groups of BVH_GROUP rays, against the Pallas
    kernel's 256-ray blocks: the results do not depend on the group."""
    V, F = soup(nfaces, seed=1)
    tiles = _bvh_tiles(V, F)
    o, d, maxt = _rays()
    port, stats, ref = _both(tiles, o, d, maxt, wide)
    assert stats.shape == (-(-len(o) // 256) * 256 // intersect.BVH_GROUP, 3)
    _assert_close_hits(port, ref, _t_condition(V, F, ref[2], o, d),
                       _brute_t(V, F, o, d))
    # 100 faces make one tile, a root leaf (no inner node for the binary
    # walk); 1500 faces make 12 tiles
    assert (stats[:, 1] >= 1).all()
    assert (stats[:, 0].sum() >= 1) == (wide or nfaces > 128)
    assert stats[:, 2].max() <= intersect.STACK_SIZE


def _instanced_reference_scene():
    """tests/test_instancing.py's _tri_bump group under three transforms
    plus a top-level mesh, so the reference builds the BVH8 with leaves of
    both kinds."""
    from test_torch_instancing import instanced_scene

    return jload_dict(instanced_scene())


@pytest.mark.parametrize("wide", [False, True], ids=["bvh", "bvh8"])
def test_plain_traversal_matches_pallas_instanced(wide):
    """xf/sbase rows from a reference-built instanced scene: rays hit the
    instances' group tiles in instance space."""
    geo = _instanced_reference_scene().geo
    assert geo.n_instances == 3 and geo.faces.shape[0] > 0
    tiles = {"v0": geo.tiles_v0, "e1": geo.tiles_e1, "e2": geo.tiles_e2,
             "prim": geo.tiles_prim, "shape": geo.tiles_shape,
             "lo": geo.tiles_lo, "hi": geo.tiles_hi, "nbox": geo.bvh_box,
             "nmeta": geo.bvh_meta, "cbox": geo.bvh8_box,
             "cmeta": geo.bvh8_meta, "xf": geo.tiles_xf,
             "sbase": geo.tiles_sbase}
    tiles = {k: np.asarray(v) for k, v in tiles.items()}
    rng = np.random.default_rng(7)
    n = 600
    o = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                  np.full(n, 2.0)], -1).astype(np.float32)
    target = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                       rng.uniform(-0.2, 0.3, n)], -1).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16] = np.float32([0, 0, -1])
    maxt = np.full(n, np.inf, np.float32)
    maxt[n // 2:] = rng.uniform(1.0, 4.0, n - n // 2)
    port, stats, ref = _both(tiles, o, d.astype(np.float32), maxt, wide)
    t, uv, prim, shape = port
    rt, ruv, rprim, rshape = ref
    hit = np.isfinite(rt)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    assert hit.sum() > n // 4
    # affine rows applied in the same order on both sides; XLA may fuse
    # them into multiply-adds
    np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(uv[hit], ruv[hit], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(shape, rshape)
    np.testing.assert_array_equal(prim[hit], rprim[hit])
    # instanced and top-level hits both occur
    fam = np.asarray(geo.shape_family)[shape[hit]]
    assert set(fam) >= {0, 6}


def test_stack_overflow_raises(monkeypatch):
    """A walk deeper than the stack ends and the wrapper raises."""
    V, F = soup(1500, seed=1)
    tiles = {k: torch.as_tensor(v) for k, v in _bvh_tiles(V, F).items()}
    o, d, maxt = _rays(300)
    ray = Ray.make(torch.as_tensor(o), torch.as_tensor(d))
    monkeypatch.setattr(intersect, "STACK_SIZE", 2)
    for fn in (intersect.intersect_bvh, intersect.intersect_bvh8):
        with pytest.raises(RuntimeError, match="overflowed"):
            fn(tiles, ray)


@pytest.mark.parametrize("accel", ["bvh", "bvh8"])
def test_geometry_carries_rows_for_bvh(monkeypatch, accel):
    """Geometry.tiles() of an instanced scene carries the packed rows for
    ERT_ACCEL=bvh|bvh8, bit-equal to tile_rows of the pack_tiles arrays as
    the reference builds them."""
    from eradiate_kernel_tpu_torch.render.geometry import _accel_mode
    from eradiate_kernel_tpu_torch.scene import load_dict
    from test_torch_instancing import instanced_scene

    monkeypatch.setenv("ERT_ACCEL", accel)
    d = instanced_scene()
    geo = load_dict(d, device="cpu").geo
    assert _accel_mode(geo) == accel
    rgeo = _instanced_reference_scene().geo
    rows = geo.tiles()["rows"]
    packed = intersect.tile_rows(*(torch.as_tensor(np.array(a)) for a in (
        rgeo.tiles_v0, rgeo.tiles_e1, rgeo.tiles_e2, rgeo.tiles_prim,
        rgeo.tiles_shape)))
    assert rows.dtype == packed.dtype and rows.is_contiguous()
    assert torch.equal(rows.view(torch.int32), packed.view(torch.int32))
