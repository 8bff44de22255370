"""The port's volume lookups (textures/volumes.py) against the reference on
the same seeded inputs: the packed corner table bit for bit, gridvolume
lookups on the gather path (a (17, 16, 16) grid, > 4,096 voxels) and on
the einsum path (the flagship's 64 x 4 x 4 grid), and the wrap modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.textures import volumes as jvol
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.textures import volumes
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere


def test_packed_corners_bit_equal():
    rng = np.random.default_rng(0)
    grid = rng.random((2, 5, 6, 7, 3)).astype(np.float32)
    ref = np.asarray(jvol._packed_corners(jnp.asarray(grid)))
    out = volumes.packed_corners(torch.as_tensor(grid)).numpy()
    assert out.shape == (2 * 5 * 6 * 7, 24)
    np.testing.assert_array_equal(out, ref)


def _points(n, seed):
    """World points over the atmosphere's grid box and a margin around it
    (outside lookups are zero)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform([-22, -22, -0.2], [23, 23, 1.2], (n, 3))
    return p.astype(np.float32)


@pytest.mark.parametrize("grid_res, rtol, atol", [
    # gather path: the same corner rows and the same lerp expression
    ((17, 16, 16), 1e-6, 1e-7),
    # einsum path: the port contracts one axis at a time, XLA in its own
    # order, so sums of the same products round differently
    (64, 1e-5, 1e-7),
], ids=["gather", "einsum"])
def test_volume_eval_matches_reference(grid_res, rtol, atol):
    d = atmosphere(8, 8, 1, 4, grid_res=grid_res)
    ref_scene = jload_dict(d)
    scene = load_dict(d, device="cpu")
    is_gather = isinstance(grid_res, tuple)
    assert (scene.vol_packed is not None) == is_gather
    n = 2000
    p = _points(n, 1)
    # lanes alternate between the sigma_t grid (0) and the albedo
    # constvolume (1), as the medium's lookups do
    vidx = (np.arange(n) % 2).astype(np.int32)
    ref = np.asarray(jvol.volume_eval(ref_scene, jnp.asarray(vidx),
                                      jnp.asarray(p), jnp.zeros((n, 3))))
    out = volumes.volume_eval(scene, torch.as_tensor(vidx),
                              torch.as_tensor(p)).numpy()
    assert np.count_nonzero(ref[::2]) > n // 4  # many lookups inside
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


def test_apply_wrap_matches_reference():
    rng = np.random.default_rng(2)
    n = 3000
    wrap = np.asarray([0, 1, 2], np.int32)
    vslot = rng.integers(0, 3, n).astype(np.int32)
    pl = rng.uniform(-1.5, 2.5, (n, 3)).astype(np.float32)
    ref_pl, ref_in = jvol._apply_wrap({"wrap": jnp.asarray(wrap)},
                                      jnp.asarray(vslot), jnp.asarray(pl))
    out_pl, out_in = volumes._apply_wrap({"wrap": torch.as_tensor(wrap)},
                                         torch.as_tensor(vslot),
                                         torch.as_tensor(pl))
    np.testing.assert_allclose(out_pl.numpy(), np.asarray(ref_pl),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(out_in.numpy(), np.asarray(ref_in))
    assert out_in.numpy().any() and not out_in.numpy().all()


def _grid_lookups(C, n=3000, seed=5):
    """A random (2, 8, 32, 32, C) grid (8,192 voxels a slot: the gather
    path), local points inside and around [0, 1]^3, random slots."""
    rng = np.random.default_rng(seed)
    grid = rng.random((2, 8, 32, 32, C)).astype(np.float32)
    pl = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    vslot = rng.integers(0, 2, n).astype(np.int32)
    return grid, vslot, pl


@pytest.mark.parametrize("C", [1, 3])
def test_trilinear_gather_plain_matches_reference(C):
    """The plain packed-row lookup (the fused kernel's plain version)
    against the reference's _trilinear_gather, at the gather path's
    tolerance of test_volume_eval_matches_reference."""
    grid, vslot, pl = _grid_lookups(C)
    ref = np.asarray(jvol._trilinear_gather(
        jnp.asarray(grid), jnp.asarray(vslot), jnp.asarray(pl)))
    tgrid = torch.as_tensor(grid)
    out = volumes.trilinear_gather_plain(
        volumes.packed_corners(tgrid), tgrid.shape, torch.as_tensor(vslot),
        torch.as_tensor(pl)).numpy()
    assert out.shape == (len(pl), C)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_corner0_matches_reference_corner_setup():
    """The packed path computes only corner c000's index: equal to the
    reference's first of eight, and the same fractional weights."""
    grid, vslot, pl = _grid_lookups(1, seed=6)
    S, D, H, W, _ = grid.shape
    ref_idx, *ref_f = jvol._corner_setup((S, D, H, W), jnp.asarray(vslot),
                                         jnp.asarray(pl))
    idx, *f = volumes._corner0((S, D, H, W), torch.as_tensor(vslot),
                               torch.as_tensor(pl))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx[0]))
    for a, b in zip(f, ref_f):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _large_lookups(C, n=1024, seed=7):
    """A (2, 17, 17, 17, C) grid (4,913 voxels a slot: the packed path),
    1,024 local points inside and around [0, 1]^3, random slots and a
    random cotangent."""
    rng = np.random.default_rng(seed)
    grid = rng.random((2, 17, 17, 17, C)).astype(np.float32)
    pl = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    vslot = rng.integers(0, 2, n).astype(np.int32)
    return grid, vslot, pl, rng.normal(size=(n, C)).astype(np.float32)


def _crowded_lookups(C, seed=8):
    """Lanes that crowd a few voxels and the faces of a (2, 17, 17, 17, C)
    grid: runs of 32 lanes in one voxel (the backward kernel's warp
    aggregation), 256 lanes on one point, and lanes on the faces of [0,
    1]^3 or outside them; a random cotangent."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 16, (9, 3))
    cell = np.concatenate([np.repeat(cells[:8], 32, 0),
                           np.repeat(cells[8:], 256, 0)])
    frac = rng.uniform(0.05, 0.95, cell.shape)
    frac[-256:] = frac[-256]
    pl = np.concatenate([(cell + frac) / 16,
                         rng.choice([-0.2, 0.0, 1.0, 1.2], (512, 3))])
    vslot = rng.integers(0, 2, len(pl))
    vslot[:512] = np.repeat(vslot[:512:32], 32)
    grid = rng.random((2, 17, 17, 17, C)).astype(np.float32)
    return (grid, vslot.astype(np.int32), pl.astype(np.float32),
            rng.normal(size=(len(pl), C)).astype(np.float32))


@jax.jit
def _reference_vjp(grid, vslot, pl, ct):
    """jax.vjp of the reference's _trilinear_gather with respect to the
    grid, applied to ct (jitted: one compile a shape, ~5x faster here than
    the eager vjp, and the same bits on these loads)."""
    _out, vjp = jax.vjp(lambda g: jvol._trilinear_gather(g, vslot, pl), grid)
    return vjp(ct)[0]


@pytest.mark.parametrize("lanes", ["random", "crowded"])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
def test_trilinear_backward_plain_matches_reference_vjp(C, lanes):
    """The plain backward (the backward kernel's plain version) equals
    jax.vjp of the reference's _trilinear_gather with respect to the grid,
    at rtol 1e-5 and atol 1e-7: the same products, summed in another
    order; on random lanes and on lanes crowding a few voxels and the
    grid's faces, at the widths whose chunks the kernel lays out apart
    (scalar 1 and 3, float2 2, float4 4 and 8)."""
    grid, vslot, pl, ct = (_large_lookups(C) if lanes == "random"
                           else _crowded_lookups(C))
    ref = _reference_vjp(*(jnp.asarray(a) for a in (grid, vslot, pl, ct)))
    out = volumes.trilinear_backward_plain(
        torch.as_tensor(ct), grid.shape, torch.as_tensor(vslot),
        torch.as_tensor(pl))
    assert out.shape == grid.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


def test_packed_lookup_grid_gradient_matches_reference():
    """A gridvolume lookup of the packed path differentiates the grid: the
    gradient of volume_eval with respect to the scene's grid equals the
    reference's (its _trilinear_gather builds the packed table from the
    grid inside the lookup)."""
    d = atmosphere(8, 8, 1, 4, grid_res=(17, 16, 16))
    ref_scene = jload_dict(d)
    scene = load_dict(d, device="cpu")
    n = 1000
    p = _points(n, 3)
    vidx = np.zeros(n, np.int32)
    rng = np.random.default_rng(3)
    ct = rng.normal(size=(n, 3)).astype(np.float32)

    def ref_eval(grid):
        vols = dict(ref_scene.volumes)
        vols["gridvolume"] = dict(vols["gridvolume"], grid=grid)
        sc = ref_scene.replace(volumes=vols)
        return jvol.volume_eval(sc, jnp.asarray(vidx), jnp.asarray(p),
                                jnp.zeros((n, 3)))

    _o, vjp = jax.vjp(ref_eval, ref_scene.volumes["gridvolume"]["grid"])
    (ref,) = vjp(jnp.asarray(ct))
    grid = scene.volumes["gridvolume"]["grid"].clone().requires_grad_()
    sc = scene.with_tensors({"volumes.gridvolume.grid": grid})
    out = volumes.volume_eval(sc, torch.as_tensor(vidx), torch.as_tensor(p))
    (g,) = torch.autograd.grad(out, grid, torch.as_tensor(ct))
    assert np.abs(np.asarray(ref)).sum() > 0
    np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("C", [1, 3, 8])
def test_packed_lookup_positions_gradient_matches_reference_vjp(C):
    """The packed lookup differentiates its positions and its grid at
    once (GridTrilinear: trilinear_positions_backward and
    trilinear_backward_plain): jax.vjp of the reference's
    _trilinear_gather with respect to both, the positions within rtol
    1e-5, atol 1e-5 of the largest |gradient| (the derivative subtracts
    corner values), the grid within rtol 1e-5, atol 1e-7."""
    grid, vslot, pl, ct = _large_lookups(C, seed=9)
    _o, vjp = jax.vjp(lambda g, q: jvol._trilinear_gather(
        g, jnp.asarray(vslot), q), jnp.asarray(grid), jnp.asarray(pl))
    ref_grid, ref_pl = (np.asarray(a) for a in vjp(jnp.asarray(ct)))
    tgrid = torch.as_tensor(grid).requires_grad_()
    tpl = torch.as_tensor(pl).requires_grad_()
    out = volumes._trilinear_gather(tgrid, volumes.packed_corners(
        tgrid.detach()), torch.as_tensor(vslot), tpl)
    d_grid, d_pl = torch.autograd.grad(out, (tgrid, tpl),
                                       torch.as_tensor(ct))
    assert np.abs(ref_pl).max() > 0
    np.testing.assert_allclose(d_pl.numpy(), ref_pl, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_pl).max())
    np.testing.assert_allclose(d_grid.numpy(), ref_grid, rtol=1e-5,
                               atol=1e-7)


def test_volume_eval_gradient_gather_path_matches_reference():
    """volume_eval_gradient over the (17, 16, 16) grid (> 4,096 voxels:
    the packed lookup, GridTrilinear's positions gradient) and its albedo
    constvolume (a zero gradient) against the reference's, within rtol
    1e-5, atol 1e-5 of the largest |gradient|."""
    d = atmosphere(8, 8, 1, 4, grid_res=(17, 16, 16))
    ref_scene = jload_dict(d)
    scene = load_dict(d, device="cpu")
    assert scene.vol_packed is not None
    n = 1000
    p = _points(n, 4)
    vidx = (np.arange(n) % 2).astype(np.int32)
    want = np.asarray(jvol.volume_eval_gradient(
        ref_scene, jnp.asarray(vidx), jnp.asarray(p), jnp.zeros((n, 3))))
    got = volumes.volume_eval_gradient(scene, torch.as_tensor(vidx),
                                       torch.as_tensor(p)).numpy()
    assert got.shape == want.shape and np.abs(want[::2]).max() > 0
    np.testing.assert_array_equal(got[1::2], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
