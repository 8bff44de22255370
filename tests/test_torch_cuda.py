"""Card-only tests of the port's CUDA kernels. They import neither jax nor
the JAX package, so they also run where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Without a CUDA device they skip."""

import numpy as np
import pytest
import torch

from bench_mesh import terrain
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.ops import _build, accel, bvh, gather, intersect
from eradiate_kernel_tpu_torch.textures import volumes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(n, dev):
    """Random rays over the terrain(33) region, 30 % with a finite maxt."""
    rng = np.random.default_rng(n)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(0.3, 1.5, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.where(rng.uniform(size=n) < 0.3,
                    rng.uniform(0.5, 3.0, n), np.inf).astype(np.float32)
    return Ray.make(torch.as_tensor(o, device=dev),
                    torch.as_tensor(d, device=dev),
                    maxt=torch.as_tensor(maxt, device=dev))


def _terrain_tiles(dev):
    V, F = terrain(33)
    tiles = accel.pack_tiles(V, F, np.zeros(len(F), np.int32))
    nbox, nmeta, _ = bvh.build_tile_bvh(tiles["lo"], tiles["hi"])
    cbox, cmeta = bvh.collapse_to_bvh8(nbox, nmeta)
    tiles.update(nbox=nbox, nmeta=nmeta, cbox=cbox, cmeta=cmeta)
    return {k: torch.as_tensor(v, device=dev) for k, v in tiles.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 8 * intersect.RAY_BLOCK + 17])
def test_tile_sweep_matches_plain(cuda_device, n):
    """The CUDA kernel against the plain sweep on the same inputs: bit
    equal (the same float32 expressions, no multiply-add contraction)."""
    ray = _rays(n, cuda_device)
    tdev = _terrain_tiles(cuda_device)
    before = intersect.launches["tile_sweep"]
    out = intersect.intersect_tiles(tdev, ray, return_visited=True)
    torch.cuda.synchronize()
    assert intersect.launches["tile_sweep"] == before + 1
    with intersect.use_plain():
        ref = intersect.intersect_tiles(tdev, ray, return_visited=True)
    assert intersect.launches["tile_sweep"] == before + 1
    assert torch.isfinite(out[0]).any()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def _soup_tiles(F, dev, seed=0):
    """pack_tiles of a random triangle soup in [-1.15, 1.15]^3."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (F, 3))
    V = (c[:, None, :] + rng.uniform(-0.15, 0.15, (F, 3, 3))).reshape(-1, 3)
    tiles = accel.pack_tiles(V.astype(np.float32),
                             np.arange(3 * F, dtype=np.int32).reshape(F, 3),
                             np.arange(F, dtype=np.int32) % 5)
    return {k: torch.as_tensor(v, device=dev) for k, v in tiles.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", [1, 8, intersect.SWEEP_FUSED_MAX_TILES])
def test_fused_sweep_matches_plain(cuda_device, n_tiles):
    """The fused query against its plain version (the eager pre-passes
    without the sort, then the plain sweep) on a ragged ray count: hits and
    per-block visit counts bit equal, one counted launch."""
    tiles = _soup_tiles(128 * n_tiles - 20, cuda_device)
    assert tiles["lo"].shape[0] == n_tiles
    ray = _rays(3 * intersect.RAY_BLOCK + 17, cuda_device)
    args = intersect.prepare_small(tiles, ray)
    before = intersect.launches["tile_sweep"]
    out = intersect.sweep_small(*args)
    torch.cuda.synchronize()
    assert intersect.launches["tile_sweep"] == before + 1
    ref = intersect._sweep_small_plain(*args)
    assert torch.isfinite(out[0]).any() and int(out[4].sum()) > 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    for a, b in zip(intersect.intersect_tiles(tiles, ray,
                                              return_visited=True), out):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_sweep_refuses_past_its_capacity(cuda_device):
    """The fused entry holds SWEEP_FUSED_MAX_TILES = 32 tiles (one warp
    ranks them): its own range check refuses one more, and the wrapper
    raises."""
    n_tiles = intersect.SWEEP_FUSED_MAX_TILES + 1
    tiles = _soup_tiles(128 * n_tiles - 20, cuda_device)
    assert tiles["lo"].shape[0] == n_tiles
    args = intersect.prepare_small(tiles, _rays(300, cuda_device))
    before = intersect.launches["tile_sweep"]
    with pytest.raises(RuntimeError, match=f"fused query on {n_tiles} tiles"):
        intersect.sweep_small(*args)
    assert intersect.launches["tile_sweep"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 8 * intersect.RAY_BLOCK + 17])
def test_sorted_sweep_matches_plain(cuda_device, n):
    """Above SWEEP_FUSED_MAX_TILES tiles (terrain(65): 64 tiles) the sorted
    pipeline's sweep kernel against the plain sweep, bit equal."""
    V, F = terrain(65)
    tiles = {k: torch.as_tensor(v, device=cuda_device) for k, v in
             accel.pack_tiles(V, F, np.zeros(len(F), np.int32)).items()}
    assert tiles["lo"].shape[0] > intersect.SWEEP_FUSED_MAX_TILES
    ray = _rays(n, cuda_device)
    args, _unsort, _n = intersect.prepare_sweep(tiles, ray)
    before = intersect.launches["tile_sweep"]
    out = intersect.sweep(*args)
    torch.cuda.synchronize()
    assert intersect.launches["tile_sweep"] == before + 1
    ref = intersect._sweep_plain(*args)
    assert torch.isfinite(out[0]).any()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3])
def test_grid_trilinear_matches_plain(cuda_device, C):
    """The fused trilinear lookup against the plain chain, bit equal, on a
    (2, 8, 32, 32, C) grid with points around [0, 1]^3 and a NaN point."""
    rng = np.random.default_rng(C)
    grid = torch.as_tensor(rng.random((2, 8, 32, 32, C)).astype(np.float32),
                           device=cuda_device)
    packed = volumes.packed_corners(grid)
    pl = rng.uniform(-0.1, 1.1, (50, 100, 3)).astype(np.float32)
    pl[0, 0, 1] = np.nan
    pl = torch.as_tensor(pl, device=cuda_device)
    slot = torch.as_tensor(rng.integers(0, 2, (50, 100)).astype(np.int32),
                           device=cuda_device)
    before = gather.launches["grid_gather"]
    out = volumes._trilinear_gather(grid, packed, slot, pl)
    torch.cuda.synchronize()
    assert gather.launches["grid_gather"] == before + 1
    ref = volumes.trilinear_gather_plain(packed, grid.shape, slot, pl)
    assert out.shape == (50, 100, C)
    assert bool(torch.isnan(out[0, 0]).all())
    # bit for bit, the NaN lane too (torch.equal says NaN != NaN)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3])
def test_grid_trilinear_bwd_matches_plain(cuda_device, C):
    """The lookup's backward kernel against its plain version on a (2, 8,
    32, 32, C) grid: within rtol 1e-5 and atol 1e-7 (the atomics add in an
    order that changes from run to run), and bit for bit on lanes whose 8
    corners no other lane touches (one lane per other voxel along each
    axis)."""
    rng = np.random.default_rng(10 + C)
    shape = (2, 8, 32, 32, C)
    pl = rng.uniform(-0.1, 1.1, (60, 100, 3)).astype(np.float32)
    pl = torch.as_tensor(pl, device=cuda_device)
    slot = torch.as_tensor(rng.integers(0, 2, (60, 100)).astype(np.int32),
                           device=cuda_device)
    ct = torch.as_tensor(rng.normal(size=(60, 100, C)).astype(np.float32),
                         device=cuda_device)
    before = gather.launches["grid_trilinear_bwd"]
    out = gather.grid_trilinear_bwd(ct, shape, slot, pl)
    torch.cuda.synchronize()
    assert gather.launches["grid_trilinear_bwd"] == before + 1
    ref = volumes.trilinear_backward_plain(ct, shape, slot, pl)
    assert out.shape == shape and bool(out.abs().sum() > 0)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-7)
    # distinct corners: voxel centres (2i, 2j, 2k) + a fraction
    z, y, x = torch.meshgrid(*(torch.arange(0, n - 1, 2, device=cuda_device)
                               for n in shape[1:4]), indexing="ij")
    frac = torch.as_tensor(rng.uniform(0.1, 0.9, (z.numel(), 3)),
                           dtype=torch.float32, device=cuda_device)
    idx = torch.stack([x.flatten(), y.flatten(), z.flatten()], -1)
    n_axis = torch.tensor(shape[1:4][::-1], device=cuda_device)
    pl_d = (idx + frac) / (n_axis - 1)
    slot_d = torch.ones(z.numel(), dtype=torch.int32, device=cuda_device)
    ct_d = torch.as_tensor(rng.normal(size=(z.numel(), C)),
                           dtype=torch.float32, device=cuda_device)
    assert torch.equal(gather.grid_trilinear_bwd(ct_d, shape, slot_d, pl_d),
                       volumes.trilinear_backward_plain(ct_d, shape, slot_d,
                                                        pl_d))


@pytest.mark.cuda
def test_lookup_refuses_positions_that_require_grad(cuda_device):
    """The CUDA lookup gives the positions no gradient, so it refuses
    positions that require one (never a silent zero)."""
    grid = torch.rand(1, 17, 17, 17, 1, device=cuda_device,
                      requires_grad=True)
    packed = volumes.packed_corners(grid.detach())
    slot = torch.zeros(10, dtype=torch.int32, device=cuda_device)
    pl = torch.rand(10, 3, device=cuda_device, requires_grad=True)
    with pytest.raises(ValueError, match="trajectory-class"):
        volumes._trilinear_gather(grid, packed, slot, pl)
    out = volumes._trilinear_gather(grid, packed, slot, pl.detach())
    assert out.requires_grad


@pytest.mark.cuda
def test_value_grad_matches_plain_versions(cuda_device):
    """A 16x16, 4 spp value+grad of an atmosphere with a 17 x 16 x 16 grid
    (the packed path) through the kernels and through the plain versions
    of the gather and the sweep: the same film bit for bit, and gradients
    within the backward kernel's tolerance (rtol 1e-5, atol 1e-7: the
    order of its atomic sums)."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.films import develop
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils import autodiff
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    d = atmosphere(16, 16, 4, 12, grid_res=(17, 16, 16))
    scene = load_dict(d)
    keys = ["volumes.gridvolume.grid", "volumes.constvolume.value"]
    pm = autodiff.traverse(scene).keep(keys)

    def value_grad():
        params = pm.trainable()
        film = integrators.render(pm.with_trainable(params), seed=3,
                                  samples_per_pass=256, regen=True,
                                  develop_film=False)
        develop(film).mean().backward()
        return film.detach(), [params[k].grad for k in keys]

    before = dict(gather.launches)
    film, grads = value_grad()
    torch.cuda.synchronize()
    assert gather.launches["grid_trilinear_bwd"] > before[
        "grid_trilinear_bwd"]
    with gather.use_plain(), intersect.use_plain():
        film_p, grads_p = value_grad()
    assert torch.equal(film, film_p)
    for g, gp in zip(grads, grads_p):
        assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
        torch.testing.assert_close(g, gp, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_raw_stream_is_the_current_stream(cuda_device):
    """The wrappers' raw stream handle is torch.cuda.current_stream()'s,
    on the default stream and inside a side stream."""
    index = torch.cuda.current_device()
    cur = lambda: torch.cuda.current_stream(index).cuda_stream
    assert _build.stream(index) == cur()
    side = torch.cuda.Stream(index)
    with torch.cuda.stream(side):
        assert _build.stream(index) == cur() == side.cuda_stream
    assert _build.stream(index) != side.cuda_stream


WIDE = pytest.mark.parametrize("wide", [False, True],
                               ids=["tile_bvh", "tile_bvh8"])


def _kernel_vs_plain(tiles, ray, wide):
    """One BVH kernel launch against its plain walk on the same arguments:
    hits, stats and the overflow mark bit equal. Returns the kernel's
    outputs."""
    name = "tile_bvh8" if wide else "tile_bvh"
    args, _unsort, _n = intersect.prepare_bvh(tiles, ray, wide=wide)
    before = intersect.launches[name]
    out = intersect._traverse_cuda(name, *args)
    torch.cuda.synchronize()
    assert intersect.launches[name] == before + 1
    ref = intersect._PLAIN_WALKS[name](*args)
    assert out[4].shape == (args[0].shape[0] // intersect.BVH_GROUP, 3)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    return out


@pytest.mark.cuda
@WIDE
@pytest.mark.parametrize("n", [17, 8 * intersect.RAY_BLOCK + 17])
def test_tile_bvh_matches_plain(cuda_device, n, wide):
    """Each BVH kernel against its plain traversal: hits and per-group
    visit counts and stack depths bit equal; through intersect_bvh too,
    which launches the kernel once (and not under use_plain)."""
    ray = _rays(n, cuda_device)
    tdev = _terrain_tiles(cuda_device)
    out = _kernel_vs_plain(tdev, ray, wide)
    assert torch.isfinite(out[0]).any() and int(out[4][:, 0].sum()) > 0
    name = "tile_bvh8" if wide else "tile_bvh"
    fn = intersect.intersect_bvh8 if wide else intersect.intersect_bvh
    before = intersect.launches[name]
    full = fn(tdev, ray, return_stats=True)
    torch.cuda.synchronize()
    assert intersect.launches[name] == before + 1
    with intersect.use_plain():
        ref = fn(tdev, ray, return_stats=True)
    assert intersect.launches[name] == before + 1
    for a, b in zip(full, ref):
        assert torch.equal(a, b)


def _bvh_soup_tiles(dev):
    """A 1,500-triangle soup (12 tiles) with both BVHs."""
    tiles = {k: v.cpu().numpy() for k, v in _soup_tiles(1500, dev).items()}
    nbox, nmeta, _ = bvh.build_tile_bvh(tiles["lo"], tiles["hi"])
    cbox, cmeta = bvh.collapse_to_bvh8(nbox, nmeta)
    tiles.update(nbox=nbox, nmeta=nmeta, cbox=cbox, cmeta=cmeta)
    return {k: torch.as_tensor(v, device=dev) for k, v in tiles.items()}


def _forest_tiles(dev):
    """chip_smoke.py's instanced forest, 16 instances of the crown, as its
    scene's Geometry carries it (instance rows, shape bases, packed rows),
    and the centres of the instances' world boxes."""
    from chip_smoke import forest_scene
    from eradiate_kernel_tpu_torch.scene import load_dict

    geo = load_dict(forest_scene(8, 8, 1, 2, n_inst=16), device=dev).geo
    assert geo.n_instances == 16
    return geo.tiles(), ((geo.inst_lo + geo.inst_hi) / 2).cpu().numpy()


@pytest.mark.cuda
@WIDE
@pytest.mark.parametrize("scene", ["soup", "forest"])
def test_tile_bvh_matches_plain_scenes(cuda_device, scene, wide):
    """Each BVH kernel against its plain walk on a triangle soup and on an
    instanced scene (leaves under instance transforms)."""
    if scene == "soup":
        tiles, ray = _bvh_soup_tiles(cuda_device), _rays(3000, cuda_device)
    else:
        tiles, centres = _forest_tiles(cuda_device)
        # from above and around a crown, at a point near its centre
        rng = np.random.default_rng(9)
        target = (centres[rng.integers(0, len(centres), 3000)]
                  + rng.uniform(-0.3, 0.3, (3000, 3)))
        o = target + rng.uniform([-2, -2, 1], [2, 2, 3], (3000, 3))
        d = target - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = o.astype(np.float32), d.astype(np.float32)
        ray = Ray.make(torch.as_tensor(o, device=cuda_device),
                       torch.as_tensor(d, device=cuda_device))
    out = _kernel_vs_plain(tiles, ray, wide)
    assert torch.isfinite(out[0]).float().mean() > 0.05


def _deep_tree(wide, dev, depth=80):
    """A hand-made tree whose walk pushes past the 64-entry stack: every
    node's children share one box around the rays, so every child is
    entered at the same distance; the chain's next node pops first (left
    on the binary tie, the lowest slot in the 8-wide order) and the other
    children, leaves of one tile, stay on the stack."""
    box = torch.tensor([-2, -2, -2, 2, 2, 2, 0, 0], dtype=torch.float32)
    if not wide:
        # node 2i: chain node, children 2i+2 (chain) and 2i+1 (leaf)
        n = 2 * depth + 1
        meta = torch.full((n, 4), -1, dtype=torch.int32)
        for i in range(depth):
            meta[2 * i] = torch.tensor([2 * i + 2, 2 * i + 1, -1, -1])
            meta[2 * i + 1, 2] = 0
        meta[2 * depth, 2] = 0
        tree = (box.repeat(n, 1, 1), meta)
    else:
        # node i: slot 0 the chain's next node, slots 1-7 leaves of tile 0
        meta = torch.full((depth, 8, 4), -1, dtype=torch.int32)
        meta[..., 1] = 0
        meta[..., 3] = 0
        meta[:-1, 0, 0] = torch.arange(1, depth, dtype=torch.int32)
        meta[:-1, 0, 1] = -1
        tree = (box.repeat(depth, 8, 1), meta)
    return tuple(a.to(dev) for a in tree)


@pytest.mark.cuda
@WIDE
def test_tile_bvh_overflow_mark(cuda_device, wide):
    """A walk deeper than the kernel's 64-entry stack: each kernel marks the
    overflow (deepest stack 65) in every group, bit-equal to its plain walk
    up to that point, and the query raises."""
    name = "tile_bvh8" if wide else "tile_bvh"
    tiles = _soup_tiles(100, cuda_device)
    box, meta = _deep_tree(wide, cuda_device)
    ray = _rays(2 * intersect.RAY_BLOCK, cuda_device)
    rays = intersect._pad_blocks(intersect._ray_rows(ray))
    xf, sbase = intersect._identity_xf(cuda_device)
    args = (rays, box, meta, xf, sbase, intersect.packed_rows(tiles))
    out = intersect._traverse_cuda(name, *args)
    torch.cuda.synchronize()
    ref = intersect._PLAIN_WALKS[name](*args)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert (out[4][:, 2] == intersect.STACK_SIZE + 1).all()
    with pytest.raises(RuntimeError, match="overflowed"):
        intersect.traverse(name, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 1, 1024, torch.int32),
                                   (8 * 17 * 16 * 16, 8, 5000, torch.int64),
                                   (100, 3, 77, torch.int32)])
def test_grid_gather_matches_plain(cuda_device, shape):
    """The row-gather kernel against the plain gather, bit equal, with
    indices past both ends (clamped): the probe's shape, packed-corner
    rows, and rows that are not a multiple of 16 bytes."""
    V, R, L, dtype = shape
    rng = np.random.default_rng(V)
    table = torch.as_tensor(rng.random((V, R)).astype(np.float32),
                            device=cuda_device)
    idx = torch.as_tensor(rng.integers(-3, V + 3, L), dtype=dtype,
                          device=cuda_device)
    before = gather.launches["grid_gather"]
    out = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather.launches["grid_gather"] == before + 1
    assert torch.equal(out, gather.gather_rows_plain(table, idx))
