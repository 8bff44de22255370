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
    tiles = accel.pack_tiles(V, None, F, np.zeros(len(F), np.int32))
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
    tiles = accel.pack_tiles(V.astype(np.float32), None,
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
             accel.pack_tiles(V, None, F, np.zeros(len(F), np.int32)).items()}
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


# the backward entry's channel widths: scalar (1, 3), float2 (2) and
# float4 (4, 8) chunks of its float32 entry
BWD_WIDTHS = [1, 2, 3, 4, 8]


@pytest.mark.cuda
@pytest.mark.parametrize("C", BWD_WIDTHS)
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


def _bwd_lanes(kind, shape, rng):
    """(pl, slot) numpy lanes of one of the backward entry's hard loads on
    a grid of ``shape`` (S, D, H, W, C):

    contention: runs of 32 lanes (a warp at C = 1) on one row each, runs
      of 16 (half-warps) on one row each, runs of 32 whose lanes alternate
      between two rows, and 512 lanes on one point;
    faces: every lane on a face of [0, 1]^3 or outside it along some axis
      (pl in {-0.3, 0, 1, 1.3} there), the rest of it random;
    slots: random points in two slots, with some lanes' slot out of range
      (-1, S) or so large that slot * D*H*W wraps in int32: their rows
      are clamped or wrapped, so the kernel splits them."""
    S, D, H, W, _C = shape
    n_axis = np.array([W, H, D])
    if kind == "contention":
        cells = rng.integers(0, n_axis - 1, (49, 3))
        pairs = np.repeat(cells[32:48], 16, 0).reshape(8, 2, 16, 3)
        cell = np.concatenate([
            np.repeat(cells[:16], 32, 0),      # a warp's 32 lanes on a row
            np.repeat(cells[16:32], 16, 0),    # half-warps on two rows
            pairs.transpose(0, 2, 1, 3).reshape(-1, 3),  # rows alternating
            np.repeat(cells[48:], 512, 0)])    # 512 lanes on one voxel
        frac = rng.uniform(0.05, 0.95, cell.shape)
        frac[-512:] = frac[-512]  # one point: one voxel's 8 corners
        pl = (cell + frac) / (n_axis - 1)
        slot = np.repeat(rng.integers(0, S, len(pl) // 32), 32)
    elif kind == "faces":
        n = 4096
        pl = rng.uniform(0, 1, (n, 3))
        axis = rng.integers(0, 3, n)
        pl[np.arange(n), axis] = rng.choice([-0.3, 0.0, 1.0, 1.3], n)
        corner = rng.uniform(size=n) < 0.25   # some on an edge or corner
        pl[corner] = rng.choice([-0.3, 0.0, 1.0, 1.3], (corner.sum(), 3))
        slot = rng.integers(0, S, n)
    else:
        n = 4096
        pl = rng.uniform(-0.1, 1.1, (n, 3))
        slot = rng.integers(0, 2, n)
        odd = rng.uniform(size=n) < 0.1
        wrap = (1 << 32) // (D * H * W)
        slot[odd] = rng.choice([-1, S, wrap, wrap + 1], odd.sum())
    return pl, slot.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["contention", "faces", "slots"])
@pytest.mark.parametrize("C", BWD_WIDTHS)
def test_grid_trilinear_bwd_hard_lanes(cuda_device, C, kind, dtype):
    """The backward entry against its plain version on the loads of
    _bwd_lanes (warps and half-warps on one row and 512 lanes on one
    voxel: the warp aggregation; faces and points outside [0, 1]: the
    clamped corners; wrapped and clamped rows: the split of the row) on a
    (2, 8, 32, 32, C) grid, at rtol 1e-5 and atol 1e-7 in float32 and
    1e-12 and 1e-15 in float64 (the atomics' order), with cotangents in
    [0.5, 1.5] so that the crowded sums do not cancel."""
    rng = np.random.default_rng(30 + C)
    shape = (2, 8, 32, 32, C)
    pl, slot = _bwd_lanes(kind, shape, rng)
    ct = rng.uniform(0.5, 1.5, (len(pl), C))
    pl, ct = (torch.as_tensor(a, dtype=dtype, device=cuda_device)
              for a in (pl, ct))
    slot = torch.as_tensor(slot, device=cuda_device)
    name = "grid_trilinear_bwd" + ("_f64" if dtype == torch.float64 else "")
    before = gather.launches[name]
    out = gather.grid_trilinear_bwd(ct, shape, slot, pl)
    torch.cuda.synchronize()
    assert gather.launches[name] == before + 1
    ref = volumes.trilinear_backward_plain(ct, shape, slot, pl)
    assert out.dtype == dtype and bool(out.abs().sum() > 0)
    tol = ((1e-5, 1e-7) if dtype == torch.float32 else (1e-12, 1e-15))
    torch.testing.assert_close(out, ref, rtol=tol[0], atol=tol[1])


@pytest.mark.cuda
def test_lookup_refuses_positions_that_require_grad(cuda_device):
    """The CUDA lookup refuses no positions that require a gradient: it
    gives them the plain chain's gradient bit for bit (the kernel's gather
    entry reads the 8-corner rows again, the same _lerp8 derivative), the
    grid its own within the backward kernel's tolerance (rtol 1e-5, atol
    1e-7: the order of its atomic sums), and never a silent zero."""
    rng = np.random.default_rng(11)
    grid = torch.as_tensor(rng.random((1, 17, 17, 17, 2)).astype(np.float32),
                           device=cuda_device).requires_grad_()
    packed = volumes.packed_corners(grid.detach())
    slot = torch.zeros(1000, dtype=torch.int32, device=cuda_device)
    pl = torch.as_tensor(rng.uniform(-0.1, 1.1, (1000, 3)).astype(np.float32),
                         device=cuda_device).requires_grad_()
    ct = torch.as_tensor(rng.normal(size=(1000, 2)).astype(np.float32),
                         device=cuda_device)
    before = dict(gather.launches)
    out = volumes._trilinear_gather(grid, packed, slot, pl)
    d_grid, d_pl = torch.autograd.grad(out, (grid, pl), ct)
    torch.cuda.synchronize()
    assert gather.launches["grid_gather"] == before["grid_gather"] + 2
    assert (gather.launches["grid_trilinear_bwd"]
            == before["grid_trilinear_bwd"] + 1)
    with gather.use_plain():
        ref = volumes._trilinear_gather(grid, packed, slot, pl)
        ref_grid, ref_pl = torch.autograd.grad(ref, (grid, pl), ct)
    assert gather.launches["grid_gather"] == before["grid_gather"] + 2
    assert bool(d_pl.abs().sum() > 0)
    assert torch.equal(d_pl, ref_pl)
    torch.testing.assert_close(d_grid, ref_grid, rtol=1e-5, atol=1e-7)


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


def _f64(tiles):
    """A tile set in float64, as a double variant's scene carries it
    (chip_smoke.widened: ids in the packed rows as exact doubles)."""
    from chip_smoke import widened

    return widened(tiles)


def _rays64(n, dev):
    ray = _rays(n, dev)
    return Ray.make(ray.o.double(), ray.d.double(), maxt=ray.maxt.double())


def _f64_load(kind, dev):
    """(tiles, rays) of a float64 load: terrain(33), a 1,500-triangle soup
    or chip_smoke.py's forest of 16 instances loaded in rgb_double."""
    if kind == "terrain":
        return _f64(_terrain_tiles(dev)), _rays64(8 * intersect.RAY_BLOCK
                                                  + 17, dev)
    if kind == "soup":
        return _f64(_bvh_soup_tiles(dev)), _rays64(3000, dev)
    from chip_smoke import forest_scene
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.scene import load_dict

    geo = load_dict(forest_scene(8, 8, 1, 2, n_inst=16), Variant("rgb_double"),
                    device=dev).geo
    centres = ((geo.inst_lo + geo.inst_hi) / 2).cpu().numpy()
    rng = np.random.default_rng(9)
    target = (centres[rng.integers(0, len(centres), 3000)]
              + rng.uniform(-0.3, 0.3, (3000, 3)))
    o = target + rng.uniform([-2, -2, 1], [2, 2, 3], (3000, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return geo.tiles(), Ray.make(torch.as_tensor(o, device=dev),
                                 torch.as_tensor(d, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("entry,load", [
    ("sweep", "terrain"), ("sweep", "soup"), ("fused", "soup"),
    ("tile_bvh", "terrain"), ("tile_bvh", "soup"), ("tile_bvh", "forest"),
    ("tile_bvh8", "terrain"), ("tile_bvh8", "soup"),
    ("tile_bvh8", "forest")])
def test_f64_mesh_entries_match_plain(cuda_device, entry, load):
    """The float64 entries of tile_sweep (the sorted sweep and the fused
    query), tile_bvh and tile_bvh8 against their plain versions run on the
    same float64 tensors: hits, visits and stats bit equal, one launch of
    the _f64 entry and none of the float32 one."""
    tiles, ray = _f64_load(load, cuda_device)
    assert tiles["rows"].dtype == ray.o.dtype == torch.float64
    if entry == "fused":
        args = intersect.prepare_small(tiles, ray)
        run, plain, name = (intersect._sweep_small_cuda,
                            intersect._sweep_small_plain, "tile_sweep")
    elif entry == "sweep":
        args, _unsort, _n = intersect.prepare_sweep(tiles, ray)
        run, plain, name = (intersect._sweep_cuda, intersect._sweep_plain,
                            "tile_sweep")
    else:
        args, _unsort, _n = intersect.prepare_bvh(
            tiles, ray, wide=entry == "tile_bvh8")
        run = lambda *a: intersect._traverse_cuda(entry, *a)
        plain, name = intersect._PLAIN_WALKS[entry], entry
    before = dict(intersect.launches)
    out = run(*args)
    torch.cuda.synchronize()
    assert intersect.launches[name + "_f64"] == before[name + "_f64"] + 1
    assert intersect.launches[name] == before[name]
    ref = plain(*args)
    assert out[0].dtype == torch.float64
    assert torch.isfinite(out[0]).float().mean() > 0.05
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@WIDE
def test_f64_tile_bvh_overflow_mark(cuda_device, wide):
    """test_tile_bvh_overflow_mark's chain tree in float64: each _f64 entry
    marks the overflow in every group, bit-equal to its plain walk, and
    the query raises."""
    name = "tile_bvh8" if wide else "tile_bvh"
    tiles = _f64(_soup_tiles(100, cuda_device))
    box, meta = _deep_tree(wide, cuda_device)
    ray = _rays64(2 * intersect.RAY_BLOCK, cuda_device)
    rays = intersect._pad_blocks(intersect._ray_rows(ray, torch.float64))
    xf, sbase = intersect._identity_xf(cuda_device, torch.float64)
    args = (rays, box.double(), meta, xf, sbase, tiles["rows"])
    out = intersect._traverse_cuda(name, *args)
    torch.cuda.synchronize()
    ref = intersect._PLAIN_WALKS[name](*args)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert (out[4][:, 2] == intersect.STACK_SIZE + 1).all()
    with pytest.raises(RuntimeError, match="overflowed"):
        intersect.traverse(name, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("C", BWD_WIDTHS)
def test_f64_grid_entries_match_plain(cuda_device, C):
    """grid_gather's float64 entries on a 64^3 table of C channels: the
    gather (packed-corner rows, clamped indices) and the fused trilinear
    lookup bit-equal to their plain versions, the backward within rtol
    1e-12 and atol 1e-15 (the atomics' order) and bit-equal on lanes with
    distinct corners; each a launch of its _f64 entry."""
    rng = np.random.default_rng(20 + C)
    shape = (1, 64, 64, 64, C)
    grid = torch.as_tensor(rng.random(shape), device=cuda_device)
    packed = volumes.packed_corners(grid)
    L = 32768
    pl = torch.as_tensor(rng.uniform(-0.05, 1.05, (L, 3)), device=cuda_device)
    slot = torch.zeros(L, dtype=torch.int32, device=cuda_device)
    idx = torch.as_tensor(rng.integers(-3, packed.shape[0] + 3, L),
                          device=cuda_device)
    ct = torch.as_tensor(rng.normal(size=(L, C)), device=cuda_device)
    before = dict(gather.launches)
    rows = gather.gather_rows(packed, idx)
    look = gather.grid_trilinear(packed, shape, slot, pl)
    bwd = gather.grid_trilinear_bwd(ct, shape, slot, pl)
    torch.cuda.synchronize()
    assert gather.launches["grid_gather_f64"] == before["grid_gather_f64"] + 2
    assert (gather.launches["grid_trilinear_bwd_f64"]
            == before["grid_trilinear_bwd_f64"] + 1)
    assert gather.launches["grid_gather"] == before["grid_gather"]
    assert rows.dtype == look.dtype == bwd.dtype == torch.float64
    assert torch.equal(rows, gather.gather_rows_plain(packed, idx))
    assert torch.equal(look, volumes.trilinear_gather_plain(
        packed, shape, slot, pl))
    torch.testing.assert_close(bwd, volumes.trilinear_backward_plain(
        ct, shape, slot, pl), rtol=1e-12, atol=1e-15)
    ar = torch.arange(0, 63, 2, device=cuda_device)
    z, y, x = torch.meshgrid(ar, ar, ar, indexing="ij")
    pl_d = (torch.stack([x.flatten(), y.flatten(), z.flatten()], -1)
            + torch.as_tensor(rng.uniform(0.1, 0.9, (ar.numel() ** 3, 3)),
                              device=cuda_device)) / 63
    ct_d = torch.as_tensor(rng.normal(size=(pl_d.shape[0], C)),
                           device=cuda_device)
    slot_d = torch.zeros(pl_d.shape[0], dtype=torch.int32, device=cuda_device)
    assert torch.equal(gather.grid_trilinear_bwd(ct_d, shape, slot_d, pl_d),
                       volumes.trilinear_backward_plain(ct_d, shape, slot_d,
                                                        pl_d))


def _surface_scene(name):
    """(scene dict, ERT_BVH_WIDE, the kernel its mesh queries launch, the
    gradient keys) of the pool and replay card tests."""
    from chip_smoke import forest_scene, terrain_scene
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    if name == "terrain":
        V, F = terrain(33)  # 16 tiles: the fused sweep query
        return (terrain_scene(V, F, 16, 16, 4, 4), "0", "tile_sweep",
                ["spectra.baked.value"])
    if name.startswith("forest"):
        wide = name == "forest-bvh8"
        return (forest_scene(16, 16, 4, 4, n_inst=16), "1" if wide else "0",
                "tile_bvh8" if wide else "tile_bvh", ["spectra.baked.value"])
    d = atmosphere(16, 16, 4, 12, grid_res=64)
    d["sky"] = {"type": "constant", "radiance": 0.1}
    return d, "0", "tile_sweep", ["volumes.gridvolume.grid",
                                  "spectra.baked.value"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["terrain", "forest-bvh", "forest-bvh8",
                                  "sky"])
def test_pool_and_replay_match_plain_versions(cuda_device, name,
                                              monkeypatch):
    """A 16x16, 4 spp value+grad on the lane pool (render(regen=True), its
    backward the path replay) of a surface scene through its mesh kernel
    and through the plain version: the terrain (tile_sweep), the
    16-instance forest (tile_bvh, tile_bvh8) and the sky-lit atmosphere
    (volpath's MIS walk; the cube's fused sweep). The same film bit for
    bit, the kernel launched in the forward and in the backward, and
    gradients within rtol 1e-5, atol 1e-7 where the plain version's are
    finite (the RPV rows are NaN in both, ROADMAP Queue 3)."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.films import develop
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils import autodiff

    d, wide, kernel, keys = _surface_scene(name)
    monkeypatch.setenv("ERT_BVH_WIDE", wide)
    scene = load_dict(d)
    pm = autodiff.traverse(scene).keep(keys)

    def value_grad():
        params = pm.trainable()
        film = integrators.render(pm.with_trainable(params), seed=3,
                                  samples_per_pass=256, regen=True,
                                  develop_film=False)
        launched = intersect.launches[kernel]
        develop(film).mean().backward()
        return (film.detach(), [params[k].grad for k in keys], launched,
                intersect.launches[kernel] - launched)

    before = intersect.launches[kernel]
    film, grads, fwd, _ = value_grad()
    torch.cuda.synchronize()
    assert fwd > before and intersect.launches[kernel] > fwd
    with intersect.use_plain():
        film_p, grads_p, _, plain_bwd = value_grad()
    assert plain_bwd == 0
    assert torch.equal(film, film_p)
    for g, gp in zip(grads, grads_p):
        ok = torch.isfinite(gp)
        assert torch.equal(ok, torch.isfinite(g))
        assert bool(g[ok].abs().sum() > 0)
        torch.testing.assert_close(g[ok], gp[ok], rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "lanczos"])
def test_wide_film_put_and_gather_match_cpu(cuda_device, kind):
    """The wide-filter splat and its adjoint gather (eager torch, one
    function for both devices) on the card against the same call on the
    CPU: rtol 1e-5, the order of the card's float atomics."""
    from eradiate_kernel_tpu_torch.films import film_gather, film_put

    rng = np.random.default_rng(8)
    H, W, n = 48, 64, 1 << 16
    pos = torch.as_tensor(rng.uniform([-2, -2], [W + 2, H + 2], (n, 2)),
                          dtype=torch.float32)
    v = torch.as_tensor(rng.random((n, 5)), dtype=torch.float32)
    img = torch.as_tensor(rng.random((H, W, 5)), dtype=torch.float32)
    put = film_put(torch.zeros(H, W, 5, device=cuda_device),
                   pos.to(cuda_device), v.to(cuda_device), kind)
    torch.testing.assert_close(put.cpu(), film_put(torch.zeros(H, W, 5), pos,
                                                   v, kind),
                               rtol=1e-5, atol=1e-5)
    got = film_gather(img.to(cuda_device), pos.to(cuda_device), kind)
    torch.testing.assert_close(got.cpu(), film_gather(img, pos, kind),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "terrain"])
def test_materials_match_plain_versions(cuda_device, name):
    """chip_smoke.py phases 26-27 at 64x64, spp 4: the materials Cornell
    box on the lane pool (the cube's fused sweep) and the materials
    terrain(33) on the scan driver (the sorted sweep) through the kernel
    and through the plain sweep, films within 1e-4 but 2 pixels, the
    kernel launched once a query; the Cornell box's value+grad through
    the path replay within rtol 1e-5, atol 1e-7."""
    from chip_smoke import (films_equivalent, materials_cornell,
                            materials_terrain)
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.films import develop
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils import autodiff

    if name == "cornell":
        scene = load_dict(materials_cornell(64, 64, 4, 6))
        render = lambda sc: integrators.render(
            sc, seed=3, regen=True, samples_per_pass=4096,
            develop_film=False)
    else:
        V, F = terrain(33)
        scene = load_dict(materials_terrain(V, F, 64, 64, 4, 6))
        render = lambda sc: integrators.render(sc, seed=3,
                                               develop_film=False)
    before = intersect.launches["tile_sweep"]
    film = render(scene)
    torch.cuda.synchronize()
    assert intersect.launches["tile_sweep"] > before
    with intersect.use_plain():
        film_p = render(scene)
    films_equivalent(film_p.cpu().numpy(), film.cpu().numpy(), max_flips=2)
    if name != "cornell":
        return
    pm = autodiff.traverse(scene).keep(["spectra.baked.value"])
    grads = []
    for plain in (False, True):
        params = pm.trainable()
        if plain:
            with intersect.use_plain():
                develop(render(pm.with_trainable(params))).mean().backward()
        else:
            develop(render(pm.with_trainable(params))).mean().backward()
        grads.append(params["spectra.baked.value"].grad)
    g, gp = grads
    ok = torch.isfinite(gp)
    assert torch.equal(ok, torch.isfinite(g)) and bool(g.abs().sum() > 0)
    torch.testing.assert_close(g[ok], gp[ok], rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["measured", "box"])
def test_slice_5c2_matches_plain_versions(cuda_device, name, tmp_path):
    """chip_smoke.py phases 30-31 at 32x32, spp 4: terrain(33) read from a
    PLY under a measured BRDF and an envmap (multijitter; the sorted
    sweep, scan driver) and the lights-and-quadrics box (ldsampler; the
    cube's fused sweep, lane pool), through the kernel and through the
    plain sweep: films within 1e-4 but 2 pixels, the kernel launched."""
    from chip_smoke import (films_equivalent, measured_terrain,
                            quadrics_box, sky_image, synth_measured_fields)
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils import meshio

    if name == "measured":
        V, F = terrain(33)
        meshio.write_ply(tmp_path / "t.ply", V, F)
        scene = load_dict(measured_terrain(
            str(tmp_path / "t.ply"), synth_measured_fields(6, 16, 32, 5),
            sky_image(64, 128, 6), 32, 32, 4, 6))
        render = lambda: integrators.render(scene, seed=3,
                                            develop_film=False)
    else:
        scene = load_dict(quadrics_box(32, 32, 4, 6))
        render = lambda: integrators.render(
            scene, seed=3, regen=True, samples_per_pass=2048,
            develop_film=False)
    before = intersect.launches["tile_sweep"]
    film = render()
    torch.cuda.synchronize()
    assert intersect.launches["tile_sweep"] > before
    with intersect.use_plain():
        film_p = render()
    assert float(film.sum()) > 0
    films_equivalent(film_p.cpu().numpy(), film.cpu().numpy(), max_flips=2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["independent", "stratified",
                                  "multijitter", "orthogonal", "ldsampler"])
def test_sampler_draws_match_cpu(cuda_device, kind):
    """Each sampler's draws on 2^16 lanes near 2^32, bit-equal to the same
    calls on the CPU."""
    from eradiate_kernel_tpu_torch.core.rng import Sampler

    lane = (torch.arange(1 << 16, dtype=torch.int64) * 40503
            + 2 ** 32 - 2 ** 20) % 2 ** 32
    gpu = Sampler.seed(5, lane.to(cuda_device), kind=kind, spp=9)
    cpu = Sampler.seed(5, lane, kind=kind, spp=9)
    for step in range(6):
        if step % 2:
            (gpu, u), (cpu, v) = gpu.next_2d(), cpu.next_2d()
        else:
            (gpu, u), (cpu, v) = gpu.next_1d(), cpu.next_1d()
        assert torch.equal(u.cpu(), v), (kind, step)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3])
def test_nearest_lookup_and_backward_match_cpu(cuda_device, C):
    """A nearest-filter lookup of a (2, 17, 33, 31, C) grid on the card is
    one launch of grid_gather's gather entry (a C = 1 grid gives rows of
    one float, off the vec4 path), bit-equal to the CPU's; its gradient
    (volumes.NearestGather: index_add_ of the cotangent) matches the CPU's
    within rtol 1e-5, atol 1e-7 (the card's atomics add in no fixed
    order)."""
    rng = np.random.default_rng(40 + C)
    g = rng.random((2, 17, 33, 31, C)).astype(np.float32)
    pl = rng.uniform(-0.1, 1.1, (64, 100, 3)).astype(np.float32)
    slot = rng.integers(0, 2, (64, 100)).astype(np.int32)
    ct = rng.normal(size=(64, 100, C)).astype(np.float32)
    out, grads = [], []
    for dev in (cuda_device, torch.device("cpu")):
        grid = torch.as_tensor(g, device=dev).requires_grad_(True)
        before = gather.launches["grid_gather"]
        o = volumes._nearest_gather(grid, torch.as_tensor(slot, device=dev),
                                    torch.as_tensor(pl, device=dev))
        (o * torch.as_tensor(ct, device=dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert gather.launches["grid_gather"] == before + 1
        out.append(o.detach().cpu())
        grads.append(grid.grad.cpu())
    assert out[0].shape == (64, 100, C)
    assert torch.equal(out[0], out[1])
    assert bool(grads[1].abs().sum() > 0)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_gauss_legendre_tau_matches_cpu(cuda_device):
    """medium_tau_segment of the 17 x 16 x 16 atmosphere grid (the packed
    path) by 8-node Gauss-Legendre quadrature on the card against the
    CPU: one grid_gather launch for all 8 nodes of every lane, and the
    optical depths within rtol 1e-6, atol 1e-7."""
    from eradiate_kernel_tpu_torch import media
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    d = atmosphere(8, 8, 4, 6, grid_res=(17, 16, 16))
    rng = np.random.default_rng(41)
    n = 4096
    o = rng.uniform([-15, -15, 0.05], [15, 15, 0.95], (n, 3))
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    a = rng.uniform(0.0, 2.0, n).astype(np.float32)
    b = (a + rng.uniform(0.0, 8.0, n)).astype(np.float32)
    taus = []
    for dev in (cuda_device, torch.device("cpu")):
        scene = load_dict(d, device=str(dev))
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        ray = Ray.make(t(o), t(v))
        before = gather.launches["grid_gather"]
        tau = media.medium_tau_segment(
            scene, torch.zeros(n, dtype=torch.int32, device=dev), ray, t(a),
            t(b), ray.wavelengths, quad_points=8)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert gather.launches["grid_gather"] == before + 1
        taus.append(tau.cpu())
    assert float(taus[1].max()) > 0.01
    torch.testing.assert_close(taus[0], taus[1], rtol=1e-6, atol=1e-7)


def _same_tensors_on_card(a, b):
    ta, tb = a.tensors(), b.tensors()
    assert ta.keys() == tb.keys()
    for name, t in ta.items():
        assert t.device.type == "cuda", name
        assert torch.equal(t, tb[name]), name


@pytest.mark.cuda
def test_scene_from_files_loads_onto_the_card(cuda_device, tmp_path):
    """chip_smoke.py phase 34(a) at 32x32 spp 4 over terrain(33): the
    scene read from XML, PLY and EXR files by load_file (its default
    device, the card) has every tensor bit-equal to load_dict's of the
    same dict with the images inline; its lane-pool film launches
    tile_sweep once a closest-hit query and is within 1e-4 but 2 pixels of
    the dict scene's."""
    from chip_smoke import (albedo_map, counted_pool, films_equivalent,
                            sky_image, terrain_files)
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.scene import load_dict, load_file

    V, F = terrain(33)
    path, inline, _ = terrain_files(str(tmp_path), V, F, 32, 32, 4,
                                    albedo_map(64, seed=7),
                                    sky_image(32, 64, seed=6))
    scene = load_file(path)
    ref = load_dict(inline)
    _same_tensors_on_card(scene, ref)
    assert scene.config == ref.config and scene.config.spp == 4
    film, _, launches, counts = counted_pool(scene, 1024)
    assert launches["tile_sweep"] == counts["queries"] > 0
    film_d = integrators.render(ref, seed=0, regen=True,
                                samples_per_pass=1024, develop_film=False)
    assert float(film[..., 4].sum()) == 32 * 32 * 4
    films_equivalent(film_d.cpu().numpy(), film.cpu().numpy(), max_flips=2)


@pytest.mark.cuda
def test_atmosphere_from_xml_and_vol_on_the_card(cuda_device, tmp_path):
    """chip_smoke.py phase 34(b) at 16x16 spp 4: the 17 x 16 x 16
    atmosphere written with dict_to_xml, its grid in a .vol file, loads
    onto the card bit-equal to load_dict's scene; one grid_gather launch a
    lookup, and its film within 1e-4 but 2 pixels of the dict scene's."""
    import copy

    from chip_smoke import counted_pool, films_equivalent
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.scene import load_dict, load_file, xml
    from eradiate_kernel_tpu_torch.utils import volfile
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    d = atmosphere(16, 16, 4, 6, grid_res=(17, 16, 16))
    d["sensor"]["film"]["type"] = "hdrfilm"
    d_vol = copy.deepcopy(d)
    grid = d_vol["atmo"]["interior"]["sigma_t"]
    volfile.write_vol(str(tmp_path / "g.vol"), grid.pop("data"))
    grid["filename"] = str(tmp_path / "g.vol")
    xml.write_file(str(tmp_path / "a.xml"), d_vol)
    scene = load_file(str(tmp_path / "a.xml"))
    ref = load_dict(d)
    _same_tensors_on_card(scene, ref)
    film, _, launches, counts = counted_pool(scene, 512, seed=3)
    assert launches["grid_gather"] == counts["lookups"] > 0
    film_d = integrators.render(ref, seed=3, regen=True,
                                samples_per_pass=512, develop_film=False)
    films_equivalent(film_d.cpu().numpy(), film.cpu().numpy(), max_flips=2)


@pytest.mark.cuda
@pytest.mark.parametrize("grid_res", [64, (17, 16, 16)])
def test_volpathmis_atmosphere_matches_cpu(cuda_device, grid_res):
    """A 16x16 spp 4 volpathmis atmosphere (max_depth 6) on the lane pool
    of the card against the same render on the CPU: tile_sweep launched
    once a closest-hit query (and grid_gather once a lookup on the 17 x
    16 x 16 grid), the films within 1e-4 but 8 pixels (torch's
    transcendentals differ by an ulp between the devices, and a free
    flight's null/real decision can flip on one: tests/conftest.py::
    assert_driver_equivalent's reason). The ground is lowered by 1e-3."""
    from chip_smoke import counted_pool, films_equivalent
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    d = atmosphere(16, 16, 4, 6, grid_res=grid_res)
    # the ground lowered by 1e-3 off the cube's floor (the coplanar tie,
    # ROADMAP Queue 3), as the CPU tests do
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    d["integrator"]["type"] = "volpathmis"
    film, _, launches, counts = counted_pool(load_dict(d), 512, seed=3)
    assert launches["tile_sweep"] == counts["queries"] > 0
    assert launches["grid_gather"] == counts["lookups"]
    assert (counts["lookups"] > 0) == (grid_res != 64)
    cpu = integrators.render(load_dict(d, device="cpu"), seed=3, regen=True,
                             samples_per_pass=512, develop_film=False)
    assert float(film[..., 4].sum()) == 16 * 16 * 4
    films_equivalent(cpu.numpy(), film.cpu().numpy(), max_flips=8)


@pytest.mark.cuda
def test_terrain_aov_channels_match_cpu(cuda_device):
    """aov (depth, position, uv, both normals, prim and shape index) over
    path on a 16x16 spp 4 terrain(33), on the card's lane pool and the
    CPU's: the radiance film within 1e-4 but 2 pixels, every AOV channel
    within 1e-5 of max(|value|, 1) but 2 pixels (both on the pool: a
    sample lands in its own pixel)."""
    from chip_smoke import films_equivalent, terrain_scene
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.scene import load_dict

    V, F = terrain(33)
    d = terrain_scene(V, F, 16, 16, 4, 3)
    d["integrator"] = {"type": "aov", "aovs": (
        "dd:depth,pp:position,uv:uv,nn:geo_normal,sn:sh_normal,"
        "pi:prim_index,si:shape_index"), "child": d["integrator"]}
    out = {}
    for dev in ("cuda", "cpu"):
        before = intersect.launches["tile_sweep"]
        img, aovs = integrators.render(load_dict(d, device=dev), seed=3,
                                       regen=True, samples_per_pass=256,
                                       return_aovs=True)
        assert (intersect.launches["tile_sweep"] > before) == (dev == "cuda")
        out[dev] = (img.cpu().numpy(), {k: v.cpu().numpy()
                                        for k, v in aovs.items()})
    films_equivalent(out["cpu"][0], out["cuda"][0], max_flips=2)
    assert list(out["cpu"][1]) == list(out["cuda"][1])
    for k, v in out["cpu"][1].items():
        films_equivalent(v[..., None], out["cuda"][1][k][..., None],
                         max_flips=2, tol=1e-5)
    assert (out["cuda"][1]["si"] >= 0).any()


@pytest.mark.cuda
def test_spectral_distant_atmosphere_matches_cpu(cuda_device):
    """The 1x1 spectral distant atmosphere (grid 16, max_depth 8), 256
    samples on the card's lane pool against the CPU's: tile_sweep launched
    once a closest-hit query, the films within 1e-4 (a 1x1 film: no flip
    budget; torch's transcendentals differ by an ulp between the devices,
    so a sample can take another path only if a decision flips on one).
    The ground is lowered by 1e-3."""
    from chip_smoke import counted_pool, films_equivalent
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    d = atmosphere(spp=256, max_depth=8, grid_res=16, sensor="distant")
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    film, _, launches, counts = counted_pool(
        load_dict(d, Variant("spectral")), 64, seed=5)
    assert launches["tile_sweep"] == counts["queries"] > 0
    assert launches["grid_gather"] == 0  # 256 voxels: the einsum path
    cpu = integrators.render(load_dict(d, Variant("spectral"), device="cpu"),
                             seed=5, regen=True, samples_per_pass=64,
                             develop_film=False)
    assert float(film[..., 4].sum()) == 256
    films_equivalent(cpu.numpy(), film.cpu().numpy(), max_flips=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 4, 5), (17, 16, 16)])
def test_gridvolume_srgb_lookups_match_cpu(cuda_device, shape):
    """gridvolume_srgb lookups (the packed 8-corner rows of 4 floats a
    corner through grid_gather's gather entry, then the sigmoid at each
    corner) on the card against the CPU's, at seeded points and
    wavelengths, within 1e-6; and a gridvolume_spectral grid of 6
    wavelengths above 4,096 voxels through the fused trilinear entry. A
    volume_eval runs the lookup of every grid kind of the scene over its
    lanes (the reference's masked sweep): one launch of each entry."""
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.scene import load_dict

    rng = np.random.default_rng(47)
    srgb = rng.uniform(0.05, 2.5, shape + (3,)).astype(np.float32)
    spec = rng.uniform(0.1, 2.0, (17, 16, 16, 6)).astype(np.float32)
    cube = lambda vol: {
        "type": "cube", "bsdf": {"type": "null"},
        "to_world": [{"type": "scale", "value": 0.5},
                     {"type": "translate", "value": [0.5, 0.5, 0.5]}],
        "interior": {"type": "heterogeneous", "sigma_t": vol,
                     "albedo": 0.5}}
    d = {"type": "scene",
         "sensor": {"type": "perspective", "film": {"width": 2,
                                                    "height": 2}},
         "a": cube({"type": "gridvolume", "data": srgb}),
         "b": cube({"type": "gridvolume_spectral", "data": spec,
                    "lambda_min": 400.0, "lambda_max": 800.0})}
    n = 4096
    p = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    lam = rng.uniform(350, 850, (n, 4)).astype(np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        scene = load_dict(d, Variant("spectral"), device=str(dev))
        kinds = scene.config.volume_kinds
        for kind in ("gridvolume_srgb", "gridvolume_spectral"):
            vi = [i for i, k in enumerate(scene.vol_kind.tolist())
                  if kinds[k] == kind][0]
            before = gather.launches["grid_gather"]
            v = volumes.volume_eval(
                scene, torch.full((n,), vi, dtype=torch.int32, device=dev),
                torch.as_tensor(p, device=dev),
                torch.as_tensor(lam, device=dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert gather.launches["grid_gather"] == before + 2, kind
            out[(kind, dev.type)] = v.cpu()
    for kind in ("gridvolume_srgb", "gridvolume_spectral"):
        assert bool(out[(kind, "cpu")].abs().sum() > 0)
        torch.testing.assert_close(out[(kind, "cuda")], out[(kind, "cpu")],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_spectral_grid_gradients_match_cpu(cuda_device):
    """The gradients of volume_eval with respect to a 17x16x16 srgb grid
    (PackedRowGather: the gather entry forward, index_add_ backward) and
    an 8-band gridvolume_spectral (GridTrilinear: the fused entry
    forward, grid_trilinear_bwd at C = 8 backward) on the card against
    the CPU's, for seeded cotangents: within rtol 1e-5 and 1e-5 of the
    largest (both add with atomics in no fixed order; the srgb
    coefficients' cotangents reach 1e5 through the sigmoid)."""
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.scene import load_dict

    rng = np.random.default_rng(48)
    cube = lambda vol: {
        "type": "cube", "bsdf": {"type": "null"},
        "to_world": [{"type": "scale", "value": 0.5},
                     {"type": "translate", "value": [0.5, 0.5, 0.5]}],
        "interior": {"type": "heterogeneous", "sigma_t": vol,
                     "albedo": 0.5}}
    d = {"type": "scene",
         "sensor": {"type": "perspective", "film": {"width": 2,
                                                    "height": 2}},
         "a": cube({"type": "gridvolume", "data": rng.uniform(
             0.05, 2.5, (17, 16, 16, 3)).astype(np.float32)}),
         "b": cube({"type": "gridvolume_spectral", "data": rng.uniform(
             0.1, 2.0, (17, 16, 16, 8)).astype(np.float32),
             "lambda_min": 400.0, "lambda_max": 800.0})}
    n = 4096
    p = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    lam = rng.uniform(350, 850, (n, 4)).astype(np.float32)
    ct = rng.normal(size=(n, 4)).astype(np.float32)
    cpu_scene = load_dict(d, Variant("spectral"), device="cpu")
    card_scene = load_dict(d, Variant("spectral"), device=str(cuda_device))
    grads = {}
    for kind in ("gridvolume_srgb", "gridvolume_spectral"):
        key = f"volumes.{kind}.grid"
        for scene in (card_scene, cpu_scene):
            dev = scene.bsphere_center.device
            kinds = scene.config.volume_kinds
            vi = [i for i, k in enumerate(scene.vol_kind.tolist())
                  if kinds[k] == kind][0]
            grid = scene.volumes[kind]["grid"].clone().requires_grad_()
            v = volumes.volume_eval(
                scene.with_tensors({key: grid}),
                torch.full((n,), vi, dtype=torch.int32, device=dev),
                torch.as_tensor(p, device=dev),
                torch.as_tensor(lam, device=dev))
            before = gather.launches["grid_trilinear_bwd"]
            (v * torch.as_tensor(ct, device=dev)).sum().backward()
            if dev.type == "cuda":
                torch.cuda.synchronize()
                # the spectral grid's backward is one launch of the entry
                assert gather.launches["grid_trilinear_bwd"] == before + (
                    kind == "gridvolume_spectral"), kind
            grads[dev.type] = grid.grad.cpu()
        ref = grads["cpu"]
        assert bool(ref.abs().sum() > 0), kind
        torch.testing.assert_close(
            grads["cuda"], ref, rtol=1e-5,
            atol=max(1e-6, 1e-5 * float(ref.abs().max())))


def _polarized_atmosphere(width, spp, grid_res=64, phase=None,
                          integrator="stokes", device="cuda"):
    """chip_smoke.polarized_atmosphere (bench.py's polarized load) at a
    small size, its ground lowered by 1e-3 (the coplanar tie, ROADMAP
    Queue 3)."""
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    d = atmosphere(width, width, spp, 8, grid_res=grid_res)
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    child = {"type": "volpath", "max_depth": 8}
    d["integrator"] = (child if integrator == "volpath" else
                       {"type": "stokes", "child": child})
    if phase is not None:
        d["atmo"]["interior"]["phase"] = phase
    return load_dict(d, Variant("rgb", polarized=True), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("grid_res", [64, (64, 64, 64)])
def test_polarized_atmosphere_matches_cpu(cuda_device, grid_res):
    """stokes(volpath) over bench.py's polarized atmosphere (16x16 spp 2,
    max_depth 8, Variant("rgb", polarized=True)) on the card's lane pool
    against the CPU's: tile_sweep launched once a closest-hit query,
    grid_gather once a lookup of the 64^3 grid, S3 exactly 0, the films
    (S0 and S1..S3) within 1e-4 but 8 pixels (test_volpathmis_atmosphere_
    matches_cpu's reason)."""
    from chip_smoke import counted_pool, films_equivalent
    from eradiate_kernel_tpu_torch import integrators

    film, _, launches, counts = counted_pool(
        _polarized_atmosphere(16, 2, grid_res), 256, seed=3)
    assert launches["tile_sweep"] == counts["queries"] > 0
    assert launches["grid_gather"] == counts["lookups"]
    assert (counts["lookups"] > 0) == (grid_res != 64)
    assert float(film[..., 7].abs().max()) == 0.0
    assert float(film[..., 5:7].abs().max()) > 0.0
    cpu = integrators.render(_polarized_atmosphere(16, 2, grid_res,
                                                   device="cpu"),
                             seed=3, regen=True, samples_per_pass=256,
                             develop_film=False)
    assert float(film[..., 4].sum()) == 16 * 16 * 2
    films_equivalent(cpu.numpy(), film.cpu().numpy(), max_flips=8)


@pytest.mark.cuda
def test_polarized_volpath_s0_matches_volpath_on_card(cuda_device):
    """Under an isotropic phase the Mueller volpath's S0 is volpath's
    sample for sample on the card (rtol 1e-5; at most 0.1 % of the
    samples, at least 1, may take another path where an ulp of the
    Mueller products' association flips a roulette), S1..S3 exactly 0."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.integrators import polarized_vol, volpath

    scene = _polarized_atmosphere(16, 4, phase={"type": "isotropic"},
                                  integrator="volpath")
    n = 16 * 16 * 4
    smp, ray, _rw, _pos = integrators._camera_lanes(
        scene, 5, 4, torch.arange(n, dtype=torch.int64, device=cuda_device))
    spec, _v, _s = volpath.sample(scene, smp, ray)
    stokes, _v2, _s2 = polarized_vol.sample_stokes(scene, smp, ray)
    off = ~torch.isclose(stokes[..., 0], spec, rtol=1e-5,
                         atol=1e-7).all(-1)
    assert float(spec.abs().max()) > 0.01
    assert int(off.sum()) <= max(1, n // 1000)
    assert float(stokes[..., 1:].abs().max()) == 0.0


@pytest.mark.cuda
def test_pplastic_terrain_stokes_matches_plain(cuda_device):
    """terrain(33) with a pplastic ground under stokes(path) (32x32 spp 2,
    max_depth 4) on the card's scan driver through the sweep and through
    the plain sweep: the same film bit for bit, tile_sweep launched once a
    query."""
    from chip_smoke import counted_scan, terrain_scene
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.scene import load_dict

    V, F = terrain(33)
    d = terrain_scene(V, F, 32, 32, 2, 4)
    d["terrain"]["bsdf"] = {"type": "pplastic", "alpha": 0.2,
                            "diffuse_reflectance": [0.3, 0.4, 0.5]}
    d["integrator"] = {"type": "stokes", "child": d["integrator"]}
    scene = load_dict(d, Variant("rgb", polarized=True))
    film, _secs, got = counted_scan(scene, seed=3)
    assert got["launches"]["tile_sweep"] == got["queries"] > 0
    with intersect.use_plain():
        plain = integrators.render(scene, seed=3, develop_film=False)
    assert torch.equal(film, plain)
    assert float(film[..., 5:7].abs().max()) > 0.0


@pytest.mark.cuda
def test_optical_bench_gates_on_card(cuda_device):
    """tests/test_polarization.py's optical bench on the card (rectangles:
    no kernel): Malus's law, crossed polarizers, and a half-wave plate at
    45 degrees between them; S0 within 1e-4."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.scene import load_dict

    def s0(elements):
        d = {"type": "scene",
             "integrator": {"type": "stokes",
                            "child": {"type": "path", "max_depth": 2}},
             "sensor": {"type": "radiancemeter",
                        "to_world": {"type": "look_at",
                                     "origin": [0, 0, -4],
                                     "target": [0, 0, 1], "up": [0, 1, 0]},
                        "film": {"width": 1, "height": 1,
                                 "rfilter": {"type": "box"}},
                        "sampler": {"sample_count": 64}},
             "env": {"type": "constant", "radiance": 1.0}}
        for i, el in enumerate(elements):
            d[f"el{i}"] = {"type": "rectangle",
                           "to_world": {"type": "translate",
                                        "value": [0, 0, -3.0 + i]},
                           "bsdf": el}
        before = dict(intersect.launches)
        img = integrators.render(load_dict(d, Variant("rgb",
                                                      polarized=True)),
                                 seed=1)
        assert intersect.launches == before
        return float(img[0, 0, 1])

    pol = lambda theta: {"type": "polarizer", "theta": theta}
    for theta in (0.0, 30.0, 60.0, 90.0):
        assert abs(s0([pol(0.0), pol(theta)])
                   - 0.5 * np.cos(np.deg2rad(theta)) ** 2) < 1e-4, theta
    assert abs(s0([pol(0.0), pol(90.0)])) < 1e-4
    assert abs(s0([pol(0.0), {"type": "retarder", "theta": 45.0,
                              "delta": 180.0}, pol(90.0)]) - 0.5) < 1e-4


@pytest.mark.cuda
def test_two_shard_render_matches_one_shard(cuda_device):
    """parallel.render_sharded over two shards of the card in one process:
    the lane pools' film (pools of 256 lanes in both) bit-equal to the
    one-shard film, since each pixel's samples lie in one shard and the
    card computes every lane alike; the scan driver's within 1e-6 a pixel
    but 2 (its film_put adds a pixel's samples with atomics, in any order,
    and its passes are as wide as the shards: a free flight's decision
    may flip on an ulp, tests/conftest.py::assert_driver_equivalent)."""
    from chip_smoke import films_equivalent
    from eradiate_kernel_tpu_torch.parallel import make_mesh, render_sharded
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    d = atmosphere(16, 16, 4, 6, grid_res=(17, 16, 16))
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    scene = load_dict(d)
    one, two = make_mesh([cuda_device]), make_mesh([cuda_device] * 2)
    assert (one.size, two.size) == (1, 2)
    films = [render_sharded(scene, m, seed=3, regen=True, regen_lanes=256,
                            develop_film=False) for m in (one, two)]
    assert float(films[1][..., 4].sum()) == 16 * 16 * 4
    assert torch.equal(films[0], films[1])
    scans = [render_sharded(scene, m, seed=3, develop_film=False)
             for m in (one, two)]
    films_equivalent(scans[0].cpu().numpy(), scans[1].cpu().numpy(),
                     max_flips=2, tol=1e-6)
