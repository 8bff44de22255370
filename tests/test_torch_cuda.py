"""Card-only tests of the port's CUDA kernels. They import neither jax nor
the JAX package, so they also run where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Without a CUDA device they skip."""

import numpy as np
import pytest
import torch

from bench_mesh import terrain
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.ops import accel, bvh, intersect


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


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["tile_bvh", "tile_bvh8"])
@pytest.mark.parametrize("n", [17, 8 * intersect.RAY_BLOCK + 17])
def test_tile_bvh_matches_plain(cuda_device, n, wide):
    """Each BVH kernel against its plain traversal: hits and per-block
    visit counts and stack depths bit equal."""
    ray = _rays(n, cuda_device)
    tdev = _terrain_tiles(cuda_device)
    name = "tile_bvh8" if wide else "tile_bvh"
    fn = intersect.intersect_bvh8 if wide else intersect.intersect_bvh
    before = intersect.launches[name]
    out = fn(tdev, ray, return_stats=True)
    torch.cuda.synchronize()
    assert intersect.launches[name] == before + 1
    with intersect.use_plain():
        ref = fn(tdev, ray, return_stats=True)
    assert intersect.launches[name] == before + 1
    assert torch.isfinite(out[0]).any() and int(out[4][:, 0].sum()) > 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
