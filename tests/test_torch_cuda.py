"""Card-only tests of the port's CUDA kernels. They import neither jax nor
the JAX package, so they also run where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Without a CUDA device they skip."""

import numpy as np
import pytest
import torch

from bench_mesh import terrain
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.ops import accel, intersect


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 8 * intersect.RAY_BLOCK + 17])
def test_tile_sweep_matches_plain(cuda_device, n):
    """The CUDA kernel against the plain sweep on the same inputs: bit
    equal (the same float32 expressions, no multiply-add contraction)."""
    V, F = terrain(33)
    tiles = accel.pack_tiles(V, F, np.zeros(len(F), np.int32))
    rng = np.random.default_rng(n)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(0.3, 1.5, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.where(rng.uniform(size=n) < 0.3,
                    rng.uniform(0.5, 3.0, n), np.inf).astype(np.float32)
    ray = Ray.make(torch.as_tensor(o, device=cuda_device),
                   torch.as_tensor(d, device=cuda_device),
                   maxt=torch.as_tensor(maxt, device=cuda_device))
    tdev = {k: torch.as_tensor(v, device=cuda_device)
            for k, v in tiles.items()}
    before = intersect.launches
    out = intersect.intersect_tiles(tdev, ray, return_visited=True)
    torch.cuda.synchronize()
    assert intersect.launches == before + 1
    with intersect.use_plain_sweep():
        ref = intersect.intersect_tiles(tdev, ray, return_visited=True)
    assert intersect.launches == before + 1
    assert torch.isfinite(out[0]).any()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
