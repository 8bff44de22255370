"""The port's counter-based RNG against eradiate_kernel_tpu/core/rng.py:
threefry and the independent sampler must be bit-equal, so both packages
draw the same sample for every (seed, lane, dimension)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu.core import rng as jrng
from eradiate_kernel_tpu_torch.core import rng as trng


def _u32(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_threefry_bit_equal(seed):
    rng = np.random.default_rng(seed)
    k0, k1, x0, x1 = (_u32(rng, 4096) for _ in range(4))
    # include the edge values of the uint32 range
    k0[:4] = x1[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    ref = jrng.threefry2x32(k0, k1, x0, x1)
    out = trng.threefry2x32(*(torch.as_tensor(a.astype(np.int64))
                              for a in (k0, k1, x0, x1)))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      o.numpy())


@pytest.mark.parametrize("seed", [0, 5, 123456789012])
def test_sampler_independent_bit_equal(seed):
    rng = np.random.default_rng(3)
    lanes = np.concatenate([np.arange(512), _u32(rng, 512)]).astype(np.uint32)
    js = jrng.Sampler.seed(seed, jnp.asarray(lanes))
    ts = trng.Sampler.seed(seed, torch.as_tensor(lanes.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(js.k0).astype(np.int64),
                                  ts.k0.numpy())
    # an interleaved draw sequence like one path-tracer bounce
    for kind in ("2d", "1d", "1d", "1d", "2d", "1d", "2d"):
        if kind == "1d":
            js, a = js.next_1d()
            ts, b = ts.next_1d()
        else:
            js, a = js.next_2d()
            ts, b = ts.next_2d()
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(np.asarray(js.dim)[0]) == ts.dim


def test_uniform_range():
    bits = torch.tensor([0, 255, 256, 0xFFFFFFFF], dtype=torch.int64)
    u = trng.uint32_to_uniform(bits)
    ref = np.asarray(jrng.uint32_to_uniform(
        jnp.asarray(bits.numpy().astype(np.uint32))))
    np.testing.assert_array_equal(ref, u.numpy())
    assert float(u.max()) < 1.0
