"""The port's volume lookups (textures/volumes.py) against the reference on
the same seeded inputs: the packed corner table bit for bit, gridvolume
lookups on the gather path (a (17, 16, 16) grid, > 4,096 voxels) and on
the einsum path (the flagship's 64 x 4 x 4 grid), and the wrap modes."""

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
