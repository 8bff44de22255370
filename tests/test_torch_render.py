"""The slice end to end: the port's ``load_dict`` + ``integrators.render``
against the reference's on the same scene and seed.

The reference renders through its tile-sweep kernel in interpret mode
(ERT_ACCEL=tiles, ERT_ACCEL_INTERPRET=1, the pattern of
tests/test_accel.py:226-246). Both draw the same random numbers (the RNG is
bit-equal), so the films agree sample for sample: every pixel within 1e-4
relative (tests/conftest.py::assert_driver_equivalent), with a budget of 2
pixels (of 256 x 4 samples) for discrete divergences, where an ulp
difference in a hit point flips a Russian-roulette or tile-boundary
decision."""

import os

import conftest
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.scene import from_numpy, load_dict
from test_torch_scene import port_config, reference_arrays, terrain_scene


def _reference_render(scene, seed):
    os.environ["ERT_ACCEL"] = "tiles"
    os.environ["ERT_ACCEL_INTERPRET"] = "1"
    try:
        return np.asarray(jintegrators.render(scene, seed=seed))
    finally:
        os.environ.pop("ERT_ACCEL", None)
        os.environ.pop("ERT_ACCEL_INTERPRET", None)


@pytest.mark.parametrize("ground", [False, True])
def test_render_matches_reference(ground):
    d = terrain_scene(n=17, width=16, height=16, spp=4, max_depth=3,
                      ground=ground)
    ref_scene = jload_dict(d)
    ref = _reference_render(ref_scene, seed=5)
    img = integrators.render(load_dict(d, device="cpu"), seed=5)
    assert img.shape == ref.shape and img.dtype == torch.float32
    assert np.isfinite(ref).all() and ref.mean() > 0.01
    conftest.assert_driver_equivalent(ref, img.numpy(), max_flips=2)

    # the same scene carried over from the reference's arrays renders the
    # same film as the port's own load_dict
    carried = from_numpy(reference_arrays(ref_scene),
                         port_config(ref_scene.config), device="cpu")
    torch.testing.assert_close(integrators.render(carried, seed=5), img,
                               rtol=0, atol=0)


def test_multipass_accumulation():
    """Several passes sum to the single-pass film (same samples)."""
    scene = load_dict(terrain_scene(n=9, width=8, height=8, spp=4,
                                    max_depth=2), device="cpu")
    one = integrators.render(scene, seed=1, develop_film=False)
    many = integrators.render(scene, seed=1, samples_per_pass=60,
                              develop_film=False)
    torch.testing.assert_close(many, one, rtol=1e-5, atol=1e-6)
    assert float(one[..., 4].sum()) == 8 * 8 * 4
