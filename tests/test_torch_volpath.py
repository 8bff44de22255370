"""The port's atmosphere forward pass (volpath on the regenerating lane
pool) against the JAX package's ``render_wavefront_regen`` at the same
seed: 8x8 films at 4 spp, max_depth 6, within assert_driver_equivalent's
flip budget (tests/test_volpath.py::test_regen_matches_fixed_trip's), with
the plane-parallel grid (einsum lookups, closed-form NEE walk), a 3D grid
of more than 4,096 voxels (packed-corner gathers, residual NEE walk), the
reference's scene arrays carried into the port, and a homogeneous medium
with a Henyey-Greenstein phase function in place of the grid.

The films are of the atmosphere with its ground lowered by 1e-3. In the
scene as utils.scenes.atmosphere builds it the ground rectangle lies in
the plane of the atmosphere cube's bottom face, so every ray reaching the
ground hits both at the same distance up to rounding, and the last ulp of
either decides whether the path reflects or leaves the medium below the
ground. The port's rays differ from XLA's by an ulp where XLA contracts a
multiply-add, so that decision goes the other way on a few per cent of the
ground hits; lowering the ground by 1e-3 removes the tie and nothing else
(ROADMAP.md, Queue 3)."""

import jax
import numpy as np
import pytest

from conftest import assert_driver_equivalent
from test_torch_scene import port_config, reference_arrays
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.scene import from_numpy, load_dict
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

SEED, SPP, LANES = 5, 4, 64  # 256 samples through 64 lanes: many refills


def lowered_atmosphere(grid_res):
    d = atmosphere(8, 8, SPP, 6, grid_res=64 if grid_res == "homogeneous"
                   else grid_res)
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    if grid_res == "homogeneous":
        d["atmo"]["interior"] = {
            "type": "homogeneous", "sigma_t": 0.3,
            "albedo": [0.8, 0.7, 0.6], "phase": {"type": "hg", "g": 0.5}}
    return d


_REF = {}


def reference(grid_res):
    """(reference scene, its regen film, its rays traced), rendered once."""
    if grid_res not in _REF:
        scene = jload_dict(lowered_atmosphere(grid_res))
        run = jax.jit(jintegrators.render_wavefront_regen,
                      static_argnames=("n_lanes", "spp"))
        film, rays = run(scene, LANES, SEED, SPP)
        _REF[grid_res] = (scene, np.asarray(film), float(rays))
    return _REF[grid_res]


@pytest.mark.parametrize("case", ["grid64", "grid17x16x16", "carried",
                                  "homogeneous"])
def test_regen_film_matches_reference(case):
    grid_res = {"grid17x16x16": (17, 16, 16),
                "homogeneous": "homogeneous"}.get(case, 64)
    ref_scene, ref_film, ref_rays = reference(grid_res)
    if case == "carried":
        scene = from_numpy(reference_arrays(ref_scene),
                           port_config(ref_scene.config), device="cpu")
    else:
        scene = load_dict(lowered_atmosphere(grid_res), device="cpu")
    assert (scene.vol_packed is not None) == (case == "grid17x16x16")
    stats = {}
    film, rays = integrators.render_wavefront_regen(scene, LANES, SEED, SPP,
                                                    stats=stats)
    film = film.numpy()
    assert film.shape == ref_film.shape == (8, 8, 5)
    assert np.isfinite(film).all() and film[..., :3].mean() > 0.05
    np.testing.assert_array_equal(film[..., 4], SPP)  # every sample landed
    assert stats["dropped"] == 0 and stats["iterations"] > 6
    assert_driver_equivalent(ref_film, film, max_flips=4)
    assert abs(float(rays) - ref_rays) <= 0.05 * ref_rays


def test_regen_matches_scan_driver():
    """The lane pool and the scan driver draw every sample from the same
    stream: the same film (the pool's gates are off, the scan's on, so this
    also holds the skipped sites to the sampler counts of the taken
    ones)."""
    scene = load_dict(lowered_atmosphere((17, 16, 16)), device="cpu")
    scan = integrators.render(scene, seed=SEED, develop_film=False)
    regen = integrators.render(scene, seed=SEED, develop_film=False,
                               regen=True, samples_per_pass=LANES)
    assert_driver_equivalent(scan.numpy(), regen.numpy(), max_flips=0,
                             tol=1e-6)
