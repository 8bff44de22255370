"""volpath under area and environment emitters (the MIS emitter walk of
evaluate_direct_light) in the port against the JAX package.

- The atmosphere under a constant sky (radiance 0.1) added to
  utils.scenes.atmosphere's dict, ground lowered by 1e-3
  (tests/test_torch_volpath.py's docstring): 8x8 films at 4 spp through
  the lane pool of 64 lanes against the reference's
  render_wavefront_regen at the same seed, within assert_driver_equivalent's
  budget, for the plane-parallel grid and a 3D grid (the residual walk).
- The volumetric scattering furnace (a homogeneous sphere of albedo 1
  under a constant environment): L = 1 within the figures of
  tests/test_volpath.py::test_scattering_furnace.
- An area light over the same medium sphere: the MIS walk's emitter hit
  through a null boundary, against the reference's film.

The sky-lit atmosphere's gradient is in tests/test_torch_surface_grad.py."""

import jax
import numpy as np
import pytest

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

SEED, SPP, LANES = 5, 4, 64


def sky_atmosphere(grid_res, width=8, spp=SPP):
    d = atmosphere(width, width, spp, 6, grid_res=grid_res)
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    d["sky"] = {"type": "constant", "radiance": 0.1}
    return d


@pytest.mark.parametrize("grid_res", [64, (17, 16, 16)],
                         ids=["grid64", "grid17x16x16"])
def test_sky_lit_atmosphere_matches_reference(grid_res):
    d = sky_atmosphere(grid_res)
    jscene = jload_dict(d)
    scene = load_dict(d, device="cpu")
    assert scene.config.env_emitter >= 0
    run = jax.jit(jintegrators.render_wavefront_regen,
                  static_argnames=("n_lanes", "spp"))
    ref, ref_rays = run(jscene, LANES, SEED, SPP)
    ref = np.asarray(ref)
    stats = {}
    film, rays = integrators.render_wavefront_regen(scene, LANES, SEED, SPP,
                                                    stats=stats)
    film = film.numpy()
    np.testing.assert_array_equal(film[..., 4], SPP)
    assert stats["dropped"] == 0
    assert_driver_equivalent(ref, film, max_flips=4)
    assert abs(float(rays) - float(ref_rays)) <= 0.05 * float(ref_rays)


def medium_sphere(albedo, spp, light=False):
    """tests/test_volpath.py's homogeneous unit sphere (sigma_t 1) under a
    constant environment; ``light`` puts an area light above it instead
    of the environment (6 units up: nearer, the reference's NEE walk
    counts the light's own surface as an occluder, ROADMAP.md Queue 3)."""
    d = {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 64,
                       "rr_depth": 1000},
        "sensor": {"type": "perspective", "fov": 30.0,
                   "to_world": {"type": "look_at", "origin": [0, 0, -4],
                                "target": [0, 0, 0], "up": [0, 1, 0]},
                   "film": {"type": "hdrfilm", "width": 8, "height": 8,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "bound": {"type": "sphere", "radius": 1.0,
                  "interior": {"type": "homogeneous", "sigma_t": 1.0,
                               "albedo": albedo}},
    }
    if light:
        d["light"] = {
            "type": "rectangle",
            "to_world": [{"type": "scale", "value": 2.0},
                         {"type": "rotate", "axis": [1, 0, 0],
                          "angle": 90.0},
                         {"type": "translate", "value": [0, 6.0, 0]}],
            "emitter": {"type": "area", "radiance": 20.0}}
    else:
        d["env"] = {"type": "constant", "radiance": 1.0}
    return d


def test_volumetric_scattering_furnace():
    """Conservative scattering in a constant environment: L = 1 (mean
    within 0.03, the centre pixel within 0.12)."""
    scene = load_dict(medium_sphere(1.0, 128), device="cpu")
    img = integrators.render(scene, seed=2, regen=True,
                             samples_per_pass=1024).numpy()
    assert abs(img.mean() - 1.0) < 0.03, img.mean()
    assert abs(img[4, 4].mean() - 1.0) < 0.12, img[4, 4]


def test_area_light_over_medium_matches_reference():
    d = medium_sphere(0.8, 8, light=True)
    ref = np.asarray(jintegrators.render(jload_dict(d), seed=1))
    img = integrators.render(load_dict(d, device="cpu"), seed=1).numpy()
    assert ref.mean() > 0.01
    assert_driver_equivalent(ref, img, max_flips=2)
