"""Cylinders and cones (slice 5c-2) in the port against the JAX package:
the scene arrays bit-equal, the brute-force intersection (the same shape
and primitive; the hit distance within 16 ulp on 99 % of the hits and
within rtol 1e-4 on all: near grazing the discriminant b^2 - 4ac cancels,
and XLA contracts it into a multiply-add; 25 of 3,183 hits here), the
surface interaction recomputed from the reference's preliminary hit (rtol
1e-5, atol 1e-5, the sphere and disk tests' figures), and a render of both with an area
emitter on a cylinder (whose shape sampling has no cylinder branch in
either package) on the scan driver and the lane pool within
tests/conftest.py::assert_driver_equivalent's budget."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.core.ray import Ray as JRay
from eradiate_kernel_tpu.render import geometry as jgeometry
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.render import geometry
from eradiate_kernel_tpu_torch.scene import load_dict
from test_torch_scene import reference_arrays
from test_torch_shapes import rays

ATOL = 1e-5


def quadrics_dict(emitter=False):
    """Two cylinders and two cones, scaled, rotated and translated, over
    a floor rectangle, lit by the sun."""
    d = {
        "type": "scene",
        "pipe": {"type": "cylinder", "radius": 0.3, "length": 0.8,
                 "to_world": [{"type": "rotate", "axis": [1, 0, 0],
                               "angle": 70.0},
                              {"type": "translate",
                               "value": [-0.5, 0.3, 0.4]}]},
        "post": {"type": "cylinder", "radius": 0.15, "length": 1.0,
                 "to_world": [{"type": "scale", "value": 0.9},
                              {"type": "translate",
                               "value": [0.6, -0.4, 0.0]}]},
        "crown": {"type": "cone", "radius": 0.4, "length": 0.7,
                  "to_world": [{"type": "translate",
                                "value": [0.2, 0.5, 0.3]}]},
        "spike": {"type": "cone", "radius": 0.2, "length": 0.6,
                  "to_world": [{"type": "scale", "value": 1.2},
                               {"type": "rotate", "axis": [0, 1, 0],
                                "angle": 120.0},
                               {"type": "translate",
                                "value": [-0.3, -0.5, 0.9]}]},
        "floor": {"type": "rectangle",
                  "to_world": [{"type": "scale", "value": 1.5}]},
        "sun": {"type": "directional", "direction": [0.3, 0.2, -1.0]},
        "camera": {"type": "perspective",
                   "to_world": [{"type": "lookat", "origin": [0, -3, 3],
                                 "target": [0, 0, 0.4], "up": [0, 0, 1]}],
                   "film": {"type": "hdrfilm", "width": 16, "height": 16,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 4}},
        "integrator": {"type": "path", "max_depth": 3},
    }
    if emitter:
        d["post"]["emitter"] = {"type": "area", "radiance": [2.0, 1.5, 1.0]}
    return d


@pytest.fixture(scope="module")
def scenes():
    d = quadrics_dict()
    return jload_dict(d), load_dict(d, device="cpu")


def test_scene_arrays_bit_equal(scenes):
    jscene, scene = scenes
    ref = reference_arrays(jscene)
    arrays = scene.arrays()
    for name in ("geo.cyl_to_world.m", "geo.cyl_length", "geo.cyl_radius",
                 "geo.cyl_shape", "geo.cone_to_world.inv_t",
                 "geo.cone_radius", "geo.cone_shape", "shape_area"):
        assert name in arrays, name
    for name, a in arrays.items():
        np.testing.assert_array_equal(a, ref[name], err_msg=name)


def test_hits_and_surface_interaction_match_reference(scenes):
    jscene, scene = scenes
    o, d = rays(4096, seed=2)
    jray = JRay.make(jnp.asarray(o), jnp.asarray(d))
    jpi = jgeometry.ray_intersect_preliminary(jscene.geo, jray)
    ray = Ray.make(torch.as_tensor(o), torch.as_tensor(d))
    pi = geometry.ray_intersect_preliminary(scene.geo, ray)
    rt = np.asarray(jpi.t)
    hit = np.isfinite(rt)
    np.testing.assert_array_equal(np.isfinite(pi.t.numpy()), hit)
    ulp = np.spacing(np.abs(rt[hit]).astype(np.float32))
    n_ulp = np.abs(pi.t.numpy()[hit] - rt[hit]) / ulp
    assert (n_ulp > 16).mean() <= 0.01
    np.testing.assert_allclose(pi.t.numpy()[hit], rt[hit], rtol=1e-4)
    np.testing.assert_array_equal(pi.shape_index.numpy(),
                                  np.asarray(jpi.shape_index))
    np.testing.assert_array_equal(pi.prim_index.numpy()[hit],
                                  np.asarray(jpi.prim_index)[hit])
    fams = {int(f) for f in scene.geo.shape_family[
        pi.shape_index.clamp(min=0)][torch.as_tensor(hit)]}
    assert {geometry.FAMILY_CYLINDER, geometry.FAMILY_CONE} <= fams

    jsi = jgeometry.compute_surface_interaction(jscene.geo, jray, jpi)
    si = geometry.compute_surface_interaction(
        scene.geo, ray, geometry.PreliminaryIntersection(
            *[torch.tensor(np.asarray(x)) for x in (
                jpi.t, jpi.prim_uv, jpi.prim_index, jpi.shape_index)]))
    quad = hit & np.isin(scene.geo.shape_family[
        pi.shape_index.clamp(min=0)].numpy(),
        [geometry.FAMILY_CYLINDER, geometry.FAMILY_CONE])
    for name in ("t", "p", "n", "uv", "dp_du", "dp_dv", "wi"):
        np.testing.assert_allclose(
            getattr(si, name).numpy()[quad],
            np.asarray(getattr(jsi, name))[quad], rtol=1e-5, atol=ATOL,
            err_msg=name)


def test_render_matches_reference():
    d = quadrics_dict(emitter=True)
    jscene = jload_dict(d)
    scene = load_dict(d, device="cpu")
    assert scene.config.emitter_kinds == ("area", "directional")
    ref = np.asarray(jintegrators.render(jscene, seed=1))
    assert ref.mean() > 0.05
    assert_driver_equivalent(ref, integrators.render(scene, seed=1).numpy(),
                             max_flips=2)
    pool = integrators.render(scene, seed=1, regen=True,
                              samples_per_pass=200).numpy()
    assert_driver_equivalent(ref, pool, max_flips=2)
