"""Instanced scenes in the port against the reference: ``load_dict`` of a
shapegroup under three instances (tests/test_instancing.py's _tri_bump
group and transforms) plus a top-level mesh, a ground rectangle and a sun.

Scene arrays must be bit-equal to the reference Scene's. Renders through
each BVH kernel (ERT_ACCEL=bvh and bvh8, the reference's kernels in
interpret mode) must agree sample for sample within
tests/conftest.py::assert_driver_equivalent's budget (1e-4 relative per
pixel, 2 flipped pixels), as the terrain render of test_torch_render.py.
"""

import conftest
import jax
import numpy as np
import pytest
import torch

from bench_mesh import terrain
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.render.geometry import FAMILY_IMESH
from eradiate_kernel_tpu_torch.scene import from_numpy, load_dict
from test_instancing import TRANSFORMS, _tri_bump
from test_torch_scene import port_config, reference_arrays


def instanced_scene(width=16, height=16, spp=4, max_depth=3):
    V, F = _tri_bump()
    Vt, Ft = terrain(9)
    d = {
        "type": "scene",
        "grp": {"type": "shapegroup",
                "bump": {"type": "mesh", "vertices": V, "faces": F,
                         "bsdf": {"type": "diffuse", "reflectance": 0.6}}},
        "hill": {"type": "mesh", "vertices": Vt * 0.35, "faces": Ft,
                 "to_world": {"type": "translate", "value": [0.8, 0.9, 0.0]},
                 "bsdf": {"type": "diffuse",
                          "reflectance": [0.2, 0.5, 0.3]}},
        "ground": {"type": "rectangle",
                   "to_world": [{"type": "scale", "value": [3.0, 3.0, 1.0]},
                                {"type": "translate",
                                 "value": [0.0, 0.0, -0.3]}],
                   "bsdf": {"type": "rpv", "rho_0": 0.2, "g": -0.1,
                            "k": 0.7}},
        "sun": {"type": "directional", "direction": [0.3, 0.0, -0.94],
                "irradiance": 1.0},
        "camera": {
            "type": "perspective", "fov": 55.0,
            "to_world": {"type": "look_at", "origin": [0.0, -2.2, 2.2],
                         "target": [0.0, 0.0, 0.0], "up": [0, 0, 1]},
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
        "integrator": {"type": "path", "max_depth": max_depth},
    }
    for i, tw in enumerate(TRANSFORMS):
        d[f"inst{i}"] = {"type": "instance",
                         "shapegroup": {"type": "ref", "id": "grp"},
                         "to_world": tw}
    return d


def test_load_dict_matches_reference():
    d = instanced_scene()
    ref_scene = jload_dict(d)
    ref = reference_arrays(ref_scene)
    scene = load_dict(d, device="cpu")
    arrays = scene.arrays()
    for name in ("geo.bvh_box", "geo.bvh8_meta", "geo.tiles_xf",
                 "geo.tiles_sbase", "geo.ig_faces", "geo.inst_w2l.m",
                 "geo.inst_lo", "geo.shape_inst", "bsphere_radius"):
        assert name in arrays, name
    assert arrays["geo.inst_f_off"].shape == (3,)
    assert (arrays["geo.shape_family"] == FAMILY_IMESH).sum() == 3
    for name, a in arrays.items():
        assert a.shape == ref[name].shape, name
        if name.startswith("geo."):
            assert a.dtype == ref[name].dtype, name
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    assert scene.config == port_config(ref_scene.config)

    carried = from_numpy(ref, port_config(ref_scene.config), device="cpu")
    for name, a in carried.arrays().items():
        np.testing.assert_array_equal(a, arrays[name], err_msg=name)


def _reference_render(scene, accel, seed):
    # the accel mode is read while tracing: drop traces of another mode
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ERT_ACCEL", accel)
        mp.setenv("ERT_ACCEL_INTERPRET", "1")
        return np.asarray(jintegrators.render(scene, seed=seed))


@pytest.mark.parametrize("accel", ["bvh", "bvh8"])
def test_render_matches_reference(accel, monkeypatch):
    d = instanced_scene()
    ref_scene = jload_dict(d)
    ref = _reference_render(ref_scene, accel, seed=5)
    monkeypatch.setenv("ERT_ACCEL", accel)
    img = integrators.render(load_dict(d, device="cpu"), seed=5)
    assert img.shape == ref.shape and img.dtype == torch.float32
    assert np.isfinite(ref).all() and ref.mean() > 0.01
    conftest.assert_driver_equivalent(ref, img.numpy(), max_flips=2)

    # carried over from the reference's arrays, the same film
    carried = from_numpy(reference_arrays(ref_scene),
                         port_config(ref_scene.config), device="cpu")
    torch.testing.assert_close(integrators.render(carried, seed=5), img,
                               rtol=0, atol=0)
