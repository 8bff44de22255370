"""Renders of slice 5c-1's materials in the port against the JAX package
at the same seed, within tests/conftest.py::assert_driver_equivalent's
budget (1e-4 relative a pixel, 2 flipped pixels), on the scan driver and
the lane pool:

- the materials Cornell box (chip_smoke.py phase 26's scene at 16x16):
  the reference's Cornell box with a dielectric, a rough gold and a rough
  dielectric sphere, a 12-triangle cube mesh under a Beckmann rough
  plastic with a checkerboard diffuse reflectance, the back wall under a
  bump map and the floor under a normal map (both inline 64x64 bitmaps);
- the materials terrain (phase 27's scene on terrain(17)): a blendbsdf
  whose weight is a checkerboard, over a plastic reading a per-vertex
  colour (mesh_attribute) and an anisotropic Beckmann rough conductor;
- a volpath film (8x8) of a rough dielectric sphere with a homogeneous
  interior under a constant environment.

The cube's uvs span [0.2, 0.8]: a face at u = 1 would put every hit on
the checkerboard's edge (floor(2u) of 1 +- an ulp), where the two
packages' rounding picks either colour."""

import numpy as np
import pytest

from bench_mesh import terrain
from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import scenes as jscenes
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import scenes
from test_torch_scene import terrain_scene
from test_torch_sensors import one_torch_thread  # noqa: F401

LANES = 100  # a pool far smaller than the films' samples: many refills

CUBE_V = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                   [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                  np.float32)
CUBE_F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                   [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                   [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int32)


def add_materials(d, res=64):
    """The materials of chip_smoke.py's phase 26 added to a Cornell box
    dict ``d`` (either package's utils.scenes.cornell_box)."""
    g = (np.arange(res, dtype=np.float32) + 0.5) / res
    u, v = np.meshgrid(g, g)
    height = 0.5 + 0.5 * np.sin(8 * np.pi * u) * np.sin(8 * np.pi * v)
    n = np.stack([0.3 * np.sin(6 * np.pi * u), 0.3 * np.cos(6 * np.pi * v),
                  np.ones_like(u)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    c, s = np.cos(np.pi / 6), np.sin(np.pi / 6)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    d["back"]["bsdf"] = {
        "type": "bumpmap", "scale": 0.05,
        "bumpmap": {"type": "bitmap", "data": height.astype(np.float32)},
        "nested": {"type": "ref", "id": "white_bsdf"}}
    d["floor"]["bsdf"] = {
        "type": "normalmap",
        "normalmap": {"type": "bitmap",
                      "data": (0.5 * n + 0.5).astype(np.float32)},
        "nested": {"type": "ref", "id": "white_bsdf"}}
    d["glass"] = {"type": "sphere", "center": [-0.5, -0.69, -0.3],
                  "radius": 0.3,
                  "bsdf": {"type": "dielectric", "int_ior": "bk7"}}
    d["gold"] = {"type": "sphere", "center": [0.5, -0.69, 0.4],
                 "radius": 0.3,
                 "bsdf": {"type": "roughconductor", "distribution": "ggx",
                          "alpha": 0.2, "material": "Au"}}
    d["frosted"] = {"type": "sphere", "center": [0.1, -0.74, -0.5],
                    "radius": 0.25,
                    "bsdf": {"type": "roughdielectric",
                             "distribution": "ggx", "alpha": 0.1}}
    d["cube"] = {
        "type": "mesh",
        "vertices": ((CUBE_V * 0.22) @ rot.T
                     + np.float32([-0.35, -0.77, 0.45])).astype(np.float32),
        "faces": CUBE_F, "uvs": 0.5 + 0.3 * CUBE_V[:, :2],
        "bsdf": {"type": "roughplastic", "distribution": "beckmann",
                 "alpha": 0.1,
                 "diffuse_reflectance": {"type": "checkerboard",
                                         "color0": [0.8, 0.3, 0.1],
                                         "color1": [0.1, 0.3, 0.8]}}}
    return d


def materials_terrain(n=17, width=16, height=16, spp=4, max_depth=3):
    """terrain(n) with uvs ((x + 1) / 2, (y + 1) / 2), a per-vertex colour
    from its height and chip_smoke.py phase 27's blend."""
    d = terrain_scene(n=n, width=width, height=height, spp=spp,
                      max_depth=max_depth)
    V, _F = terrain(n)
    s = (V[:, 2] - V[:, 2].min()) / (V[:, 2].max() - V[:, 2].min())
    d["terrain"]["uvs"] = 0.5 * (V[:, :2] + 1.0)
    d["terrain"]["attributes"] = {"vertex_color": np.stack(
        [0.2 + 0.6 * s, 0.5 - 0.2 * s, 0.8 - 0.6 * s], -1).astype(
            np.float32)}
    d["terrain"]["bsdf"] = {
        "type": "blendbsdf",
        "weight": {"type": "checkerboard", "color0": 0.2, "color1": 0.8},
        "base": {"type": "plastic", "diffuse_reflectance": {
            "type": "mesh_attribute", "name": "vertex_color"}},
        "metal": {"type": "roughconductor", "distribution": "beckmann",
                  "alpha_u": 0.1, "alpha_v": 0.4}}
    return d


def materials_scenes(name, **kw):
    """(reference dict, port dict) of the materials Cornell box (each
    package's own cornell_box: its sensor transform is the package's) or
    the materials terrain."""
    if name == "cornell":
        args = (kw.get("width", 16), kw.get("height", 16), kw.get("spp", 8),
                kw.get("max_depth", 4))
        return (add_materials(jscenes.cornell_box(*args)),
                add_materials(scenes.cornell_box(*args)))
    d = materials_terrain(**kw)
    return d, d


@pytest.mark.parametrize("name", ["cornell", "terrain"])
def test_materials_films_match_reference(name):
    jd, d = materials_scenes(name)
    scene = load_dict(d, device="cpu")
    ref = np.asarray(jintegrators.render(jload_dict(jd), seed=1))
    scan = integrators.render(scene, seed=1).numpy()
    pool = integrators.render(scene, seed=1, regen=True,
                              samples_per_pass=LANES).numpy()
    assert ref.mean() > 0.02
    assert_driver_equivalent(ref, scan, max_flips=2)
    assert_driver_equivalent(ref, pool, max_flips=2)


def test_volpath_rough_dielectric_medium_matches_reference():
    """volpath through a rough dielectric boundary into a homogeneous
    medium: the sample's eta, the medium transition and the BSDF-sampled
    MIS walk on both drivers."""
    d = {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 8},
        "sensor": {"type": "perspective", "fov": 35.0,
                   "to_world": {"type": "look_at", "origin": [0, 0, -4],
                                "target": [0, 0, 0], "up": [0, 1, 0]},
                   "film": {"type": "hdrfilm", "width": 8, "height": 8,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 8}},
        "ball": {"type": "sphere", "radius": 1.0,
                 "bsdf": {"type": "roughdielectric", "alpha": 0.2},
                 "interior": {"type": "homogeneous", "sigma_t": 1.5,
                              "albedo": [0.9, 0.7, 0.5]}},
        "env": {"type": "constant", "radiance": 1.0},
    }
    scene = load_dict(d, device="cpu")
    ref = np.asarray(jintegrators.render(jload_dict(d), seed=2))
    scan = integrators.render(scene, seed=2).numpy()
    pool = integrators.render(scene, seed=2, regen=True,
                              samples_per_pass=LANES).numpy()
    assert 0.2 < ref.mean() < 1.0
    assert_driver_equivalent(ref, scan, max_flips=2)
    assert_driver_equivalent(ref, pool, max_flips=2)
