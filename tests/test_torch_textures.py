"""Slice 5c-1's textures in the port against the JAX package: the
checkerboard, bitmap (inline data, and an EXR file) and mesh_attribute
kinds, in rgb and mono, on the same seeded lanes (bit for bit: the bilinear and barycentric
formulas are evaluated in the reference's order, and XLA's CPU code
contracts none of them), and the scene arrays of the materials scenes
(bitmap_data, mesh_attr_data, every BSDF and texture table, bsdf_flags)
against the reference's load_dict, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu.core.types import Variant as JVariant
from eradiate_kernel_tpu.render.texture import texture_eval as jtexture_eval
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.render.texture import texture_eval
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import bitmap
from test_torch_materials_render import materials_scenes
from test_torch_scene import port_config, reference_arrays
from test_torch_sensors import one_torch_thread  # noqa: F401

N = 4096


def texture_scene(variant):
    """A three-vertex-per-face mesh (4 faces) carrying every texture kind:
    a checkerboard and a bitmap on a blend's weight and its two diffuse
    children, a mesh_attribute (3 channels and 1 channel) on a plastic."""
    rng = np.random.default_rng(7)
    verts = rng.uniform(-1, 1, (12, 3)).astype(np.float32)
    faces = np.arange(12, dtype=np.int32).reshape(4, 3)
    return {
        "type": "scene",
        "sensor": {"type": "perspective",
                   "film": {"width": 2, "height": 2}},
        "mesh": {"type": "mesh", "vertices": verts, "faces": faces,
                 "attributes": {
                     "color": rng.random((12, 3)).astype(np.float32),
                     "gray": rng.random(12).astype(np.float32)},
                 "bsdf": {"type": "blendbsdf",
                          "weight": {"type": "checkerboard",
                                     "color0": 0.2, "color1": 0.8},
                          "a": {"type": "diffuse", "reflectance": {
                              "type": "bitmap", "data": rng.random(
                                  (5, 7, 3)).astype(np.float32)}},
                          "b": {"type": "plastic", "diffuse_reflectance": {
                              "type": "mesh_attribute", "name": "color",
                              "scale": 0.5}}}},
        "other": {"type": "mesh", "vertices": verts[:3], "faces": faces[:1],
                  "bsdf": {"type": "diffuse", "reflectance": {
                      "type": "mesh_attribute", "name": "gray"}}},
        "gray": {"type": "mesh", "vertices": verts[:3], "faces": faces[:1],
                 "bsdf": {"type": "diffuse", "reflectance": {
                     "type": "bitmap",
                     "data": rng.random((5, 7)).astype(np.float32)}}},
    }


def _both(d, variant):
    return (jload_dict(d, JVariant(variant)),
            load_dict(d, Variant(variant), device="cpu"))


@pytest.mark.parametrize("variant", ["rgb", "mono"])
def test_texture_kinds_match_reference(variant):
    jscene, scene = _both(texture_scene(variant), variant)
    assert set(scene.config.texture_kinds) == {
        "constant", "checkerboard", "bitmap", "mesh_attribute"}
    rng = np.random.default_rng(8)
    n_tex = scene.tex_kind.shape[0]
    tex = rng.integers(0, n_tex, N).astype(np.int32)
    uv = rng.uniform(-0.2, 1.2, (N, 2)).astype(np.float32)
    prim = rng.integers(0, 6, N).astype(np.int32)  # past the faces: clamped
    prim_uv = rng.dirichlet([1, 1, 1], N)[:, 1:].astype(np.float32)
    got = texture_eval(scene, torch.as_tensor(tex), torch.as_tensor(uv),
                       si_extra={"prim_index": torch.as_tensor(prim),
                                 "prim_uv": torch.as_tensor(prim_uv)})
    ref = jtexture_eval(jscene, jnp.asarray(tex), jnp.asarray(uv),
                        jnp.zeros((N, 0)),
                        si_extra={"prim_index": jnp.asarray(prim),
                                  "prim_uv": jnp.asarray(prim_uv)})
    assert got.shape == (N, 1 if variant == "mono" else 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # every kind was read
    kinds = scene.tex_kind[torch.as_tensor(tex)]
    assert len(set(kinds.tolist())) == 4


def test_texture_without_uv_reads_the_origin():
    """Point and directional lights pass no uv (the reference passes
    zeros)."""
    jscene, scene = _both(texture_scene("rgb"), "rgb")
    tex = torch.arange(scene.tex_kind.shape[0], dtype=torch.int32)
    np.testing.assert_array_equal(
        texture_eval(scene, tex).numpy(),
        texture_eval(scene, tex, torch.zeros(tex.shape[0], 2)).numpy())


@pytest.mark.parametrize("name", ["cornell", "terrain"])
@pytest.mark.parametrize("variant", ["rgb", "mono"])
def test_scene_arrays_match_reference(name, variant):
    jd, d = materials_scenes(name)
    jscene = jload_dict(jd, JVariant(variant))
    scene = load_dict(d, Variant(variant), device="cpu")
    ref = reference_arrays(jscene)
    arrays = scene.arrays()
    for key in ("bitmap_data", "mesh_attr_data", "bsdf_flags"):
        assert key in arrays
    if name == "cornell":
        assert arrays["bitmap_data"].shape == (2, 64, 64, 3)
    else:
        assert arrays["mesh_attr_data"].shape[0] == 1
    for key, a in arrays.items():
        assert a.shape == ref[key].shape, key
        np.testing.assert_array_equal(a, ref[key], err_msg=key)
    assert scene.config == port_config(jscene.config)


def test_texture_dicts_refused_or_checked(tmp_path):
    """A bitmap read from a PIZ EXR loads the reference's arrays bit for
    bit, in rgb and mono; a mesh attribute of the wrong size is
    refused."""
    d = texture_scene("rgb")
    path = str(tmp_path / "ground.exr")
    bitmap.write_exr(path, np.random.default_rng(3).random(
        (5, 7, 3)).astype(np.float32), compression="piz")
    d["mesh"]["bsdf"]["a"]["reflectance"] = {"type": "bitmap",
                                             "filename": path}
    for variant in ("rgb", "mono"):
        jscene, scene = _both(d, variant)
        ref = reference_arrays(jscene)
        for key, a in scene.arrays().items():
            np.testing.assert_array_equal(a, ref[key], err_msg=key)
    d = texture_scene("rgb")
    d["mesh"]["attributes"]["color"] = np.zeros((5, 3), np.float32)
    with pytest.raises(ValueError, match="attribute 'color'"):
        load_dict(d, device="cpu")
