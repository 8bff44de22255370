"""Mesh files (slice 5c-2): the port's loaders (utils/meshio.py) against
the reference's on files written to tmp_path, bit for bit: PLY (ascii
through ``write_ply``, and binary little endian with a quad), OBJ (mixed
position/uv/normal tokens, negative indices, quads; and terrain(33)
through chip_smoke.py's writer) and Mitsuba ``serialized``
(chip_smoke.py's writer). Then scenes: the ``obj``, ``ply`` and
``serialized`` shape types at the top level and as ``shapegroup``
children (the child's ``to_world`` applied), their arrays bit-equal to the
reference's and to the inline mesh's, and a render of a forest whose crown
is read from a file, within tests/conftest.py::assert_driver_equivalent's
budget."""

import struct

import numpy as np
import pytest

from chip_smoke import terrain, write_obj, write_serialized
from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import meshio as jmeshio
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import meshio
from test_torch_scene import reference_arrays, terrain_scene


def same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def test_ply_matches_reference(tmp_path):
    V, F = terrain(33)
    meshio.write_ply(tmp_path / "port.ply", V, F)
    jmeshio.write_ply(tmp_path / "ref.ply", V, F)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "ref.ply").read_bytes()
    got = meshio.load_ply(tmp_path / "ref.ply")
    same(got, jmeshio.load_ply(tmp_path / "ref.ply"))
    same(got, (V, F))
    rng = np.random.default_rng(0)
    with open(tmp_path / "bin.ply", "wb") as fh:
        fh.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
                 b"property float w\nproperty float x\nproperty float y\n"
                 b"property float z\nelement face 3\n"
                 b"property list uchar int vertex_indices\nend_header\n")
        fh.write(rng.normal(size=(5, 4)).astype("<f4").tobytes())
        fh.write(struct.pack("<B3i", 3, 0, 1, 2)
                 + struct.pack("<B4i", 4, 0, 2, 3, 4)
                 + struct.pack("<B3i", 3, 4, 1, 0))
    same(meshio.load_ply(tmp_path / "bin.ply"),
         jmeshio.load_ply(tmp_path / "bin.ply"))
    assert len(meshio.load_ply(tmp_path / "bin.ply")[1]) == 4


def test_obj_matches_reference(tmp_path):
    rng = np.random.default_rng(1)
    path = tmp_path / "mixed.obj"
    with open(path, "w") as fh:
        fh.write("# a comment\no thing\n")
        for v in rng.normal(size=(7, 3)):
            fh.write("v %r %r %r\n" % tuple(map(float, v)))
        for v in rng.random(size=(4, 2)):
            fh.write("vt %r %r\n" % tuple(map(float, v)))
        for v in rng.normal(size=(3, 3)):
            fh.write("vn %r %r %r\n" % tuple(map(float, v)))
        fh.write("f 1/1/1 2/2/2 3/3/3\nf 1/1/1 3/3/3 4/4/1 5//2\n"
                 "f -1 2/2/2 6/1\ns off\nf 6/1 1/1/1 2 3 7\n")
    same(meshio.load_obj(path), jmeshio.load_obj(path))
    V, F = terrain(33)
    write_obj(tmp_path / "terrain.obj", V, F)
    got = meshio.load_obj(tmp_path / "terrain.obj")
    same(got, jmeshio.load_obj(tmp_path / "terrain.obj"))
    np.testing.assert_array_equal(got[0][got[1]], V[F])  # the triangles
    assert got[2] is None and got[3] is None


def test_serialized_matches_reference(tmp_path):
    V, F = terrain(33)
    write_serialized(tmp_path / "terrain.serialized", V, F)
    got = meshio.load_serialized(tmp_path / "terrain.serialized")
    same(got, jmeshio.load_serialized(tmp_path / "terrain.serialized"))
    same(got, (V, F, None, None))


def write_all(tmp_path, V, F):
    """terrain (V, F) as ply, obj and serialized files: {type: path}."""
    paths = {"ply": tmp_path / "t.ply", "obj": tmp_path / "t.obj",
             "serialized": tmp_path / "t.serialized"}
    meshio.write_ply(paths["ply"], V, F)
    write_obj(paths["obj"], V, F)
    write_serialized(paths["serialized"], V, F)
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("kind", ["ply", "obj", "serialized"])
def test_top_level_file_scene_matches_reference_and_inline(tmp_path, kind):
    V, F = terrain(17)
    path = write_all(tmp_path, V, F)[kind]
    inline = terrain_scene(n=17)
    d = terrain_scene(n=17)
    d["terrain"] = {"type": kind, "filename": path,
                    "bsdf": inline["terrain"]["bsdf"]}
    scene = load_dict(d, device="cpu")
    arrays = scene.arrays()
    ref = reference_arrays(jload_dict(d))
    for name, a in arrays.items():
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    # the inline mesh's scene: the same triangles, tiles and shape tables
    # (an OBJ numbers its vertices in order of first use)
    base = load_dict(inline, device="cpu").arrays()
    for name, a in arrays.items():
        if kind == "obj" and name in ("geo.vertices", "geo.faces",
                                      "geo.normals", "geo.uvs"):
            continue
        np.testing.assert_array_equal(a, base[name], err_msg=name)
    np.testing.assert_array_equal(
        arrays["geo.vertices"][arrays["geo.faces"]],
        base["geo.vertices"][base["geo.faces"]])


def forest_dict(crown, n_inst=6):
    """terrain(9) crowns (a shapegroup child ``crown``) instanced over a
    rectangle ground, lit by the sun."""
    rng = np.random.default_rng(2)
    d = {
        "type": "scene",
        "grp": {"type": "shapegroup", "crown": crown},
        "ground": {"type": "rectangle",
                   "to_world": {"type": "scale", "value": [3.0, 3.0, 1.0]}},
        "sun": {"type": "directional", "direction": [0.3, 0.0, -0.94]},
        "camera": {
            "type": "perspective", "fov": 60.0,
            "to_world": {"type": "look_at", "origin": [0.0, -5.0, 3.0],
                         "target": [0.0, 0.0, 0.0], "up": [0, 0, 1]},
            "film": {"type": "hdrfilm", "width": 16, "height": 16,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": 4}},
        "integrator": {"type": "path", "max_depth": 3},
    }
    for i in range(n_inst):
        x, y = rng.uniform(-2, 2, 2)
        d[f"i{i}"] = {"type": "instance",
                      "shapegroup": {"type": "ref", "id": "grp"},
                      "to_world": {"type": "translate",
                                   "value": [float(x), float(y), 0.3]}}
    return d


@pytest.mark.parametrize("kind", ["ply", "obj", "serialized"])
def test_shapegroup_child_file_matches_reference(tmp_path, kind):
    """A crown read from a file under a child to_world of scale 0.5 is
    the inline crown of V * 0.5, bit for bit (x * 0.5 + 0 is exact)."""
    V, F = terrain(9)
    path = write_all(tmp_path, V, F)[kind]
    d = forest_dict({"type": kind, "filename": path,
                     "to_world": {"type": "scale", "value": 0.5},
                     "bsdf": {"type": "diffuse", "reflectance": 0.4}})
    scene = load_dict(d, device="cpu")
    arrays = scene.arrays()
    ref = reference_arrays(jload_dict(d))
    for name, a in arrays.items():
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    inline = load_dict(forest_dict({
        "type": "mesh", "vertices": V * np.float32(0.5), "faces": F,
        "bsdf": {"type": "diffuse", "reflectance": 0.4}}),
        device="cpu").arrays()
    for name in ("geo.tiles_v0", "geo.tiles_e1", "geo.tiles_e2",
                 "geo.bvh_box", "geo.bvh_meta", "shape_area"):
        np.testing.assert_array_equal(arrays[name], inline[name],
                                      err_msg=name)


def test_file_forest_render_matches_reference(tmp_path):
    V, F = terrain(9)
    d = forest_dict({"type": "obj",
                     "filename": write_all(tmp_path, V, F)["obj"],
                     "to_world": {"type": "scale", "value": 0.5}})
    jscene = jload_dict(d)
    scene = load_dict(d, device="cpu")
    ref = np.asarray(jintegrators.render(jscene, seed=4))
    assert ref.mean() > 0.05
    assert_driver_equivalent(ref, integrators.render(scene, seed=4).numpy(),
                             max_flips=2)
    pool = integrators.render(scene, seed=4, regen=True,
                              samples_per_pass=200).numpy()
    assert_driver_equivalent(ref, pool, max_flips=2)
