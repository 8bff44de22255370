"""The port's Mitsuba-XML loader and writer (scene/xml.py) against the JAX
package's.

- The XML strings of tests/test_xml.py and tests/test_sensors.py
  (parameters, <default>, transforms, inline spectrum pairs, animation)
  and an <include>: the port's ``load_string`` gives scene arrays and a
  config bit-equal to the reference's (an inline spectrum's bake within
  the 6 ulps of tests/test_torch_spectra.py). An unnamed <ref> is keyed
  ``_ref_<n>`` in both, so no builder sees it: the Cornell sphere takes
  the default BSDF, not ``white`` (a behaviour of the reference).
- ``dict_to_xml`` writes the reference's text character for character
  for the Cornell box, the terrain (its mesh in a PLY file), the
  atmosphere (its grid in a .vol file) and numpy scalars, and the files
  load to the reference's arrays.
- One 8x8 render each of a surface scene and an atmosphere loaded from
  XML, against the reference's within assert_driver_equivalent's budget.
"""

import jax
import numpy as np
import pytest

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import xml as rxml
from eradiate_kernel_tpu.utils.scenes import cornell_box as jcornell_box
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.scene import load_dict, load_file, load_string
from eradiate_kernel_tpu_torch.scene import xml as pxml
from eradiate_kernel_tpu_torch.utils import meshio, volfile
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere, cornell_box
from test_torch_scene import port_config, reference_arrays, terrain_scene
from test_xml import CBOX_XML

CAMERA = """
    <sensor type="perspective">
        <film type="hdrfilm">
            <integer name="width" value="4"/>
            <integer name="height" value="4"/>
        </film>
    </sensor>"""

XML = {
    "cbox": (CBOX_XML, None),
    "cbox spp=32": (CBOX_XML, {"spp": 32}),
    "spectrum pairs": ("""<scene version="2.0.0">""" + CAMERA + """
    <emitter type="constant">
        <spectrum name="radiance" value="400:0.5, 600:1.0, 800:0.5"/>
    </emitter>
</scene>""", None),
    "transforms": ("""<scene version="2.0.0">""" + CAMERA + """
    <shape type="rectangle">
        <transform name="to_world">
            <scale value="2"/>
            <translate x="0" y="0" z="1"/>
        </transform>
    </shape>
    <shape type="disk">
        <transform name="to_world">
            <rotate x="1" y="0" z="0" angle="30"/>
            <matrix value="1 0 0 0.5 0 1 0 0 0 0 1 -1 0 0 0 1"/>
        </transform>
        <bsdf type="diffuse"><spectrum name="reflectance" value="0.3"/></bsdf>
    </shape>
    <shape type="sphere">
        <point name="center" x="0" y="1" z="0.5"/>
        <float name="radius" value="0.25"/>
        <boolean name="flip_normals" value="false"/>
    </shape>
</scene>""", None),
    "animation": ("""<scene version="2.0.0">
      <sensor type="perspective">
        <float name="fov" value="45"/>
        <animation name="to_world">
          <transform time="0">
            <translate x="0" y="0" z="-4"/>
          </transform>
          <transform time="1">
            <translate x="1" y="0" z="-4"/>
          </transform>
        </animation>
        <float name="shutter_open" value="0"/>
        <float name="shutter_close" value="1"/>
        <film type="hdrfilm">
          <integer name="width" value="4"/>
          <integer name="height" value="4"/>
        </film>
        <sampler type="independent"><integer name="sample_count" value="2"/></sampler>
      </sensor>
      <shape type="rectangle">
        <bsdf type="diffuse"/>
      </shape>
      <emitter type="constant"><spectrum name="radiance" value="0.5"/></emitter>
    </scene>""", None),
}


def assert_same_scene(port, ref):
    """Every array bit for bit but the baked spectra, which hold a measured
    spectrum's bake within tests/test_torch_spectra.py's 6 ulps (torch's
    exp is 1 ulp from XLA's), and the same config."""
    arrays, ref_arrays = port.arrays(), reference_arrays(ref)
    for name, a in arrays.items():
        b = ref_arrays[name]
        assert a.shape == b.shape, name
        if name == "spectra.baked.value":
            ulps = np.abs(a.view(np.int32).astype(np.int64)
                          - b.view(np.int32).astype(np.int64))
            assert ulps.max() <= 6, (a, b)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert port.config == port_config(ref.config)


@pytest.mark.parametrize("case", list(XML))
def test_load_string_matches_reference(case):
    text, params = XML[case]
    ref = rxml.load_string(text, parameters=params)
    scene = load_string(text, parameters=params, device="cpu")
    assert_same_scene(scene, ref)
    if params:
        assert scene.config.spp == 32
    if case == "animation":
        assert "to_world_anim" in scene.sensor


def test_include_and_defaults(tmp_path):
    """<include> reads shapes from a file relative to the scene's folder;
    a <default> applies unless a parameter overrides it."""
    (tmp_path / "parts").mkdir()
    (tmp_path / "parts" / "shapes.xml").write_text(
        """<scene version="2.0.0">
    <shape type="sphere" id="ball">
        <float name="radius" value="$radius"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.2 0.4 0.6"/>
        </bsdf>
    </shape>
</scene>""")
    text = ("""<scene version="2.0.0">
    <default name="radius" value="0.5"/>""" + CAMERA + """
    <include filename="parts/shapes.xml"/>
    <emitter type="constant"/>
</scene>""")
    path = tmp_path / "scene.xml"
    path.write_text(text)
    for params, radius in ((None, 0.5), ({"radius": "0.75"}, 0.75)):
        ref = rxml.load_file(str(path), parameters=params)
        scene = load_file(str(path), parameters=params, device="cpu")
        assert_same_scene(scene, ref)
        assert float(scene.geo.sph_radius[0]) == radius


def test_undefined_parameter_raises():
    bad = CBOX_XML.replace('<default name="spp" value="8"/>', "")
    with pytest.raises(KeyError, match="spp"):
        load_string(bad, device="cpu")


def test_unnamed_ref_is_dropped_as_in_the_reference():
    """The reference keys an unnamed <ref> ``_ref_<n>``, which no builder
    reads: CBOX_XML's sphere gets the default diffuse BSDF (0.5), not
    ``white`` (0.6). The port reproduces it; a named ref binds."""
    unnamed = load_string(CBOX_XML, device="cpu")
    named = load_string(CBOX_XML.replace('<ref id="white"/>',
                                         '<ref name="bsdf" id="white"/>'),
                        device="cpu")
    assert_same_scene(unnamed, rxml.load_string(CBOX_XML))

    def sphere_albedo(scene):
        row = int(scene.bsdf_slot[scene.shape_bsdf[0]])
        tex = int(scene.bsdfs["diffuse"]["reflectance"][row])
        spec = int(scene.textures["constant"]["spec"][scene.tex_slot[tex]])
        return scene.spectra["baked"]["value"][
            scene.spec_slot[spec]].numpy()

    np.testing.assert_allclose(sphere_albedo(unnamed), 0.5, rtol=1e-6)
    np.testing.assert_allclose(sphere_albedo(named), 0.6, rtol=1e-6)


def xml_terrain(tmp_path):
    """terrain_scene with its mesh in a PLY file."""
    d = terrain_scene(n=17, width=8, height=8, spp=2, max_depth=3)
    ply = str(tmp_path / "terrain.ply")
    meshio.write_ply(ply, d["terrain"]["vertices"], d["terrain"]["faces"])
    d["terrain"] = {"type": "ply", "filename": ply,
                    "bsdf": d["terrain"]["bsdf"]}
    return d


def xml_atmosphere(tmp_path, grid_res=(17, 16, 16), lowered=False):
    """utils.scenes.atmosphere with its grid in a .vol file (dict_to_xml
    cannot write a 3-D array) and its film typed."""
    d = atmosphere(8, 8, 4, 6, grid_res=grid_res)
    d["sensor"]["film"]["type"] = "hdrfilm"
    grid = d["atmo"]["interior"]["sigma_t"]
    path = str(tmp_path / "sigma_t.vol")
    volfile.write_vol(path, grid.pop("data"))
    grid["filename"] = path
    if lowered:  # the coplanar ground tie (ROADMAP Queue 3)
        d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    return d


DICTS = {
    "cbox": lambda tmp: cornell_box(8, 8, 4, 3),  # the port's Transform
    "terrain": xml_terrain,
    "atmosphere": xml_atmosphere,
    "numpy scalars": lambda tmp: {
        "type": "scene", "ball": {"type": "sphere",
                                  "radius": np.float32(0.5),
                                  "center": np.zeros(3, np.float32)}},
}


@pytest.mark.parametrize("case", list(DICTS))
def test_dict_to_xml_matches_reference(tmp_path, case):
    d = DICTS[case](tmp_path)
    text = pxml.dict_to_xml(d)
    # each package's own Cornell box (the sensor's to_world is each
    # package's Transform); the other dicts are plain data
    assert text == rxml.dict_to_xml(jcornell_box(8, 8, 4, 3) if case == "cbox"
                                    else d)
    if case == "numpy scalars":
        assert '<vector name="radius" value="0.5" />' in text
        return
    path = str(tmp_path / "scene.xml")
    pxml.write_file(path, d)
    with open(path) as f:
        assert f.read() == ('<?xml version="1.0" encoding="utf-8"?>\n'
                            + text + "\n")
    scene = load_file(path, device="cpu")
    assert_same_scene(scene, rxml.load_file(path))
    if case != "cbox":  # the dict's own load: files read the same
        for name, a in load_dict(d, device="cpu").arrays().items():
            np.testing.assert_array_equal(a, scene.arrays()[name],
                                          err_msg=name)


def test_dict_to_xml_refuses_arrays():
    d = atmosphere(8, 8, 4, 6, grid_res=(4, 4, 4))
    d["sensor"]["film"]["type"] = "hdrfilm"
    with pytest.raises(ValueError, match="cannot serialize"):
        pxml.dict_to_xml(d)


def test_surface_render_from_xml_matches_reference():
    text = CBOX_XML.replace('value="0.6 0.6 0.6"', 'value="0.6 0.5 0.4"')
    ref = np.asarray(jintegrators.render(rxml.load_string(text), seed=3))
    img = integrators.render(load_string(text, device="cpu"), seed=3)
    assert np.isfinite(ref).all() and ref.mean() > 0.1
    assert_driver_equivalent(ref, img.numpy(), max_flips=2)


def test_atmosphere_render_from_xml_matches_reference(tmp_path):
    """An 8x8 spp4 film of the atmosphere loaded from XML and a .vol file
    on the lane pool (64 lanes), against the reference's regen film within
    tests/test_torch_volpath.py's budget."""
    path = str(tmp_path / "atmosphere.xml")
    pxml.write_file(path, xml_atmosphere(tmp_path, lowered=True))
    run = jax.jit(jintegrators.render_wavefront_regen,
                  static_argnames=("n_lanes", "spp"))
    ref, _ = run(rxml.load_file(path), 64, 5, 4)
    scene = load_file(path, device="cpu")
    assert scene.vol_packed is not None
    film, _ = integrators.render_wavefront_regen(scene, 64, 5, 4)
    film = film.numpy()
    np.testing.assert_array_equal(film[..., 4], 4)
    assert film[..., :3].mean() > 0.05
    assert_driver_equivalent(np.asarray(ref), film, max_flips=4)
