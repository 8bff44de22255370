"""The port's AOV wrappers (integrators/aov.py, integrators/moment.py,
``render(return_aovs=True)``) and ray differentials against the JAX
package's on the same inputs:

- ``parse_aovs``, ``aov_names`` and ``n_aov`` on the spec strings of
  tests/test_integrator_wrappers.py and on all nine types: equal;
- ``sensors.sample_ray_differential`` from the same sampler state for the
  perspective and thin-lens sensors: rays, differentials and weights
  within 1e-6 (origins scaled by the bounding sphere), samplers equal;
- ``compute_uv_partials`` of a rectangle's hits within 1e-6 (and zeros on
  degenerate tangents, as in the reference);
- ``render(return_aovs=True)`` of ``aov`` (all nine types) over ``path``
  on a 16x16 terrain(33), scan driver, and of the seven types without the
  uv partials on the lane pool: the image and every AOV channel within
  assert_driver_equivalent's tolerance (1e-4 of max(|value|, 1) a pixel,
  no flips), the AOV dict's names equal to the reference's;
- ``moment`` over ``path`` and over ``volpath`` on both drivers, the same;
- an XML ``<integrator type="aov">`` with a nested ``volpath``: the same
  config as the reference's, and its film on both drivers.

Each reference render is made once (module-scoped fixtures)."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu import sensors as jsensors
from eradiate_kernel_tpu.core.rng import Sampler as JSampler
from eradiate_kernel_tpu.integrators import aov as jaov
from eradiate_kernel_tpu.render import geometry as jgeometry
from eradiate_kernel_tpu.render import records as jrecords
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.scene import xml as rxml
from eradiate_kernel_tpu_torch import integrators, sensors
from eradiate_kernel_tpu_torch.core.rng import Sampler
from eradiate_kernel_tpu_torch.integrators import aov
from eradiate_kernel_tpu_torch.render import geometry, records
from eradiate_kernel_tpu_torch.scene import load_dict, load_string
from test_integrator_wrappers import scene_dict
from test_torch_scene import port_config, terrain_scene
from test_torch_sensors import SAMPLE_CASES, SHAPES, both, env_dict

ALL_NINE = ("dd:depth,pp:position,uv:uv,nn:geo_normal,sn:sh_normal,"
            "pi:prim_index,si:shape_index,d1:duv_dx,d2:duv_dy")
NO_DUV = ("dd:depth,pp:position,uv:uv,nn:geo_normal,sn:sh_normal,"
          "pi:prim_index,si:shape_index")
SPECS = ["dd:depth,nn:sh_normal", "d1:duv_dx,d2:duv_dy",
         "dd:depth,nn:geo_normal,pp:position", "dd:depth", ALL_NINE, ""]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (tests/test_torch_sensors.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec", SPECS)
def test_aov_spec_parsing_matches_reference(spec):
    cfg = types.SimpleNamespace(
        integrator=types.SimpleNamespace(extra=(("aovs", spec),)))
    assert aov.parse_aovs(cfg) == jaov.parse_aovs(cfg)
    assert aov.aov_names(cfg) == jaov.aov_names(cfg)
    assert aov.n_aov(cfg) == jaov.n_aov(cfg)
    assert aov.needs_differentials(cfg) == jaov.needs_differentials(cfg)


@pytest.mark.parametrize("case", ["perspective", "thinlens"])
def test_sample_ray_differential_matches_reference(case):
    jscene, scene = both(env_dict(SAMPLE_CASES[case], extra=SHAPES))
    n = 256
    pos = np.random.default_rng(11).random((n, 2)).astype(np.float32)
    jsmp, _ = JSampler.seed(5, jnp.arange(n, dtype=jnp.uint32)).next_2d()
    smp, _ = Sampler.seed(5, torch.arange(n)).next_2d()
    jray, jrd, jw, jsmp = jsensors.sample_ray_differential(
        jscene, jsmp, jnp.asarray(pos), jnp.zeros(n), diff_scale=0.5)
    ray, rd, w, smp = sensors.sample_ray_differential(
        scene, smp, torch.as_tensor(pos), torch.zeros(n), diff_scale=0.5)
    r = float(scene.bsphere_radius) + 1.0
    for name, a, b, tol in (("o", ray.o, jray.o, 1e-6 * r),
                            ("d", ray.d, jray.d, 1e-6),
                            ("o_x", rd.o_x, jrd.o_x, 1e-6 * r),
                            ("d_x", rd.d_x, jrd.d_x, 1e-6),
                            ("o_y", rd.o_y, jrd.o_y, 1e-6 * r),
                            ("d_y", rd.d_y, jrd.d_y, 1e-6),
                            ("weight", w, jw, 1e-6)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   err_msg=name)
    # the offset rays differ from the main one (the thin lens keeps its
    # aperture draw: the same lens point for all three)
    assert float((rd.d_x - ray.d).abs().max()) > 1e-4
    assert smp.dim == int(np.asarray(jsmp.dim)[0])


def test_uv_partials_match_reference():
    """tests/test_integrator_wrappers.py::test_uv_partials_match_offset_hits's
    rectangle, its hits and differentials in both packages."""
    d = {"type": "scene",
         "sensor": {"type": "perspective",
                    "to_world": {"type": "look_at", "origin": [0.2, -0.3, -4],
                                 "target": [0, 0, 0], "up": [0, 1, 0]},
                    "film": {"width": 16, "height": 16}},
         "rect": {"type": "rectangle",
                  "to_world": {"type": "scale", "value": [3, 3, 1]},
                  "bsdf": {"type": "diffuse"}}}
    jscene, scene = both(d)
    pos = np.random.default_rng(2).uniform(0.2, 0.8, (64, 2)).astype(
        np.float32)
    n = pos.shape[0]
    jsmp = JSampler.seed(jnp.uint32(3), jnp.arange(n, dtype=jnp.uint32))
    smp = Sampler.seed(3, torch.arange(n))
    jray, jrd, _, _ = jsensors.sample_ray_differential(
        jscene, jsmp, jnp.asarray(pos), jnp.zeros(n), diff_scale=1.0)
    ray, rd, _, _ = sensors.sample_ray_differential(
        scene, smp, torch.as_tensor(pos), torch.zeros(n), diff_scale=1.0)
    jsi = jgeometry.ray_intersect(jscene.geo, jray)
    si = geometry.ray_intersect(scene.geo, ray)
    assert bool(si.is_valid.all())
    jdx, jdy = jrecords.compute_uv_partials(jsi, jrd)
    dx, dy = records.compute_uv_partials(si, rd)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-6)
    np.testing.assert_allclose(dy.numpy(), np.asarray(jdy), atol=1e-6)
    assert float(dx.abs().max()) > 1e-3
    # degenerate dp_du / dp_dv: zeros, not NaN
    si0 = dataclasses.replace(si, dp_du=torch.zeros_like(si.dp_du),
                              dp_dv=torch.zeros_like(si.dp_dv))
    z_dx, z_dy = records.compute_uv_partials(si0, rd)
    assert bool((z_dx == 0).all()) and bool((z_dy == 0).all())


def _terrain_aov(spec):
    d = terrain_scene(n=33, width=16, height=16, spp=4, max_depth=3)
    d["integrator"] = {"type": "aov", "aovs": spec,
                       "child": {"type": "path", "max_depth": 3}}
    return d


def _sphere(integrator):
    return scene_dict(integrator, spp=4)


CASES = {
    # name: (scene dict, drivers)
    "aov nine types over path, terrain(33)": (_terrain_aov(ALL_NINE),
                                              ("scan",)),
    "aov seven types over path, terrain(33)": (_terrain_aov(NO_DUV),
                                               ("scan", "pool")),
    "moment over path": (_sphere({"type": "moment", "child": {
        "type": "path", "max_depth": 3}}), ("scan", "pool")),
    "moment over volpath": (_sphere({"type": "moment", "child": {
        "type": "volpath", "max_depth": 3}}), ("scan", "pool")),
}
PARAMS = [(name, drv) for name, (_d, drivers) in CASES.items()
          for drv in drivers]
_REF = {}


def reference(name, driver):
    """The reference's (image, aovs) of a case and driver, rendered once."""
    key = (name, driver)
    if key not in _REF:
        jscene = jload_dict(CASES[name][0])
        img, aovs = jintegrators.render(jscene, seed=3, return_aovs=True,
                                        regen=driver == "pool",
                                        samples_per_pass=256)
        _REF[key] = (np.asarray(img), {k: np.asarray(v)
                                       for k, v in aovs.items()})
    return _REF[key]


def _compare(ref, got):
    img_r, aovs_r = ref
    img, aovs = got
    assert list(aovs) == list(aovs_r)
    assert_driver_equivalent(img_r, img.numpy(), max_flips=0)
    for k, v in aovs_r.items():
        assert aovs[k].shape == v.shape, k
        assert_driver_equivalent(v[..., None], aovs[k].numpy()[..., None],
                                 max_flips=0)
    return aovs


@pytest.mark.parametrize("name,driver", PARAMS)
def test_render_return_aovs_matches_reference(name, driver):
    scene = load_dict(CASES[name][0], device="cpu")
    if driver == "pool":
        assert integrators.regen_supported(scene.config)
    got = integrators.render(scene, seed=3, return_aovs=True,
                             regen=driver == "pool", samples_per_pass=256)
    aovs = _compare(reference(name, driver), got)
    if name.startswith("aov"):
        hit = aovs["si"] >= 0
        assert bool(hit.any()) and bool((aovs["dd"][hit] > 0).all())
    if "nine" in name:  # the uv partials on the hit pixels
        assert float(aovs["d1.x"].abs().max()) > 0
        assert integrators.regen_supported(scene.config) is False
    if name.startswith("moment"):
        film = integrators.render(scene, seed=3, develop_film=False,
                                  regen=driver == "pool",
                                  samples_per_pass=256)
        mean_y = film[..., 1] / film[..., 4]
        assert bool((aovs["m2.y"] >= mean_y ** 2 - 1e-6).all())


AOV_XML = """<scene version="3.0.0">
  <integrator type="aov">
    <string name="aovs" value="dd:depth,nn:geo_normal"/>
    <integrator type="volpath" name="inner">
      <integer name="max_depth" value="3"/>
      <integer name="rr_depth" value="2"/>
      <integer name="nee_steps" value="6"/>
    </integrator>
  </integrator>
  <sensor type="perspective">
    <transform name="to_world">
      <lookat origin="0, 0, -4" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="8"/>
      <integer name="height" value="8"/>
      <rfilter type="box"/>
    </film>
    <sampler type="independent">
      <integer name="sample_count" value="4"/>
    </sampler>
  </sensor>
  <shape type="sphere">
    <float name="radius" value="1"/>
    <bsdf type="diffuse"/>
  </shape>
  <emitter type="constant"/>
</scene>"""


def test_xml_aov_over_volpath_matches_reference():
    ref = rxml.load_string(AOV_XML)
    scene = load_string(AOV_XML, device="cpu")
    assert scene.config == port_config(ref.config)
    extra = dict(scene.config.integrator.extra)
    assert extra["child"] == "volpath" and extra["nee_steps"] == 6
    assert scene.config.integrator.max_depth == 3
    for regen in (False, True):
        jimg, jaovs = jintegrators.render(ref, seed=1, return_aovs=True,
                                          regen=regen)
        _compare((np.asarray(jimg), {k: np.asarray(v)
                                     for k, v in jaovs.items()}),
                 integrators.render(scene, seed=1, return_aovs=True,
                                    regen=regen))


def test_duv_aovs_keep_the_scan_driver():
    """regen=True of a duv spec renders through the scan driver, as in the
    reference (regen_supported is False for it)."""
    scene = load_dict(_terrain_aov("d1:duv_dx"), device="cpu")
    assert not integrators.regen_supported(scene.config)
    a = integrators.render(scene, seed=2, develop_film=False)
    b = integrators.render(scene, seed=2, develop_film=False, regen=True)
    assert a.shape == (16, 16, 7)
    assert torch.equal(a, b)
