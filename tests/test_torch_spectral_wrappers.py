"""volpathmis, the AOV wrappers, the measured BSDF and emitter rays in the
port's spectral variant (slice 6c-2) against the JAX package's on the
same seeded inputs:

- (a) an 8x8 spp 2 spectral atmosphere (16-layer grid, max_depth 4, the
  ground lowered by 1e-3: tests/test_torch_spectral_render.py's reason)
  under ``moment`` over volpathmis and under ``aov`` (depth, shading
  normal) over volpath, each on the scan driver and on a lane pool of 32
  lanes against the reference's scan film, within
  assert_driver_equivalent's budget of 1 pixel; the base channels are the
  child's (volpathmis's weight matrix over the 4 hero wavelengths,
  volpath's estimate), the AOV channels moment's second moments at the
  ray's wavelengths and aov's depth and normal;
- (b) the measured BSDF on the spectral scenes of tests/test_measured.py
  (:192, its rectangle; :274, the same fields from a tensor file; :328 is
  measured_polarized, slice 6e): eval, pdf and sample on 4,096 seeded
  directions at seeded hero wavelengths over a twosided slot and a second
  slot, within tests/test_torch_measured.py's budgets (``budget``);
- (c) sample_emitter_ray in spectral: tests/test_emitter_rays.py:142's
  area light (uniform 0.5: weight 0.5 x the range x pi x area) in a
  scene of every kind with a ray sampler and a spectrum of each kind
  (uniform, blackbody, srgb_d65, d65, regular) on the reference's arrays
  (from_numpy), the picks equal, the rays within 1e-6, the wavelengths
  and the weights within 1e-5 relative (Planck's law and D65 through
  torch's exp, an ulp from XLA's), each emitter's wavelengths drawn from
  its spectrum.

Each reference render is made once (module-scoped fixtures)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from test_measured import synth_fields
from test_torch_measured import budget, directions, interactions
from test_torch_nee_modes import one_torch_thread
from test_torch_scene import port_config, reference_arrays
from eradiate_kernel_tpu import bsdfs as jbsdfs
from eradiate_kernel_tpu import emitters as jemitters
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.core.rng import Sampler as JSampler
from eradiate_kernel_tpu.core.types import Variant as JVariant
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import tensorfile as jtensorfile
from eradiate_kernel_tpu_torch import bsdfs, emitters, integrators
from eradiate_kernel_tpu_torch.core import spectrum as sp
from eradiate_kernel_tpu_torch.core.rng import Sampler
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.scene import from_numpy, load_dict
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

__all__ = ["one_torch_thread"]  # the module's autouse fixture

SPECTRAL = Variant("spectral")
SEED, LANES = 5, 32


# ---- (a) volpathmis, moment and aov ---------------------------------------

WRAPPERS = {
    "moment over volpathmis": {"type": "moment",
                               "child": {"type": "volpathmis",
                                         "max_depth": 4}},
    "aov over volpath": {"type": "aov", "aovs": "dd:depth,nn:sh_normal",
                         "child": {"type": "volpath", "max_depth": 4}},
}


def wrapper_dict(case):
    d = atmosphere(8, 8, 2, 4, grid_res=16)
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    d["integrator"] = WRAPPERS[case]
    return d


@pytest.fixture(scope="module")
def wrapper_films():
    """The reference's scan film of each case, rendered once, and the
    port's films of each case and driver, rendered when first asked."""
    return {case: np.asarray(jintegrators.render(
        jload_dict(wrapper_dict(case), JVariant("spectral")), seed=SEED,
        develop_film=False)) for case in WRAPPERS}


_PORT = {}


def port_film(d, driver):
    """The port's raw film of scene dict ``d`` through ``driver``."""
    key = (repr(d["integrator"]), driver)
    if key not in _PORT:
        scene = load_dict(d, SPECTRAL, device="cpu")
        assert integrators.regen_supported(scene.config)
        _PORT[key] = integrators.render(
            scene, seed=SEED, develop_film=False, regen=driver == "pool",
            samples_per_pass=LANES)
    return _PORT[key]


@pytest.mark.parametrize("driver", ["scan", "pool"])
@pytest.mark.parametrize("case", list(WRAPPERS))
def test_wrapper_films_match_reference(wrapper_films, case, driver):
    film = port_film(wrapper_dict(case), driver).numpy()
    ref = wrapper_films[case]
    assert film.shape == ref.shape == (8, 8, 5 + (3 if "moment" in case
                                                  else 4))
    assert np.isfinite(film).all() and film[..., :3].mean() > 0.01
    np.testing.assert_array_equal(film[..., 4], 2)
    assert_driver_equivalent(ref, film, max_flips=1)


def test_moment_base_film_is_volpathmis():
    """moment draws nothing: its base channels are its child's film bit
    for bit, and m2 >= mean^2 in every pixel (the per-sample second
    moment of the splatted XYZ at the ray's wavelengths)."""
    child = wrapper_dict("moment over volpathmis")
    child["integrator"] = child["integrator"]["child"]
    for driver in ("scan", "pool"):
        film = port_film(wrapper_dict("moment over volpathmis"), driver)
        assert torch.equal(film[..., :5], port_film(child, driver))
        w = film[..., 4:5]
        mean = film[..., :3] / w
        assert bool((film[..., 5:] / w >= mean * mean * (1 - 1e-5)).all())


# ---- (b) the measured BSDF --------------------------------------------------

def measured_scene_dict(bsdf):
    """tests/test_measured.py:182's scene: one rectangle, a measured BSDF
    (twosided here), and a second rectangle with fields of its own."""
    return {"type": "scene",
            "sensor": {"type": "perspective",
                       "film": {"width": 2, "height": 2}},
            "rect": {"type": "rectangle",
                     "bsdf": {"type": "twosided", "inner": {
                         "type": "measured", **bsdf}}},
            "b": {"type": "rectangle", "bsdf": {
                "type": "measured", "fields": synth_fields(T=4, L=3, res=9,
                                                           seed=8)}}}


FIELDS = dict(T=6, L=16, res=32, seed=7)


def test_measured_from_file_is_the_fields_scene(tmp_path):
    """tests/test_measured.py:256's from-file scene: the tables the port
    reads from a tensor file the reference wrote are the reference's, and
    the fields scene's, bit for bit."""
    fields = synth_fields(**FIELDS)
    path = tmp_path / "synth.bsdf"
    jtensorfile.write_tensor_file(path, fields)
    d = measured_scene_dict({"filename": str(path)})
    jscene = jload_dict(d, JVariant("spectral"))
    scene = load_dict(d, SPECTRAL, device="cpu")
    inline = load_dict(measured_scene_dict({"fields": fields}), SPECTRAL,
                       device="cpu")
    assert scene.config.bsdf_static == inline.config.bsdf_static
    for k, v in scene.bsdfs["measured"].items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(jscene.bsdfs["measured"][k]), err_msg=k)
        assert torch.equal(v, inline.bsdfs["measured"][k]), k


def test_measured_eval_pdf_and_sample_match_reference():
    d = measured_scene_dict({"fields": synth_fields(**FIELDS)})
    jscene = jload_dict(d, JVariant("spectral"))
    scene = load_dict(d, SPECTRAL, device="cpu")
    n = 4096
    rng = np.random.default_rng(3)
    lam = rng.uniform(360.0, 830.0, (n, 4)).astype(np.float32)
    lam[:64] = 550.0  # tests/test_measured.py's wavelengths
    wi = directions(n, 1, upper=False)
    wo = directions(n, 2, upper=False)
    si, jsi = interactions(wi)
    si = dataclasses.replace(si, wavelengths=torch.as_tensor(lam))
    jsi = jsi.replace(wavelengths=jnp.asarray(lam))
    idx = (np.arange(n) % 2).astype(np.int32)
    act = torch.ones(n, dtype=torch.bool)
    jact = jnp.ones(n, bool)
    v, p = bsdfs.bsdf_eval_pdf(scene, torch.as_tensor(idx), si,
                               torch.as_tensor(wo), act)
    jv, jp = jbsdfs.bsdf_eval_pdf(jscene, jnp.asarray(idx), jsi,
                                  jnp.asarray(wo), jact)
    assert v.shape == (n, 4)
    budget(v, jv, "eval")
    budget(p, jp, "pdf")
    assert (v.numpy().max(-1) > 0).mean() > 0.2
    s1 = rng.random(n, dtype=np.float32)
    s2 = rng.random((n, 2), dtype=np.float32)
    bs, w = bsdfs.bsdf_sample(scene, torch.as_tensor(idx), si,
                              torch.as_tensor(s1), torch.as_tensor(s2), act)
    jbs, jw = jbsdfs.bsdf_sample(jscene, jnp.asarray(idx), jsi,
                                 jnp.asarray(s1), jnp.asarray(s2), jact)
    budget(bs.wo, jbs.wo, "sample wo", miss=0.03)
    budget(bs.pdf, jbs.pdf, "sample pdf", miss=0.03)
    budget(w, jw, "sample weight", miss=0.03)
    # each channel is read at its own wavelength: equal at one wavelength,
    # apart where the lane's wavelengths are (the rgb variants read fixed
    # ones)
    vv = v.numpy()
    np.testing.assert_array_equal(vv[:64], vv[:64, :1].repeat(4, 1))
    hit = vv[64:].max(-1) > 0
    assert (np.abs(vv[64:][hit, 0] - vv[64:][hit, 3]) > 1e-6).mean() > 0.3


# ---- (c) emitter rays -------------------------------------------------------

N_RAYS = 4096


def _rays(scene, jscene, n, seed=7):
    lane = np.arange(n, dtype=np.uint32)
    got = emitters.sample_emitter_ray(
        scene, Sampler.seed(seed, torch.as_tensor(lane.astype(np.int64))),
        torch.zeros(n))
    want = jemitters.sample_emitter_ray(
        jscene, JSampler.seed(seed, jnp.asarray(lane)), jnp.zeros(n))
    return got, want


def _both(d):
    """The reference's scene and the port's of its arrays (from_numpy:
    the same srgb coefficients and sampling tables)."""
    jscene = jload_dict(d, JVariant("spectral"))
    return (from_numpy(reference_arrays(jscene), port_config(jscene.config),
                       device="cpu"), jscene)


def test_sample_emitter_ray_matches_reference():
    d = {"type": "scene",
         "sensor": {"type": "perspective", "film": {"width": 4,
                                                    "height": 4}},
         "rect": {"type": "rectangle", "emitter": {
             "type": "area", "radiance": {"type": "uniform",
                                          "value": 0.5}}},
         "sun": {"type": "directional", "direction": [0.2, 0.1, -1.0],
                 "irradiance": {"type": "blackbody", "temperature": 5800.0}},
         "lamp": {"type": "point", "position": [0.0, 0.0, 1.0],
                  "intensity": [0.2, 0.5, 0.8]},
         "spot": {"type": "spot", "position": [0.0, 0.0, 2.0],
                  "direction": [0.0, 0.0, -1.0], "intensity": {
                      "type": "regular", "lambda_min": 500.0,
                      "lambda_max": 600.0, "values": [1.0, 3.0, 2.0]}},
         "sky": {"type": "constant", "radiance": {"type": "d65"}}}
    scene, jscene = _both(d)
    (ray, w, idx, _), (jray, jw, jidx, _) = _rays(scene, jscene, N_RAYS)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert len(np.unique(idx.numpy())) == 5
    for name, tol in (("o", 1e-6), ("d", 1e-6), ("mint", 1e-6),
                      ("wavelengths", 1e-5)):
        np.testing.assert_allclose(getattr(ray, name).numpy(),
                                   np.asarray(getattr(jray, name)),
                                   rtol=tol, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(np.isinf(ray.maxt.numpy()),
                                  np.isinf(np.asarray(jray.maxt)))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    # the spot's wavelengths come from its 500-600 nm spectrum; the area
    # light's uniform spectrum over the whole range, its weight 0.5 x the
    # range's width x pi x the rectangle's area 4 x the 5 emitters' pick
    # (tests/test_emitter_rays.py:142)
    kind = lambda k: (scene.emitter_kind[idx]
                      == scene.config.emitter_kinds.index(k)).numpy()
    spot, area = kind("spot"), kind("area")
    wl = ray.wavelengths.numpy()
    assert spot.any() and ((wl[spot] >= 500) & (wl[spot] <= 600)).all()
    assert ((wl[area] >= sp.WAVELENGTH_MIN)
            & (wl[area] <= sp.WAVELENGTH_MAX)).all()
    width = sp.WAVELENGTH_MAX - sp.WAVELENGTH_MIN
    np.testing.assert_allclose(w.numpy()[area],
                               0.5 * width * np.pi * 4.0 * 5, rtol=1e-3)
    assert (w.numpy().max(-1) > 0).mean() > 0.5
