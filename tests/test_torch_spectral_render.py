"""Spectral renders of the port against the JAX package's at the same
seeds, on both drivers (the scan driver and the lane pool), within
``assert_driver_equivalent``'s budget: the 1x1 distant atmosphere (twin:
tests/test_volpath.py:316) and an 8x8 perspective one, with the ground
lowered by 1e-3 off the cube's floor (ROADMAP Queue 3); ``bins`` and
``nbins`` over path (twins: tests/test_integrator_wrappers.py:63, :80,
:216); a surface scene of srgb reflectances, a checkerboard and a rough
conductor under a coloured sky; and, in the port alone, the envmap and
bitmap upsampling round trips (tests/test_shapes_spectra.py:189, :224)
and the spectral furnaces (tests/test_variants.py:32, :44).
"""

import math

import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from test_torch_nee_modes import one_torch_thread
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.core.types import Variant as JVariant
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils.scenes import atmosphere as jatmosphere
from eradiate_kernel_tpu_torch import emitters, integrators
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.render.texture import texture_eval
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils.rgb2spec import _LAM, _projection
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

__all__ = ["one_torch_thread"]  # the module's autouse fixture

SPECTRAL = Variant("spectral")


def _films(jd, d, seed, lanes, mode="spectral", aovs=False):
    """(reference film, scan film, pool film) of one scene, raw."""
    jscene = jload_dict(jd, JVariant(mode))
    scene = load_dict(d, Variant(mode), device="cpu")
    ref = np.asarray(jintegrators.render(jscene, seed=seed,
                                         develop_film=False))
    scan = integrators.render(scene, seed=seed, develop_film=False).numpy()
    pool = integrators.render(scene, seed=seed, develop_film=False,
                              regen=True, samples_per_pass=lanes).numpy()
    return ref, scan, pool, scene


def _lowered(fn, *a, **kw):
    d = fn(*a, **kw)
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    return d


@pytest.mark.parametrize("sensor", ["distant", "perspective"])
def test_spectral_atmosphere_matches_reference(sensor):
    kw = dict(spp=64 if sensor == "distant" else 2, max_depth=8,
              grid_res=16, sensor=sensor)
    ref, scan, pool, scene = _films(_lowered(jatmosphere, 8, 8, **kw),
                                    _lowered(atmosphere, 8, 8, **kw),
                                    seed=5, lanes=32)
    assert scene.config.variant.is_spectral and ref.max() > 0
    assert_driver_equivalent(ref, scan, max_flips=1)
    assert_driver_equivalent(ref, pool, max_flips=1)


def _wrapper_scene(integrator, spp, w):
    """tests/test_integrator_wrappers.py's scene_dict."""
    return {
        "type": "scene", "integrator": integrator,
        "sensor": {"type": "perspective",
                   "to_world": {"type": "look_at", "origin": [0, 0, -4],
                                "target": [0, 0, 0], "up": [0, 1, 0]},
                   "film": {"width": w, "height": w,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "sphere": {"type": "sphere", "radius": 1.0,
                   "bsdf": {"type": "diffuse", "reflectance": 0.5}},
        "env": {"type": "constant", "radiance": 1.0},
    }


@pytest.mark.parametrize("kind", ["bins", "nbins"])
def test_bins_match_reference_on_both_drivers(kind):
    """The base film and the bin columns of both drivers against the
    reference's scan film; the base film is the child's alone."""
    spec = ({"type": "bins", "bins": "lo:400:550,hi:550:700"}
            if kind == "bins" else
            {"type": "nbins", "bins": "l550:550,l650:650", "tolerance": 25.0})
    d = _wrapper_scene({**spec, "child": {"type": "path", "max_depth": 3}},
                       spp=8, w=8)
    ref, scan, pool, scene = _films(d, d, seed=7, lanes=128)
    assert ref.shape == scan.shape == (8, 8, 7)
    assert integrators.aov_names(scene.config) == (
        ["lo", "hi"] if kind == "bins" else ["l550", "l650"])
    assert_driver_equivalent(ref, scan)
    assert_driver_equivalent(ref, pool)
    np.testing.assert_array_equal(scan[..., :5], _child_film(d))


_CHILD = {}


def _child_film(d):
    """The port's scan film of the wrapper scene's child alone (path over
    the same scene, seed 7; the same for bins and nbins, rendered once)."""
    if "film" not in _CHILD:
        base = dict(d, integrator={"type": "path", "max_depth": 3})
        _CHILD["film"] = integrators.render(
            load_dict(base, SPECTRAL, device="cpu"), seed=7,
            develop_film=False).numpy()
    return _CHILD["film"]


def test_bins_partition_and_nbins_line():
    """Bins partitioning the sampled 360-830 nm range sum to the flat
    sky's integral 470, and a narrow bin reads its width (twins:
    tests/test_integrator_wrappers.py:63, :80)."""
    d = _wrapper_scene({"type": "bins", "bins": "lo:360:600,hi:600:830",
                        "child": {"type": "path", "max_depth": 2}},
                       spp=128, w=4)
    del d["sphere"]
    _img, aovs = integrators.render(load_dict(d, SPECTRAL, device="cpu"),
                                    seed=2, return_aovs=True, regen=True)
    total = (aovs["lo"] + aovs["hi"]).numpy()
    assert total[0, 0] == pytest.approx(470.0, rel=0.02)
    assert float(aovs["lo"][0, 0]) == pytest.approx(240.0, rel=0.05)
    d["integrator"] = {"type": "nbins", "bins": "l550:550", "tolerance": 25.0,
                       "child": {"type": "path", "max_depth": 2}}
    d["sensor"]["sampler"]["sample_count"] = 256
    _img, aovs = integrators.render(load_dict(d, SPECTRAL, device="cpu"),
                                    seed=3, return_aovs=True)
    assert float(aovs["l550"][0, 0]) == pytest.approx(50.0, rel=0.15)


def _surface_scene():
    """Coloured reflectances (srgb), a checkerboard, a rough and a smooth
    conductor (eta and k given as rgb triples: their mean, uniform) under
    an rgb sky and a blackbody sun."""
    return {
        "type": "scene", "integrator": {"type": "path", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 50.0,
                   "to_world": {"type": "look_at", "origin": [0, 1.5, -4],
                                "target": [0, 0, 0], "up": [0, 1, 0]},
                   "film": {"width": 8, "height": 8,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 4}},
        "floor": {"type": "rectangle",
                  "to_world": [{"type": "rotate", "axis": [1, 0, 0],
                                "angle": -90},
                               {"type": "scale", "value": 3.0},
                               {"type": "translate",
                                "value": [0.013, -1.0, 0.021]}],
                  "bsdf": {"type": "diffuse", "reflectance": {
                      "type": "checkerboard", "color0": [0.7, 0.2, 0.1],
                      "color1": [0.1, 0.3, 0.8]}}},
        "ball": {"type": "sphere", "center": [-0.7, 0.0, 0.0], "radius": 0.6,
                 "bsdf": {"type": "roughconductor", "alpha": 0.3,
                          "eta": [0.2, 0.9, 1.1], "k": [3.9, 2.4, 2.2]}},
        "mirror": {"type": "sphere", "center": [0.8, 0.0, 0.3],
                   "radius": 0.5,
                   "bsdf": {"type": "conductor", "material": "Au"}},
        "box": {"type": "sphere", "center": [0.0, -0.5, -1.2],
                "radius": 0.4,
                "bsdf": {"type": "diffuse",
                         "reflectance": {"type": "rgb",
                                         "value": [0.2, 0.8, 0.3]}}},
        "sky": {"type": "constant",
                "radiance": {"type": "rgb", "value": [0.5, 0.7, 1.0]}},
        "sun": {"type": "directional", "direction": [0.3, -1.0, 0.5],
                "irradiance": {"type": "blackbody", "temperature": 5800.0,
                               "scale": 1e-5}},
    }


def test_spectral_surface_scene_matches_reference():
    d = _surface_scene()
    ref, scan, pool, scene = _films(d, d, seed=3, lanes=64)
    kinds = set(scene.config.spectrum_kinds)
    assert {"srgb", "srgb_d65", "uniform", "blackbody"} <= kinds
    assert ref[..., 1].max() > 0.05
    # the srgb coefficients are the fit's (rtol 1e-5 of the reference's):
    # radiance within 1e-4 relative
    assert_driver_equivalent(ref, scan, max_flips=1)
    assert_driver_equivalent(ref, pool, max_flips=1)


def test_spectral_envmap_upsampling_roundtrip():
    """Envmap texels upsample to spectra whose CIE/D65 projection gives
    back the texel rgb (envmap.cpp:69-89; twin
    tests/test_shapes_spectra.py:189)."""
    rng = np.random.default_rng(0)
    env = (0.1 + 0.8 * rng.random((8, 16, 3))).astype(np.float32)
    scene = load_dict({"type": "scene",
                       "sensor": {"type": "perspective",
                                  "film": {"width": 2, "height": 2}},
                       "sky": {"type": "envmap", "data": env}},
                      SPECTRAL, device="cpu")
    texels = [(2, 3), (2, 10), (5, 3), (5, 10)]
    d = torch.tensor([[math.sin(y / 7 * math.pi)
                       * math.sin(x / 16 * 2 * math.pi),
                       math.cos(y / 7 * math.pi),
                       -math.sin(y / 7 * math.pi)
                       * math.cos(x / 16 * 2 * math.pi)]
                      for y, x in texels], dtype=torch.float32)
    wl = torch.as_tensor(_LAM, dtype=torch.float32).expand(4, len(_LAM))
    spec = emitters.envmap_eval(scene, scene.emitters["envmap"],
                                torch.zeros(4, dtype=torch.int64), d, wl,
                                torch.ones(4, dtype=torch.bool)).numpy()
    back = spec @ _projection().T
    expect = np.stack([env[y, x] for y, x in texels])
    assert np.abs(back - expect).max() < 1e-3


def test_spectral_bitmap_upsampling_roundtrip():
    """Bitmap texels likewise (twin: tests/test_shapes_spectra.py:224)."""
    rng = np.random.default_rng(1)
    img = (0.05 + 0.9 * rng.random((6, 6, 3))).astype(np.float32)
    scene = load_dict({"type": "scene",
                       "sensor": {"type": "perspective",
                                  "film": {"width": 2, "height": 2}},
                       "r": {"type": "rectangle",
                             "bsdf": {"type": "diffuse", "reflectance": {
                                 "type": "bitmap", "data": img}}}},
                      SPECTRAL, device="cpu")
    kinds = scene.config.texture_kinds
    bi = [i for i, k in enumerate(scene.tex_kind.tolist())
          if kinds[k] == "bitmap"][0]
    uv = torch.tensor([[3 / 5, 2 / 5]])  # texel (2, 3)
    wl = torch.as_tensor(_LAM, dtype=torch.float32)[None]
    val = texture_eval(scene, torch.full((1,), bi), uv,
                       wavelengths=wl).numpy()
    back = val @ _projection().T
    assert np.abs(back[0] - img[2, 3]).max() < 1e-3


def _furnace(integrator, albedo=0.6, depth=16):
    """tests/test_variants.py's furnace."""
    return {"type": "scene",
            "integrator": {"type": integrator, "max_depth": depth,
                           "rr_depth": 1000},
            "sensor": {"type": "perspective",
                       "to_world": {"type": "look_at",
                                    "origin": [0, 0, -4],
                                    "target": [0, 0, 0], "up": [0, 1, 0]},
                       "film": {"width": 8, "height": 8,
                                "rfilter": {"type": "box"}},
                       "sampler": {"sample_count": 128}},
            "sphere": {"type": "sphere", "radius": 1.0,
                       "bsdf": {"type": "diffuse", "reflectance": albedo}},
            "env": {"type": "constant", "radiance": 1.0}}


@pytest.mark.parametrize("integrator", ["path", "volpath"])
def test_spectral_furnace(integrator):
    """A convex diffuse sphere of albedo 0.6 under a unit sky reads 0.6,
    the sky 1 (twin: tests/test_variants.py:32, at its spectral
    tolerance)."""
    scene = load_dict(_furnace(integrator), SPECTRAL, device="cpu")
    img = integrators.render(scene, seed=5, regen=True,
                             samples_per_pass=2048).numpy()
    assert np.isfinite(img).all()
    assert img[3:5, 3:5].mean() == pytest.approx(0.6, abs=0.05)
    assert img[0, 0].mean() == pytest.approx(1.0, abs=0.05)


def test_spectral_volumetric_furnace():
    """An absorbing slab transmits exp(-2 sigma_t) (twin:
    tests/test_variants.py:44)."""
    scene = load_dict({
        "type": "scene", "integrator": {"type": "volpath", "max_depth": 16},
        "sensor": {"type": "radiancemeter",
                   "to_world": {"type": "look_at", "origin": [0, 0, -3],
                                "target": [0, 0, 1], "up": [0, 1, 0]},
                   "film": {"width": 1, "height": 1,
                            "rfilter": {"type": "box"}},
                   "sampler": {"sample_count": 4096}},
        "slab": {"type": "cube", "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous", "sigma_t": 0.7,
                              "albedo": 0.0}},
        "env": {"type": "constant", "radiance": 1.0}}, SPECTRAL,
        device="cpu")
    img = integrators.render(scene, seed=3, regen=True,
                             samples_per_pass=4096).numpy()
    assert img[0, 0].mean() == pytest.approx(np.exp(-1.4), rel=0.08)
