"""The port's polarized transport (integrators/stokes.py, polarized.py,
polarized_vol.py) against the JAX package's:

- (a) every test of tests/test_polarization.py, run on the port with its
  tolerances: the Mueller closed forms, Malus's law and the wave plates
  through the stokes integrator on a 1x1 optical bench, polarization by a
  gold mirror and by glass, depolarization by a diffuse wall, the Mueller
  volpath's S0 against volpath's sample for sample (rtol 1e-5) under an
  isotropic phase, Rayleigh polarization, and the lane pool against the
  scan driver (assert_driver_equivalent);
- (b) films (S0 in X, Y, Z and the S1..S3 sums) on both drivers against
  the reference's scan film within tests/conftest.py::
  assert_driver_equivalent's budget: stokes(volpath) over a Rayleigh
  atmosphere (6x6 spp 8, max_depth 6; its ground lowered by 1e-3,
  ROADMAP Queue 3) within 1 pixel, and stokes(path) over a surface scene
  of gold, glass, rough copper, a polarizer and pplastic (8x8 spp 4,
  max_depth 4) within 2; and one small case each in mono and spectral
  (4 hero wavelengths; scan and pool: tests/test_polarization.py:133's
  gold mirror) and rgb_double (the scan driver only, tol 1e-7 against
  the reference's x64 film: the optical bench);
- (c) load_dict and the XML round trip of a scene with the five
  polarized BSDFs under stokes, leaf for leaf, and the lane pool's
  modelled traffic of a polarized state.

The reference renders in four subprocesses (x64 is a process-global
JAX flag), started with the module and read at the first need; the
port's own tests run meanwhile."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.scene import xml as rxml
from eradiate_kernel_tpu.utils import tensorfile as jtensorfile
from eradiate_kernel_tpu_torch import bsdfs, integrators, phase
from eradiate_kernel_tpu_torch.core import mueller as mu
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.integrators import polarized_vol, volpath
from eradiate_kernel_tpu_torch.render.geometry import ray_intersect
from eradiate_kernel_tpu_torch.scene import load_dict, load_file
from eradiate_kernel_tpu_torch.scene import xml as pxml
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere
from test_measured import synth_pbsdf
from test_torch_xml import assert_same_scene

T = torch.as_tensor
LANES = 64


# ---- the scenes -----------------------------------------------------------------

def bench_dict(elements, spp=64):
    """The optical bench of tests/test_polarization.py: env light ->
    element stack -> radiancemeter, along +z."""
    d = {
        "type": "scene",
        "integrator": {"type": "stokes",
                       "child": {"type": "path", "max_depth": 2}},
        "sensor": {"type": "radiancemeter",
                   "to_world": {"type": "look_at", "origin": [0, 0, -4],
                                "target": [0, 0, 1], "up": [0, 1, 0]},
                   "film": {"width": 1, "height": 1,
                            "rfilter": {"type": "box"}},
                   "sampler": {"sample_count": spp}},
        "env": {"type": "constant", "radiance": 1.0},
    }
    for i, el in enumerate(elements):
        d[f"el{i}"] = {"type": "rectangle",
                       "to_world": {"type": "translate",
                                    "value": [0, 0, -3.0 + i]},
                       "bsdf": dict(el)}
    return d


def bench(elements, spp=64, variant="rgb"):
    return load_dict(bench_dict(elements, spp), Variant(variant),
                     device="cpu")


def meter(spp, **objects):
    """A 1x1 radiancemeter along +z under stokes(path, max_depth 3)."""
    return load_dict(dict({
        "type": "scene",
        "integrator": {"type": "stokes",
                       "child": {"type": "path", "max_depth": 3}},
        "sensor": {"type": "radiancemeter",
                   "to_world": {"type": "look_at", "origin": [0, 0, -4],
                                "target": [0, 0, 1], "up": [0, 1, 0]},
                   "film": {"width": 1, "height": 1,
                            "rfilter": {"type": "box"}},
                   "sampler": {"sample_count": spp}}}, **objects),
        device="cpu")


TILTED = {"type": "look_at", "origin": [0, 0, 0], "target": [0, 1, -1],
          "up": [0, 1, 1]}
SIDE_LIGHT = {"type": "rectangle",
              "to_world": {"type": "look_at", "origin": [0, 40, 0],
                           "target": [0, 0, 0], "up": [1, 0, 0]},
              "emitter": {"type": "area", "radiance": 10.0}}


def rayleigh_dict(width=6, spp=8, phase_dict=None, integrator=None):
    """The Rayleigh atmosphere of tests/test_polarization.py (:217, :297),
    its ground lowered by 1e-3."""
    return {
        "type": "scene",
        "integrator": integrator or {
            "type": "stokes", "child": {"type": "volpath", "max_depth": 6}},
        "sensor": {"type": "perspective", "fov": 60.0,
                   "to_world": {"type": "look_at",
                                "origin": [0.5, 0.5, 3.0],
                                "target": [0.5, 0.5, 0.0], "up": [0, 1, 0]},
                   "film": {"width": width, "height": width,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "surface": {"type": "rectangle",
                    "to_world": [{"type": "scale", "value": 20.0},
                                 {"type": "translate",
                                  "value": [0.5, 0.5, -1e-3]}],
                    "bsdf": {"type": "diffuse", "reflectance": 0.4}},
        "atmo": {"type": "cube",
                 "to_world": [{"type": "scale", "value": [20.0, 20.0, 0.5]},
                              {"type": "translate",
                               "value": [0.5, 0.5, 0.5]}],
                 "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous", "sigma_t": 0.6,
                              "albedo": 0.9,
                              "phase": phase_dict or {"type": "rayleigh"}}},
        "sun": {"type": "directional", "direction": [1.0, 0.0, -0.2],
                "irradiance": 5.0},
    }


def surface_dict(width=8, spp=4, max_depth=4):
    """A pplastic ground with a gold, a glass and a rough copper sphere, a
    polarizer across part of the view, a sun and a sky."""
    sphere = lambda x, bsdf: {"type": "sphere", "radius": 0.35,
                              "center": [x, 0.0, 0.35], "bsdf": bsdf}
    return {
        "type": "scene",
        "integrator": {"type": "stokes",
                       "child": {"type": "path", "max_depth": max_depth}},
        "sensor": {"type": "perspective", "fov": 50.0,
                   "to_world": {"type": "look_at", "origin": [0, -3, 1.6],
                                "target": [0, 0, 0.3], "up": [0, 0, 1]},
                   "film": {"width": width, "height": width,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "ground": {"type": "rectangle",
                   "to_world": {"type": "scale", "value": [3.0, 3.0, 1.0]},
                   "bsdf": {"type": "pplastic", "alpha": 0.2,
                            "diffuse_reflectance": [0.3, 0.4, 0.5]}},
        "gold": sphere(-0.8, {"type": "conductor", "material": "au"}),
        "glass": sphere(0.0, {"type": "dielectric", "int_ior": 1.5}),
        "copper": sphere(0.8, {"type": "roughconductor", "material": "cu",
                               "alpha": 0.3}),
        "filter": {"type": "rectangle",
                   "to_world": [{"type": "scale", "value": [0.4, 0.4, 1.0]},
                                {"type": "rotate", "axis": [1, 0, 0],
                                 "angle": 60.0},
                                {"type": "translate",
                                 "value": [0.4, -1.5, 0.9]}],
                   "bsdf": {"type": "polarizer", "theta": 20.0}},
        "sun": {"type": "directional", "direction": [0.4, 0.3, -0.85],
                "irradiance": 3.0},
        "sky": {"type": "constant", "radiance": 0.3},
    }


def gold_meter_dict(spp=32):
    """tests/test_polarization.py:133's gold mirror at 45 degrees toward
    an area light, through a 1x1 radiancemeter."""
    return {
        "type": "scene",
        "integrator": {"type": "stokes",
                       "child": {"type": "path", "max_depth": 3}},
        "sensor": {"type": "radiancemeter",
                   "to_world": {"type": "look_at", "origin": [0, 0, -4],
                                "target": [0, 0, 1], "up": [0, 1, 0]},
                   "film": {"width": 1, "height": 1,
                            "rfilter": {"type": "box"}},
                   "sampler": {"sample_count": spp}},
        "mirror": {"type": "rectangle", "to_world": TILTED,
                   "bsdf": {"type": "conductor", "material": "au"}},
        "light": SIDE_LIGHT}


# the reference's films by subprocess: name -> (scene dict, variant, seed)
CASES = {
    "volpath": {"volpath": (rayleigh_dict(), "rgb", 3)},
    "path": {"path": (surface_dict(), "rgb", 4)},
    "variants": {"mono": (gold_meter_dict(), "mono", 5),
                 "spectral": (gold_meter_dict(), "spectral", 6)},
    "x64": {"rgb_double": (bench_dict([
        {"type": "polarizer", "theta": 30.0},
        {"type": "retarder", "theta": 15.0, "delta": 90.0}], spp=32),
        "rgb_double", 7)},
}

_SCRIPT = r"""
import pickle
import sys
import jax
jax.config.update("jax_platforms", "cpu")
if sys.argv[3] == "x64":
    jax.config.update("jax_enable_x64", True)
import numpy as np
from eradiate_kernel_tpu import integrators
from eradiate_kernel_tpu.core.types import Variant
from eradiate_kernel_tpu.scene import load_dict

with open(sys.argv[2], "rb") as f:
    cases = pickle.load(f)[sys.argv[3]]
out = {}
for name, (d, variant, seed) in cases.items():
    scene = load_dict(d, Variant(variant, polarized=True))
    out[name] = np.asarray(integrators.render(scene, seed=seed,
                                              develop_film=False))
np.savez(sys.argv[1], **out)
"""


class _Reference:
    """The reference's films, one subprocess a group (the Rayleigh
    atmosphere, the surface scene, the mono and spectral mirror, the x64
    bench) side by side."""

    def __init__(self, tmp):
        with open(tmp / "cases.pkl", "wb") as f:
            pickle.dump(CASES, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        self.procs = {}
        for group in CASES:
            path = str(tmp / f"{group}.npz")
            self.procs[group] = (path, subprocess.Popen(
                [sys.executable, "-c", _SCRIPT, path, str(tmp / "cases.pkl"),
                 group], env=env, cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        self.films = {}

    def __getitem__(self, name):
        group = next(g for g, c in CASES.items() if name in c)
        if group not in self.films:
            path, proc = self.procs[group]
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, out[-2000:] + err[-3000:]
            self.films[group] = dict(np.load(path))
        return self.films[group][name]

    def stop(self):
        for _path, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """The reference's films, with one torch thread for the module
    meanwhile (tests/test_torch_sensors.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    reference = _Reference(tmp_path_factory.mktemp("polarized"))
    yield reference
    reference.stop()
    torch.set_num_threads(n)


def aovs_of(film):
    """The S1..S3 channels, weight-normalised."""
    return film[..., 5:8] / np.maximum(film[..., 4:5], 1e-12)


# ---- (a) tests/test_polarization.py on the port ------------------------------

def test_polarizer_on_unpolarized():
    out = mu.linear_polarizer(1.0) @ T(np.float32([1.0, 0, 0, 0]))
    np.testing.assert_allclose(out, [0.5, 0.5, 0, 0], atol=1e-7)


def test_malus_matrices():
    """Two polarizers at relative angle theta pass I0 / 2 cos^2 theta."""
    s = T(np.float32([1.0, 0, 0, 0]))
    for theta in (0.0, np.pi / 6, np.pi / 4, np.pi / 3, np.pi / 2):
        m2 = mu.rotated_element(T(np.float32(theta)), mu.linear_polarizer(1.0))
        out = m2 @ (mu.linear_polarizer(1.0) @ s)
        assert float(out[0]) == pytest.approx(0.5 * np.cos(theta) ** 2,
                                              abs=1e-6), theta


def test_quarter_wave_plate_makes_circular():
    out = mu.linear_retarder(T(np.float32(np.pi / 2))) @ T(
        np.float32([1.0, 0, 1.0, 0]))
    assert abs(float(out[3])) == pytest.approx(1.0, abs=1e-6)
    assert float(out[1]) == pytest.approx(0.0, abs=1e-6)


def test_specular_reflection_brewster():
    """At Brewster's angle the reflected light is fully s-polarized."""
    m = mu.specular_reflection(T(np.float32([np.cos(np.arctan(1.5))])),
                               T(np.float32(1.5)))[0]
    s_out = m @ T(np.float32([1.0, 0, 0, 0]))
    assert abs(float(s_out[1])) / float(s_out[0]) == pytest.approx(
        1.0, abs=1e-4)


def test_stokes_single_polarizer():
    scene = bench([{"type": "polarizer", "theta": 30.0}])
    img, aovs = integrators.render(scene, seed=1, return_aovs=True)
    assert set(aovs) == {"s1", "s2", "s3"}
    s0 = float(img[0, 0, 1])
    assert s0 == pytest.approx(0.5, abs=0.01)
    dop = np.hypot(float(aovs["s1"][0, 0]), float(aovs["s2"][0, 0])) / s0
    assert dop == pytest.approx(1.0, abs=0.02)


@pytest.mark.parametrize("theta", [0.0, 30.0, 45.0, 60.0, 90.0])
def test_stokes_malus_law(theta):
    scene = bench([{"type": "polarizer", "theta": 0.0},
                   {"type": "polarizer", "theta": theta}])
    s0 = float(integrators.render(scene, seed=1)[0, 0, 1])
    assert s0 == pytest.approx(0.5 * np.cos(np.deg2rad(theta)) ** 2,
                               abs=0.02), theta


def test_stokes_crossed_polarizers_with_qwp():
    crossed = bench([{"type": "polarizer", "theta": 0.0},
                     {"type": "polarizer", "theta": 90.0}])
    assert float(integrators.render(crossed, seed=1)[0, 0, 1]) == \
        pytest.approx(0.0, abs=0.01)
    # a half-wave plate at 45 degrees turns the plane by 90 degrees
    with_hwp = bench([{"type": "polarizer", "theta": 0.0},
                      {"type": "retarder", "theta": 45.0, "delta": 180.0},
                      {"type": "polarizer", "theta": 90.0}])
    assert float(integrators.render(with_hwp, seed=1)[0, 0, 1]) == \
        pytest.approx(0.5, abs=0.02)


def test_stokes_conductor_reflection_polarizes():
    scene = meter(32, mirror={"type": "rectangle", "to_world": TILTED,
                              "bsdf": {"type": "conductor",
                                       "material": "au"}},
                  light=SIDE_LIGHT)
    img, aovs = integrators.render(scene, seed=3, return_aovs=True)
    s0 = float(img[0, 0, 1])
    s = [float(aovs[k][0, 0]) for k in ("s1", "s2", "s3")]
    assert s0 > 1e-3
    dop = np.sqrt(sum(v * v for v in s)) / s0
    assert 0.02 < dop < 0.9, (dop, s0, s)
    assert max(map(abs, s)) <= s0 * (1 + 1e-4)


def test_stokes_diffuse_depolarizes():
    scene = meter(64, env={"type": "constant", "radiance": 1.0},
                  wall={"type": "rectangle",
                        "to_world": {"type": "look_at",
                                     "origin": [0, 0, 1],
                                     "target": [0, 0, -4], "up": [0, 1, 0]},
                        "bsdf": {"type": "diffuse", "reflectance": 0.8}})
    img, aovs = integrators.render(scene, seed=5, return_aovs=True)
    s0 = float(img[0, 0, 1])
    assert s0 > 0.1
    assert np.hypot(float(aovs["s1"][0, 0]), float(aovs["s2"][0, 0])) \
        / s0 < 0.02


def test_stokes_glass_reflection_highly_polarized():
    """45 degree reflection off glass: Rs / Rp = 0.092 / 0.0085, a degree
    of polarization of ~0.83 (dielectric.cpp:250-307)."""
    scene = meter(32, glass={"type": "rectangle", "to_world": TILTED,
                             "bsdf": {"type": "dielectric"}},
                  light=SIDE_LIGHT)
    img, aovs = integrators.render(scene, seed=7, return_aovs=True)
    s0 = float(img[0, 0, 1])
    assert s0 > 1e-4
    dop = np.hypot(float(aovs["s1"][0, 0]), float(aovs["s2"][0, 0])) / s0
    assert 0.6 < dop <= 1.001, dop


def _camera_rays(scene, n=64, spp=2, seed=0):
    smp, ray, _w, _pos = integrators._camera_lanes(
        scene, seed, spp, torch.arange(n, dtype=torch.int64))
    return ray, smp


def test_polarized_volpath_s0_matches_scalar():
    """Under a polarization-preserving medium (isotropic phase) and a
    depolarizing ground the Mueller volpath's S0 is volpath's sample for
    sample, and no polarization appears."""
    scene = load_dict(rayleigh_dict(4, 2, {"type": "isotropic"}, {
        "type": "volpath", "max_depth": 6}), device="cpu")
    ray, smp = _camera_rays(scene)
    spec, _v, _s = volpath.sample(scene, smp, ray)
    stokes, _v2, _s2 = polarized_vol.sample_stokes(scene, smp, ray)
    assert spec.abs().max() > 0.01
    np.testing.assert_allclose(stokes[..., 0], spec, rtol=1e-5, atol=1e-7)
    assert float(stokes[..., 1:].abs().max()) == 0.0


def test_polarized_volpath_rayleigh_polarizes():
    """Rayleigh media make linear polarization and no circular one; every
    Stokes vector is physical (|S1..S3| <= S0)."""
    scene = load_dict(rayleigh_dict(4, 2), device="cpu")
    ray, smp = _camera_rays(scene)
    s = polarized_vol.sample_stokes(scene, smp, ray)[0].numpy()
    assert np.isfinite(s).all()
    assert np.abs(s[..., 1:3]).max() > 1e-4
    assert np.abs(s[..., 3]).max() < 1e-6
    lanes = s[..., 0] > 1e-6
    dop = np.sqrt((s[..., 1:] ** 2).sum(-1))[lanes] / s[..., 0][lanes]
    assert (dop <= 1.0 + 1e-4).all(), dop.max()


def test_rayleigh_scatter_matrix():
    m90 = mu.rayleigh_scatter(T(np.float32(0.0))).numpy()
    k = 3.0 / (16.0 * np.pi)
    assert np.isclose(m90[0, 0], k)
    s_out = m90 @ np.float32([1.0, 0, 0, 0])
    assert np.isclose(s_out[1] / s_out[0], 1.0)
    s_fwd = mu.rayleigh_scatter(T(np.float32(1.0))).numpy() @ np.float32(
        [1.0, 0, 0, 0])
    assert np.isclose(s_fwd[1], 0.0) and np.isclose(s_fwd[0], 2 * k)


def test_stokes_integrator_volumetric():
    """stokes over media takes the Mueller volpath (no child named)."""
    d = rayleigh_dict(4, 4, integrator={"type": "stokes", "max_depth": 6})
    del d["surface"]
    scene = load_dict(d, device="cpu")
    assert integrators.REGISTRY["stokes"]._regen_module(scene.config) \
        is polarized_vol
    img, aovs = integrators.render(scene, return_aovs=True)
    assert set(aovs) == {"s1", "s2", "s3"}
    assert torch.isfinite(img).all()
    assert float(aovs["s1"].abs().max() + aovs["s2"].abs().max()) > 1e-4


def test_roughdielectric_mueller_consistency():
    """M00 of roughdielectric's Mueller eval is the scalar eval; an
    unpolarized input leaves with a degree of polarization <= 1, and
    glancing reflections polarize."""
    scene = load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 45.0,
                   "to_world": {"type": "look_at", "origin": [0, 0, 4],
                                "target": [0, 0, 0], "up": [0, 1, 0]},
                   "film": {"width": 4, "height": 4,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 1}},
        "s": {"type": "sphere", "radius": 1.0,
              "bsdf": {"type": "roughdielectric", "alpha": 0.3,
                       "int_ior": 1.5, "ext_ior": 1.0}}}, device="cpu")
    ray, smp = _camera_rays(scene, spp=4)
    si = ray_intersect(scene.geo, ray)
    n = ray.o.shape[0]
    smp, u = smp.next_2d()
    z = 2.0 * u[:, 0] - 1.0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * np.pi * u[:, 1]
    wo = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
    idx = torch.zeros(n, dtype=torch.int32)
    val, _pdf = bsdfs.bsdf_eval_pdf(scene, idx, si, wo, si.is_valid)
    m, _pdf2 = bsdfs.bsdf_eval_mueller(scene, idx, si, wo, si.is_valid)
    np.testing.assert_allclose(m[..., 0, 0], val, rtol=1e-4, atol=1e-6)
    s_out = m[..., :, 0].numpy()
    dop_num = np.sqrt((s_out[..., 1:] ** 2).sum(-1))
    ok = s_out[..., 0] > 1e-9
    assert (dop_num[ok] <= s_out[..., 0][ok] * (1 + 1e-4)).all()
    assert dop_num.max() > 1e-6


def test_phase_mueller_physical_validity():
    """Rayleigh's phase_mueller: M00 is the scalar phase, and physical
    Stokes vectors map to physical ones."""
    scene = load_dict(atmosphere(width=4, height=4, spp=2, max_depth=4),
                      device="cpu")
    n = 256
    rng = np.random.RandomState(3)
    wi = rng.randn(n, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = rng.randn(n, 3).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    idx = torch.zeros(n, dtype=torch.int32)
    val = phase.phase_eval(scene, idx, T(wi), T(wo))
    m = phase.phase_mueller(scene, idx, T(wi), T(wo)).numpy()
    np.testing.assert_allclose(m[..., 0, 0], val, rtol=1e-5, atol=1e-7)
    s_in = rng.randn(n, 4).astype(np.float32)
    s_in[:, 0] = np.abs(s_in[:, 0]) + np.linalg.norm(s_in[:, 1:], axis=-1)
    s_out = np.einsum("nij,nj->ni", m, s_in)
    ok = s_out[:, 0] > 1e-9
    dop = np.linalg.norm(s_out[ok, 1:], axis=-1) / s_out[ok, 0]
    assert (dop <= 1.0 + 1e-4).all(), dop.max()


def _drivers_agree(scene, seed, max_flips=0):
    assert integrators.regen_supported(scene.config)
    img_a, aovs_a = integrators.render(scene, seed=seed, return_aovs=True)
    img_b, aovs_b = integrators.render(scene, seed=seed, return_aovs=True,
                                       regen=True, samples_per_pass=LANES)
    assert_driver_equivalent(img_a, img_b, max_flips=max_flips)
    for k in ("s1", "s2", "s3"):
        assert_driver_equivalent(aovs_a[k][..., None], aovs_b[k][..., None],
                                 max_flips=max_flips)


def test_stokes_regen_driver_equivalence():
    """stokes(volpath) on the lane pool: the premultiplied sensor-basis
    rotation gives the scan driver's post-rotated S0 and S1..S3."""
    _drivers_agree(load_dict(rayleigh_dict(), device="cpu"), 3, 1)


def test_stokes_surface_regen_driver_equivalence():
    """stokes(path) on the lane pool, through an element chain."""
    _drivers_agree(bench([{"type": "polarizer", "theta": 30.0},
                          {"type": "retarder", "theta": 15.0,
                           "delta": 90.0}], spp=32), 5)


# ---- (b) films against the reference --------------------------------------------

@pytest.mark.parametrize("case", ["volpath scan", "volpath pool",
                                  "path scan", "path pool"])
def test_stokes_film_matches_reference(ref, case):
    name, driver = case.split()
    d, _variant, seed = CASES[name][name]
    scene = load_dict(d, device="cpu")
    film = integrators.render(scene, seed=seed, develop_film=False,
                              regen=driver == "pool",
                              samples_per_pass=LANES).numpy()
    want = ref[name]
    cfg = scene.config
    assert film.shape == want.shape == (cfg.film_height, cfg.film_width, 8)
    assert np.isfinite(film).all() and film[..., :3].mean() > 0.01
    np.testing.assert_array_equal(film[..., 4], scene.config.spp)
    assert np.abs(aovs_of(film)[..., :2]).max() > 1e-3  # polarized
    assert_driver_equivalent(want, film, max_flips=1 if name == "volpath"
                             else 2)


@pytest.mark.parametrize("mode", ["mono", "spectral", "rgb_double"])
def test_variant_film_matches_reference(ref, mode):
    group = "x64" if mode == "rgb_double" else "variants"
    d, variant, seed = CASES[group][mode]
    scene = load_dict(d, Variant(variant, polarized=True), device="cpu")
    assert scene.config.variant.polarized
    want = ref[mode]
    drivers = [False] if mode == "rgb_double" else [False, True]
    for regen in drivers:
        film = integrators.render(scene, seed=seed, develop_film=False,
                                  regen=regen, samples_per_pass=LANES)
        assert film.dtype == scene.config.variant.dtype
        film = film.numpy()
        assert film.shape == want.shape
        assert np.isfinite(film).all() and film[..., 1].mean() > 1e-3
        assert np.abs(aovs_of(film)[..., :2]).max() > 1e-4  # polarized
        assert_driver_equivalent(want, film, max_flips=1,
                                 tol=1e-7 if mode == "rgb_double" else 1e-4)
    if mode == "rgb_double":  # the double rule: the scan driver only
        with pytest.raises(NotImplementedError, match="regen=False"):
            integrators.render(scene, regen=True)


# ---- (c) loading, XML and the pool's traffic model --------------------------------

def polarized_bsdfs_dict(pbsdf_file):
    """stokes(path) over the five polarized BSDFs."""
    d = bench_dict([{"type": "polarizer", "theta": 30.0,
                     "transmittance": 0.9},
                    {"type": "retarder", "theta": 15.0, "delta": 120.0},
                    {"type": "circular", "left_handed": True},
                    {"type": "pplastic", "alpha": 0.2,
                     "diffuse_reflectance": 0.4,
                     "distribution": "ggx"},
                    {"type": "measured_polarized", "filename": pbsdf_file,
                     "alpha_sample": 0.3, "wavelength": 550.0}])
    d["integrator"]["child"]["max_depth"] = 5
    d["sensor"]["film"]["type"] = "hdrfilm"
    d["sensor"]["sampler"]["type"] = "independent"
    return d


def test_load_dict_and_xml_match_reference(tmp_path):
    """The scene's arrays leaf for leaf and its config, from the dict and
    from the XML that dict_to_xml writes (the same text as the
    reference's)."""
    pbsdf = str(tmp_path / "synth.pbsdf")
    jtensorfile.write_tensor_file(pbsdf, synth_pbsdf())
    d = polarized_bsdfs_dict(pbsdf)
    scene = load_dict(d, device="cpu")
    assert_same_scene(scene, jload_dict(d))
    assert scene.config.integrator.kind == "stokes"
    assert dict(scene.config.integrator.extra)["child"] == "path"
    assert scene.config.integrator.max_depth == 5
    assert set(scene.config.bsdf_kinds) == {
        "polarizer", "retarder", "circular", "pplastic",
        "measured_polarized"}
    text = pxml.dict_to_xml(d)
    assert text == rxml.dict_to_xml(d)
    path = str(tmp_path / "scene.xml")
    pxml.write_file(path, d)
    from_xml = load_file(path, device="cpu")
    assert_same_scene(from_xml, rxml.load_file(path))
    for name, a in scene.arrays().items():
        np.testing.assert_array_equal(a, from_xml.arrays()[name],
                                      err_msg=name)
    assert from_xml.config == scene.config
    # and it renders: the measured pBRDF behind the element stack
    img = integrators.render(scene, seed=2, spp=8)
    assert torch.isfinite(img).all()


def test_regen_iter_traffic_nbytes():
    """The modelled traffic of a polarized lane state: volpath's but for
    the Mueller throughput and Stokes vector (16 + 4 floats a channel
    instead of 1 + 1), both read and written, and the three AOV columns'
    writes."""
    d = rayleigh_dict()
    stokes = load_dict(d, device="cpu")
    d["integrator"] = {"type": "volpath", "max_depth": 6}
    scalar = load_dict(d, device="cpu")
    n, nc = 4096, 3
    got = integrators.regen_iter_traffic_nbytes(stokes, n, 8)
    base = integrators.regen_iter_traffic_nbytes(scalar, n, 8)
    assert base > 0
    assert got - base == 2 * n * nc * 18 * 4 + n * 3 * 4
