"""User plugins in the port (phase.register_phasefunction,
emitters.register_emitter, bsdfs.register_bsdf,
integrators.register_integrator) against the JAX package's:

- every test of tests/test_custom_plugins.py on the port: a registered
  Henyey-Greenstein clone renders the built-in hg's film through volpath
  (on the scan driver and on the lane pool), conserves energy in the
  volumetric furnace and passes the chi2 harness; a registered
  point-emitter clone renders the built-in point emitter's film;
- a registered diffuse clone (its reflectance named ``albedo``) renders
  the built-in diffuse's film, and a registered integrator whose sample
  is path's renders path's film;
- each registered kind's film against the reference's film of the same
  kind registered there (its modules written with jax.numpy, in a
  subprocess started with the module), within
  tests/conftest.py::assert_driver_equivalent's budget;
- the registered kinds load through the XML path (scene.xml) as through
  load_dict.

The port's plugins are registered in a module fixture and taken out of
the registries when the module ends, so no registration reaches another
test file on the same worker."""

import math
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu_torch import bsdfs, emitters, integrators, phase
from eradiate_kernel_tpu_torch.bsdfs import diffuse
from eradiate_kernel_tpu_torch.integrators import path
from eradiate_kernel_tpu_torch.scene import load_dict, load_string
from eradiate_kernel_tpu_torch.scene import xml as pxml
from eradiate_kernel_tpu_torch.utils.chi2 import (ChiSquareTest,
                                                  SphericalDomain)

CAMERA = {"type": "look_at", "origin": [0, 0, -4], "target": [0, 0, 0],
          "up": [0, 1, 0]}


def volpath_scene(phase_dict=None, spp=64):
    """tests/test_custom_plugins.py's volumetric furnace: a sphere of
    albedo 1 under a constant sky, seen through volpath."""
    med = {"type": "homogeneous", "sigma_t": 1.0, "albedo": 1.0}
    if phase_dict:
        med["phase"] = phase_dict
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 64, "rr_depth": 1000},
        "sensor": {"type": "perspective", "fov": 30.0, "to_world": CAMERA,
                   "film": {"type": "hdrfilm", "width": 8, "height": 8,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "bound": {"type": "sphere", "radius": 1.0, "interior": med},
        "env": {"type": "constant", "radiance": 1.0},
    }


def lamp_scene(lamp=None, bsdf=None, integrator="path"):
    """tests/test_custom_plugins.py's lamp over a diffuse rectangle."""
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 30.0,
                   "to_world": {"type": "look_at", "origin": [0, 0, 4],
                                "target": [0, 0, 0], "up": [0, 1, 0]},
                   "film": {"type": "hdrfilm", "width": 8, "height": 8,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 32}},
        "surf": {"type": "rectangle",
                 "bsdf": bsdf or {"type": "diffuse", "reflectance": 0.5}},
        "lamp": lamp or {"type": "point", "position": [0.0, 0.0, 2.5],
                         "intensity": 0.8},
    }


POWER = 4.0 * math.pi * 0.8
CUSTOM_LAMP = {"type": "port_lamp", "position": [0.0, 0.0, 2.5],
               "power": POWER}
CUSTOM_BSDF = {"type": "port_diffuse", "albedo": 0.5}

# name -> (scene dict, seed, the integrator kind the reference renders
# under: its load_dict takes only the built-in integrators)
CASES = {
    "phase": (volpath_scene({"type": "port_hg", "anisotropy": 0.4}), 9, None),
    "emitter": (lamp_scene(lamp=CUSTOM_LAMP), 11, None),
    "bsdf": (lamp_scene(bsdf=CUSTOM_BSDF), 12, None),
    "integrator": (lamp_scene(), 13, "port_path"),
}

_SCRIPT = r"""
import dataclasses
import pickle
import sys
import types
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from eradiate_kernel_tpu import bsdfs, emitters, integrators, phase
from eradiate_kernel_tpu.bsdfs import diffuse
from eradiate_kernel_tpu.integrators import path
from eradiate_kernel_tpu.scene import load_dict

hg = types.SimpleNamespace()
hg.build = lambda props, b: {"aniso": np.float32(props.get("anisotropy",
                                                           0.0))}

def eval_cos(params, slot, ct):
    g = params["aniso"][slot]
    temp = 1.0 + g * g + 2.0 * g * ct
    return (1.0 / (4.0 * jnp.pi)) * (1.0 - g * g) \
        / jnp.maximum(temp * jnp.sqrt(jnp.maximum(temp, 0.0)), 1e-12)

def sample_cos(params, slot, s1):
    g = params["aniso"][slot]
    safe_g = jnp.where(jnp.abs(g) < 1e-4, 1e-4, g)
    sqr_term = (1.0 - g * g) / (1.0 - g + 2.0 * g * s1)
    ct = (1.0 + g * g - sqr_term * sqr_term) / (2.0 * safe_g)
    return jnp.where(jnp.abs(g) < 1e-4, 1.0 - 2.0 * s1, ct)

hg.eval_cos, hg.sample_cos = eval_cos, sample_cos
phase.register_phasefunction("port_hg", hg)

lamp = types.SimpleNamespace()
lamp.build = lambda props, b: {
    "position": np.asarray(props.get("position", [0, 0, 0]), np.float32),
    "intensity": np.int32(b.texture(float(props.get("power", 1.0))
                                    / (4.0 * np.pi), emitter=True))}
lamp.sample_direction = emitters.point_sample_direction
emitters.register_emitter("port_lamp", lamp)

clone = types.SimpleNamespace(
    FLAGS=diffuse.FLAGS, sample=diffuse.sample, eval_pdf=diffuse.eval_pdf,
    build=lambda props, b: diffuse.build(
        {**props, "reflectance": props.get("albedo", 0.5)}, b))
bsdfs.register_bsdf("port_diffuse", clone)
integrators.register_integrator("port_path",
                                types.SimpleNamespace(sample=path.sample))

with open(sys.argv[2], "rb") as f:
    cases = pickle.load(f)
out = {}
for name, (d, seed, kind) in cases.items():
    scene = load_dict(d)
    if kind is not None:
        cfg = scene.config
        scene = dataclasses.replace(scene, config=dataclasses.replace(
            cfg, integrator=dataclasses.replace(cfg.integrator, kind=kind)))
    out[name] = np.asarray(integrators.render(scene, seed=seed))
np.savez(sys.argv[1], **out)
"""


def _port_plugins():
    """The port's plugins: name -> (register, registry dicts, module)."""
    hg = types.SimpleNamespace()
    hg.build = lambda props, b: {
        "aniso": np.float32(props.get("anisotropy", 0.0))}

    def eval_cos(params, slot, ct):
        g = params["aniso"][slot]
        temp = 1.0 + g * g + 2.0 * g * ct
        return (1.0 / (4.0 * math.pi)) * (1.0 - g * g) / torch.clamp(
            temp * torch.sqrt(torch.clamp(temp, min=0.0)), min=1e-12)

    def sample_cos(params, slot, s1):
        g = params["aniso"][slot]
        safe_g = torch.where(torch.abs(g) < 1e-4, 1e-4, g)
        sqr_term = (1.0 - g * g) / (1.0 - g + 2.0 * g * s1)
        ct = (1.0 + g * g - sqr_term * sqr_term) / (2.0 * safe_g)
        return torch.where(torch.abs(g) < 1e-4, 1.0 - 2.0 * s1, ct)

    hg.eval_cos, hg.sample_cos = eval_cos, sample_cos

    lamp = types.SimpleNamespace()
    lamp.build = lambda props, b: {
        "position": np.asarray(props.get("position", [0, 0, 0]), np.float32),
        "intensity": np.int32(b.texture(float(props.get("power", 1.0))
                                        / (4.0 * np.pi), emitter=True))}
    lamp.sample_direction = emitters.point_sample_direction

    clone = types.SimpleNamespace(
        FLAGS=diffuse.FLAGS, sample=diffuse.sample,
        eval_pdf=diffuse.eval_pdf,
        build=lambda props, b: diffuse.build(
            {**props, "reflectance": props.get("albedo", 0.5)}, b))
    return {
        "port_hg": (phase.register_phasefunction, (phase.CUSTOM,), hg),
        "port_lamp": (emitters.register_emitter,
                      (emitters.CUSTOM, emitters.KIND_SAMPLERS), lamp),
        "port_diffuse": (bsdfs.register_bsdf, (bsdfs.REGISTRY,), clone),
        "port_path": (integrators.register_integrator,
                      (integrators.REGISTRY,),
                      types.SimpleNamespace(sample=path.sample)),
    }


@pytest.fixture(scope="module", autouse=True)
def registered():
    """The port's plugins registered for the module and taken out of every
    registry afterwards; one torch thread meanwhile
    (tests/test_torch_sensors.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    plugins = _port_plugins()
    for name, (register, _registries, module) in plugins.items():
        register(name, module)
    yield plugins
    for name, (_register, registries, _module) in plugins.items():
        for reg in registries:
            reg.pop(name, None)
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory, registered):
    """The reference's films of the registered kinds, rendered in a
    subprocess while the port's tests run."""
    tmp = tmp_path_factory.mktemp("plugins")
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(CASES, f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-c", _SCRIPT, str(tmp / "films.npz"),
         str(tmp / "cases.pkl")], env=dict(os.environ, JAX_PLATFORMS="cpu"),
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    films = {}

    def get(name):
        if not films:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, out[-2000:] + err[-3000:]
            films.update(np.load(tmp / "films.npz"))
        return films[name]

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def render(d, seed, **kw):
    return integrators.render(load_dict(d, device="cpu"), seed=seed,
                              **kw).numpy()


def port_film(name):
    d, seed, kind = CASES[name]
    if kind is not None:
        d = dict(d, integrator=dict(d["integrator"], type=kind))
    return render(d, seed)


# ---- tests/test_custom_plugins.py on the port ---------------------------------

def test_custom_phase_renders_through_volpath():
    """The registered HG clone renders the built-in hg's film, on the
    scan driver and on the lane pool."""
    ref = render(volpath_scene({"type": "hg", "g": 0.4}), 9)
    img = port_film("phase")
    np.testing.assert_allclose(img, ref, atol=1e-5)
    pool = render(volpath_scene({"type": "port_hg", "anisotropy": 0.4}), 9,
                  regen=True, samples_per_pass=1024)
    np.testing.assert_allclose(pool, ref, atol=1e-5)


def test_custom_phase_furnace():
    """Energy conservation of the registered kind in the volumetric
    furnace (albedo 1, constant sky): L = 1."""
    img = render(volpath_scene({"type": "port_hg", "anisotropy": -0.3}), 5)
    assert abs(img.mean() - 1.0) < 0.05, img.mean()


def test_custom_phase_chi2():
    """The registered kind's sample and pdf agree under the chi2
    harness."""
    scene = load_dict(volpath_scene({"type": "port_hg", "anisotropy": 0.6}),
                      device="cpu")
    ray_d = torch.tensor([0.0, 0.0, 1.0])

    def sample_func(smp):
        n = smp.k0.shape[0]
        smp, s1 = smp.next_1d()
        smp, s2 = smp.next_2d()
        wo, _ = phase.phase_sample(scene, torch.zeros(n, dtype=torch.int64),
                                   ray_d.expand(n, 3), s1, s2)
        return wo

    def pdf_func(pts):
        n = pts.shape[0]
        return phase.phase_eval(scene, torch.zeros(n, dtype=torch.int64),
                                -ray_d.expand(n, 3), pts)

    test = ChiSquareTest(SphericalDomain(), sample_func, pdf_func,
                         sample_count=120_000, res=32, ires=9, device="cpu")
    assert test.run(), test.messages


def test_custom_emitter_registers_and_renders():
    """The registered point-emitter clone (intensity = power / 4 pi)
    renders the built-in point emitter's film."""
    ref = render(lamp_scene(), 11)
    img = port_film("emitter")
    assert ref.mean() > 1e-3  # the lamp lights the plane
    np.testing.assert_allclose(img, ref, atol=1e-5)


# ---- the registered BSDF and integrator ----------------------------------------

def test_custom_bsdf_renders_as_diffuse():
    ref = render(lamp_scene(), 12)
    img = port_film("bsdf")
    assert ref.mean() > 1e-3
    np.testing.assert_array_equal(img, ref)


def test_custom_integrator_renders_as_path():
    ref = render(lamp_scene(), 13)
    img = port_film("integrator")
    assert ref.mean() > 1e-3
    np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("name", list(CASES))
def test_registered_kind_matches_reference(reference, name):
    """The port's film of each registered kind against the reference's
    film of the same kind registered there."""
    assert_driver_equivalent(reference(name), port_film(name),
                             max_flips=2 if name == "phase" else 0)


def test_unregistered_kinds_raise():
    """A kind nobody registered still raises: a nested phase or BSDF
    naming its hook, a top-level entry its type."""
    for key, entry, match in (
            ("bound", {"type": "sphere", "radius": 1.0, "interior": {
                "type": "homogeneous", "phase": {"type": "nobody_hg"}}},
             "register_phasefunction"),
            ("lamp", {"type": "nobody_lamp"}, "nobody_lamp"),
            ("surf", {"type": "rectangle",
                      "bsdf": {"type": "nobody_bsdf"}}, "register_bsdf")):
        d = lamp_scene() if key != "bound" else volpath_scene()
        d[key] = entry
        with pytest.raises((ValueError, NotImplementedError), match=match):
            load_dict(d, device="cpu")


# ---- the XML path --------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_registered_kind_loads_from_xml(name):
    """dict_to_xml of the registered kind's scene reads back through
    load_string into the same scene, which renders the dict's film."""
    d, seed, kind = CASES[name]
    if kind is not None:
        d = dict(d, integrator=dict(d["integrator"], type=kind))
    text = pxml.dict_to_xml(d)
    scene = load_string(text, device="cpu")
    assert scene.config == load_dict(d, device="cpu").config
    np.testing.assert_array_equal(
        integrators.render(scene, seed=seed).numpy(), port_film(name))
