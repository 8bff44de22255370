"""Gradients of slice 5a's scenes in the port against the JAX package's
jax.grad at the same seed: the port's counterpart of
tests/test_autodiff.py::test_replay_grad_path_integrator.

- The furnace (a diffuse sphere under a constant environment): d(mean
  image)/d(the sphere's albedo and the environment's radiance) through
  the path replay (render(regen=True)) and the scan driver, against the
  reference's jax.grad through both of its drivers.
- The Cornell box: d(mean image)/d(the light's radiance and the white,
  red and green walls' reflectance), the same four ways.
- The sky-lit atmosphere (utils.scenes.atmosphere with a constant sky of
  radiance 0.1, ground lowered by 1e-3, a seeded 2x2x2 sigma_t grid:
  volpath's MIS emitter walk and residual walks): d/d(the grid, the sky's
  and the sun's radiance) through the port's replay and scan driver,
  against the reference's jax.grad through its scan driver. The
  reference's own replay is not the comparison: its default PRB walk
  (_run_walk_prb) hands the MIS walk's emitter_val cotangent to every
  step unchanged and so drops its gradient through the transmittance of
  the steps before the emitter hit (about half of this grid gradient);
  with prb_walks off its replay equals its scan driver and the port's
  replay (ROADMAP.md, Queue 3).

Every gradient is compared at rtol 5e-3 and atol 1e-7
(tests/test_autodiff.py's replay-vs-scan figure) and must be finite and
not all zero. Spectra are compared on the rows named: the RPV rows of
the atmosphere's ground are NaN in the reference's gradient too
(ROADMAP.md, Queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu.utils import scenes as jscenes
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff, scenes
from test_torch_skylight import sky_atmosphere

SEED = 3
RTOL, ATOL = 5e-3, 1e-7
KEYS = ["spectra.baked.value"]


def spec_row(a, tex):
    """The spectra.baked.value row of constant texture ``tex``."""
    spec = a["textures.constant.spec"][a["tex_slot"][tex]]
    return int(a["spec_slot"][spec])


def port_grads(scene, keys, regen, lanes):
    pm = autodiff.traverse(scene).keep(keys)
    params = pm.trainable()
    integrators.render(pm.with_trainable(params), seed=SEED,
                       samples_per_pass=lanes, regen=regen).mean().backward()
    return {k: p.grad.numpy() for k, p in params.items()}


def reference_grads(jscene, keys, regen, lanes):
    pm = jad.traverse(jscene)
    pm.keep(keys)

    def loss(tr):
        return jnp.mean(jintegrators.render(pm.with_trainable(tr), seed=SEED,
                                            samples_per_pass=lanes,
                                            regen=regen))

    g = jax.grad(loss)(pm.trainable())
    return {k: np.asarray(g[k]) for k in keys}


def surface_case(name, *args, **kw):
    """Gradients of utils.scenes.<name>(...) (each package's own factory)
    by both drivers in both packages, and the scene's arrays."""
    jscene = jload_dict(getattr(jscenes, name)(*args, **kw))
    scene = load_dict(getattr(scenes, name)(*args, **kw), device="cpu")
    lanes = 96
    out = {"arrays": {k: v.numpy() for k, v in scene.tensors().items()}}
    for regen in (False, True):
        key = "replay" if regen else "scan"
        out[key] = port_grads(scene, KEYS, regen, lanes)
        out["reference " + key] = reference_grads(jscene, KEYS, regen, lanes)
    return out


@pytest.fixture(scope="module")
def furnace():
    return surface_case("furnace", 0.5, 1.0, width=8, height=8, spp=8,
                        max_depth=4)


@pytest.fixture(scope="module")
def cornell():
    return surface_case("cornell_box", width=8, height=8, spp=8,
                        max_depth=3)


@pytest.mark.parametrize("name", ["furnace", "cornell_box"])
def test_parameter_names_match_reference(name):
    """utils.params.traverse names every tensor of the port's scene as the
    reference's traverse names it (the port's keys are the reference's,
    the emitters' and BSDFs' among them), so a gradient test can name one
    key in both packages."""
    d = getattr(scenes, name)(width=4, height=4, spp=1)
    keys = set(autodiff.traverse(load_dict(d, device="cpu")).keys())
    ref = set(jad.traverse(jload_dict(getattr(jscenes, name)(
        width=4, height=4, spp=1))).keys())
    assert keys <= ref, sorted(keys - ref)
    kind = "constant" if name == "furnace" else "area"
    assert {"spectra.baked.value", f"emitters.{kind}.radiance",
            "bsdfs.diffuse.reflectance", "shape_area"} <= keys


def check(case, rows, driver, ref_driver):
    for name, row in rows.items():
        g = case[driver]["spectra.baked.value"][row]
        ref = case[ref_driver]["spectra.baked.value"][row]
        assert np.isfinite(g).all() and np.abs(ref).sum() > 0, name
        assert np.allclose(g, ref, rtol=RTOL, atol=ATOL), \
            (name, driver, ref_driver, g, ref)


@pytest.mark.parametrize("driver", ["replay", "scan"])
def test_furnace_gradient_matches_reference(furnace, driver):
    """The albedo's and the environment's gradient; the replay also
    against the port's scan driver."""
    a = furnace["arrays"]
    rows = {"albedo": spec_row(a, a["bsdfs.diffuse.reflectance"][0]),
            "environment": spec_row(a, a["emitters.constant.radiance"][0])}
    check(furnace, rows, driver, "reference " + driver)
    check(furnace, rows, driver, "reference scan")
    check(furnace, rows, driver, "scan")


@pytest.mark.parametrize("driver", ["replay", "scan"])
def test_cornell_box_gradient_matches_reference(cornell, driver):
    a = cornell["arrays"]
    refl = a["bsdfs.diffuse.reflectance"]
    rows = {"light": spec_row(a, a["emitters.area.radiance"][0]),
            "white": spec_row(a, refl[0]), "red": spec_row(a, refl[1]),
            "green": spec_row(a, refl[2])}
    check(cornell, rows, driver, "reference " + driver)
    check(cornell, rows, driver, "scan")


SKY_KEYS = ["volumes.gridvolume.grid", "spectra.baked.value"]


def slab_dict():
    """The sky-lit atmosphere over a seeded 2x2x2 sigma_t grid (no vertical
    profile: the residual walks run), 4x4, 8 spp, RR from depth 1."""
    rng = np.random.default_rng(3)
    d = sky_atmosphere(64, 4, 8)
    d["atmo"]["interior"]["sigma_t"]["data"] = (
        0.2 + 0.6 * rng.random((2, 2, 2))).astype(np.float32)
    d["integrator"].update(rr_depth=1)
    return d


def parts(scene, grads):
    """The grid and the sky's and sun's rows of the spectra (the RPV rows
    are NaN in the reference's gradient too, ROADMAP Queue 3)."""
    a = {k: v.numpy() for k, v in scene.tensors().items()}
    row = lambda em: spec_row(a, a[f"emitters.{em}"][0])
    spec = grads["spectra.baked.value"]
    return {"grid": grads["volumes.gridvolume.grid"],
            "sky": spec[row("constant.radiance")],
            "sun": spec[row("directional.irradiance")]}


@pytest.fixture(scope="module")
def slab_grads():
    d = slab_dict()
    scene = load_dict(d, device="cpu")
    assert not scene.config.het_profile1d
    out = {}
    for regen in (False, True):
        pm = autodiff.traverse(scene).keep(SKY_KEYS)
        params = pm.trainable()
        integrators.render(pm.with_trainable(params), seed=SEED,
                           samples_per_pass=48, regen=regen).mean().backward()
        out["replay" if regen else "scan"] = parts(
            scene, {k: p.grad.numpy() for k, p in params.items()})
    pm = jad.traverse(jload_dict(d))
    pm.keep(SKY_KEYS)

    def loss(tr):
        return jnp.mean(jintegrators.render(pm.with_trainable(tr), seed=SEED,
                                            samples_per_pass=48))

    g = jax.grad(loss)(pm.trainable())
    out["reference"] = parts(scene, {k: np.asarray(g[k]) for k in SKY_KEYS})
    return out


@pytest.mark.parametrize("part", ["grid", "sky", "sun"])
def test_sky_lit_gradient_matches_reference(slab_grads, part):
    ref = slab_grads["reference"][part]
    assert np.isfinite(ref).all() and np.abs(ref).sum() > 0
    for driver in ("scan", "replay"):
        g = slab_grads[driver][part]
        assert np.isfinite(g).all(), driver
        assert np.allclose(g, ref, rtol=RTOL, atol=ATOL), \
            (driver, np.abs(g - ref).max(), np.abs(ref).max())
