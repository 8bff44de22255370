"""The double-precision variants (mono_double, rgb_double, spectral_double)
against the JAX package's x64 renders: the contract of
tests/test_double.py carried over to the port.

x64 is a process-global JAX flag, so the reference runs in ONE subprocess
for the whole module (tests/test_double.py's way), started by the first
test and writing every array the tests compare to an .npz; the tests that
need no reference run meanwhile.

Tolerances, and why:
  - films: assert_driver_equivalent at tol 1e-7 a pixel (1,000x tighter
    than the float32 tests' 1e-4), spectral_double at 1e-6. Both packages
    keep the sampler's draws and what they compute from them alone (warps,
    free-flight distances, phase sampling, hero wavelengths, the film's
    CIE weights) in float32, as the reference does (core/rng.py). There
    XLA contracts multiply-adds under jit and eager torch does not, and
    their log1p, sin, cos and cube root differ by an ulp: the films differ
    at the float32 level of those quantities (the Cornell box by 3.8e-8,
    the atmosphere by 6.8e-8-7.8e-8). In spectral every sample's XYZ is
    weighted by a float32 CIE lookup that the reference's FMAs move by an
    ulp on 15 % of lookups (none when it runs eagerly): 5.3e-7 on films
    whose weight channel reads 4.
  - hits from 1e5 away: within 1e-6 of the distance (the reference test's
    gate) and 100x closer than float32's; equal to the reference's float64
    brute-force hit within 1e-9 (its triple products and the sweep's
    Moller-Trumbore round differently in the last bits).
  - the 17^3 slab's grid gradient: rtol 5e-5 of the reference's x64
    jax.grad, atol 1e-12.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from test_torch_replay import LANES, SEED, slab_dict
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.core.rng import Sampler
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.ops import intersect
from eradiate_kernel_tpu_torch.render.geometry import ray_intersect
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere, cornell_box

GRID = "volumes.gridvolume.grid"
# the hits' distance: 1e5 away from the unit sphere and the cube's z = 1
# face, with a fraction float32 cannot hold
FAR = 1e5 + 0.3
MODES = ("mono", "rgb", "spectral")
FILM_TOL = {"mono": 1e-7, "rgb": 1e-7, "spectral": 1e-6}

_SCRIPT = r"""
import pickle
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
from eradiate_kernel_tpu import integrators
from eradiate_kernel_tpu.core.ray import Ray
from eradiate_kernel_tpu.core.rng import Sampler
from eradiate_kernel_tpu.core.types import Variant
from eradiate_kernel_tpu.render.geometry import ray_intersect
from eradiate_kernel_tpu.scene import load_dict
from eradiate_kernel_tpu.utils import autodiff
from eradiate_kernel_tpu.utils.scenes import cornell_box

with open(sys.argv[2], "rb") as f:
    case = pickle.load(f)
out = {}
if sys.argv[3] == "b":  # the spectral atmosphere and the gradient
    out["atm_spectral"] = np.asarray(integrators.render(
        load_dict(case["atmosphere"], Variant("spectral_double")), seed=5,
        develop_film=False))
    pm = autodiff.traverse(load_dict(case["slab"], Variant("rgb_double")))
    pm.keep([case["key"]])

    def loss(tr):
        return jnp.mean(integrators.render(
            pm.with_trainable(tr), seed=case["seed"],
            samples_per_pass=case["lanes"]))

    out["slab_grad"] = np.asarray(
        jax.grad(loss)(pm.trainable())[case["key"]])
    np.savez(sys.argv[1], **out)
    sys.exit(0)


@jax.jit
def draws(lanes):
    sampler, us = Sampler.seed(7, lanes), []
    for _ in range(3):
        sampler, u = sampler.next_1d()
        us.append(u)
    return us


for i, u in enumerate(draws(jnp.arange(256, dtype=jnp.uint32))):
    out[f"draw_{i}"] = np.asarray(u)
d = cornell_box(width=8, height=8, spp=16, max_depth=3)
out["cbox"] = np.asarray(integrators.render(
    load_dict(d, Variant("rgb_double")), seed=1, develop_film=False))
for mode in ("mono", "rgb"):
    out["atm_" + mode] = np.asarray(integrators.render(
        load_dict(case["atmosphere"], Variant(mode + "_double")), seed=5,
        develop_film=False))
for shape, sd in case["shapes"].items():  # eager, as tests/test_double.py
    scene = load_dict(sd, Variant("rgb_double"))
    o = jnp.asarray([[0.0, 0.0, case["far"]], [0.25, -0.125, case["far"]]],
                    jnp.float64)
    dv = jnp.asarray([[0.0, 0.0, -1.0]] * 2, jnp.float64)
    out["t_" + shape] = np.asarray(ray_intersect(
        scene.geo, Ray.make(o, dv, wavelengths=jnp.zeros((2, 0)))).t)
np.savez(sys.argv[1], **out)
"""


def lowered_atmosphere():
    """The atmosphere with a 17 x 16 x 16 grid (the packed-corner gathers)
    and its ground lowered by 1e-3 (the coplanar tie of ROADMAP Queue 3)."""
    d = atmosphere(8, 8, 4, 6, grid_res=(17, 16, 16))
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    return d


def shapes_dict(shape):
    """A unit sphere (analytic) or the 12-triangle cube [-1, 1]^3 (a mesh:
    one tile) at the origin."""
    s = ({"type": "sphere", "radius": 1.0} if shape == "sphere"
         else {"type": "cube"})
    return {"type": "scene", "s": s, "sensor": {
        "type": "perspective", "film": {"width": 2, "height": 2}}}


class _Reference:
    """The x64 subprocesses, started once and read at the first need, two
    side by side: (a) the draws, the Cornell box, the far hits and the mono
    and rgb atmospheres; (b) the spectral atmosphere and the gradient (its
    jax.grad compiles for ~25 s). They take the scene dicts the port
    renders (pickled; the Cornell box is the reference's own factory, as
    its sensor transform is each package's own)."""

    def __init__(self, tmp):
        case = dict(atmosphere=lowered_atmosphere(), far=FAR,
                    shapes={s: shapes_dict(s) for s in ("sphere", "cube")},
                    slab=slab_dict(grid_res=(17, 17, 17)), key=GRID,
                    seed=SEED, lanes=4 * 4 * 16)
        with open(tmp / "case.pkl", "wb") as f:
            pickle.dump(case, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        self.parts = {}
        for part in ("a", "b"):
            path = str(tmp / f"{part}.npz")
            self.parts[part] = (path, subprocess.Popen(
                [sys.executable, "-c", _SCRIPT, path, str(tmp / "case.pkl"),
                 part], env=env, cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        self.arrays = {}

    def __getitem__(self, key):
        part = "b" if key in ("slab_grad", "atm_spectral") else "a"
        if part not in self.arrays:
            path, proc = self.parts[part]
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, out[-2000:] + err[-3000:]
            self.arrays[part] = dict(np.load(path))
        return self.arrays[part][key]

    def stop(self):
        for _path, proc in self.parts.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """The reference's arrays (x64 subprocess), with one torch thread for
    the module meanwhile (test_torch_sensors.one_torch_thread's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    reference = _Reference(tmp_path_factory.mktemp("double"))
    yield reference
    reference.stop()
    torch.set_num_threads(n)


def _film(d, mode, seed):
    scene = load_dict(d, Variant(mode), device="cpu")
    return integrators.render(scene, seed=seed, develop_film=False).numpy()


# --- port alone (run while the reference computes) --------------------------

@pytest.mark.parametrize("mode", MODES)
def test_double_variants_parse(mode):
    v = Variant(mode + "_double")
    assert v == Variant(mode, dtype=torch.float64)
    assert (v.mode, v.dtype, v.is_double) == (mode, torch.float64, True)
    assert v.n_channels == Variant(mode).n_channels
    assert Variant(mode).dtype == torch.float32 and not Variant(mode).is_double
    # polarized too since slice 6e: the flag is stored, as in the reference
    vp = Variant(mode + "_double", polarized=True)
    assert (vp.mode, vp.dtype, vp.polarized) == (mode, torch.float64, True)
    with pytest.raises(ValueError, match="float32 or float64"):
        Variant(mode, dtype=torch.float16)


def test_double_scene_widens_float_arrays_only():
    """Built in float32 and widened (the reference's scene/build.py
    :1081-1095): every floating tensor float64 and equal to the float32
    scene's, the integer ones untouched; the packed rows hold the ids as
    exact doubles, which row_views reads back as the float32 rows' ids."""
    d = cornell_box(8, 8, 4, 3)
    d["box"] = shapes_dict("cube")["s"]
    s32 = load_dict(d, Variant("rgb"), device="cpu")
    s64 = load_dict(d, Variant("rgb_double"), device="cpu")
    t32, t64 = s32.tensors(), s64.tensors()
    assert t32.keys() == t64.keys()
    for k, a in t32.items():
        b = t64[k]
        if a.is_floating_point():
            assert (a.dtype, b.dtype) == (torch.float32, torch.float64), k
            assert torch.equal(a.double(), b), k
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), k
    r32, r64 = s32.geo.tiles_rows, s64.geo.tiles_rows
    assert (r32.dtype, r64.dtype) == (torch.float32, torch.float64)
    for a, b in zip(intersect.row_views(r32), intersect.row_views(r64)):
        assert torch.equal(a.to(b.dtype), b)


def test_lane_pool_refuses_double():
    """The reference's pool fails in double (integrators/__init__.py
    :494-495), so the port's refuses it: render(regen=True),
    render_wavefront_regen and the path replay's autodiff.render raise;
    the scan driver renders."""
    scene = load_dict(cornell_box(4, 4, 4, 3), Variant("rgb_double"),
                      device="cpu")
    match = "reference's fails in double precision"
    with pytest.raises(NotImplementedError, match=match):
        integrators.render(scene, regen=True, samples_per_pass=16)
    with pytest.raises(NotImplementedError, match=match):
        integrators.render_wavefront_regen(scene, 16, 0, 4)
    pm = autodiff.traverse(scene).keep(["bsdfs.diffuse.reflectance"])
    with pytest.raises(NotImplementedError, match=match):
        autodiff.render(pm, pm.trainable(), regen=True, samples_per_pass=16)
    assert integrators.render(scene).dtype == torch.float64


def test_float32_variants_unchanged():
    """A float32 render is float32 throughout and bit-equal before and
    after a double render in the same process (no default dtype moves)."""
    d = cornell_box(8, 8, 4, 3)
    before = _film(d, "rgb", 2)
    assert before.dtype == np.float32
    _film(d, "rgb_double", 2)
    np.testing.assert_array_equal(_film(d, "rgb", 2), before)
    s32 = load_dict(d, Variant("rgb"), device="cpu")
    assert all(t.dtype in (torch.float32, torch.int32, torch.int64,
                           torch.bool) for t in s32.tensors().values())
    rows = load_dict(shapes_dict("cube"), Variant("rgb"),
                     device="cpu").geo
    assert rows.tiles_rows.dtype == torch.float32
    assert rows.tiles_prim.data_ptr() == rows.tiles_rows[..., 9].data_ptr()


# --- against the reference -------------------------------------------------

@pytest.mark.parametrize("shape,accel", [
    ("sphere", "analytic"), ("cube", "tiles"), ("cube", "bvh"),
    ("cube", "bvh8")])
def test_far_hits(ref, monkeypatch, shape, accel):
    """A unit sphere and the cube mesh from 1e5 away, through the plain
    sweep and both plain walks (ERT_ACCEL): float64 hits within 1e-6 of
    the distance, 100x closer than float32's, and the reference's float64
    brute-force hits within 1e-9."""
    if accel != "analytic":
        monkeypatch.setenv("ERT_ACCEL", accel)
    want = FAR - 1.0
    errs = {}
    for mode, dtype in (("rgb", torch.float32), ("rgb_double", torch.float64)):
        scene = load_dict(shapes_dict(shape), Variant(mode), device="cpu")
        o = torch.tensor([[0.0, 0.0, FAR], [0.25, -0.125, FAR]],
                         dtype=torch.float64).to(dtype)
        d = torch.tensor([[0.0, 0.0, -1.0]] * 2, dtype=dtype)
        before = dict(intersect.launches)
        t = ray_intersect(scene.geo, Ray.make(o, d)).t
        assert intersect.launches == before  # the plain versions
        assert t.dtype == dtype
        rows = 1 if shape == "sphere" else 2  # the sphere: on axis only
        errs[mode] = np.abs(t[:rows].double().numpy() - want).max()
        if dtype == torch.float64:
            np.testing.assert_allclose(t.numpy(), ref["t_" + shape],
                                       rtol=0, atol=1e-9)
    assert errs["rgb_double"] < 1e-6, errs
    assert errs["rgb_double"] < 1e-2 * errs["rgb"], errs


def test_sampler_draws_stay_float32(ref):
    """The draws are float32 and bit-equal to a float32 scene's and to the
    reference's under x64 (core/rng.py keeps them float32 in both); the
    camera rays they make are float64."""
    sampler = Sampler.seed(7, torch.arange(256))
    for i in range(3):
        sampler, u = sampler.next_1d()
        assert u.dtype == torch.float32
        np.testing.assert_array_equal(u.numpy(), ref[f"draw_{i}"])
    scene = load_dict(cornell_box(4, 4, 4, 3), Variant("rgb_double"),
                      device="cpu")
    sampler, ray, _w, pos = integrators._camera_lanes(
        scene, 1, 4, torch.arange(64))
    assert pos.dtype == torch.float32
    assert ray.o.dtype == ray.d.dtype == ray.maxt.dtype == torch.float64


def test_cornell_box_double_matches_reference(ref):
    """The Cornell box in rgb_double: a float64 film within 1e-3 of rgb's
    and the reference's x64 film sample for sample (tol 1e-7)."""
    d = cornell_box(8, 8, 16, 3)
    film = _film(d, "rgb_double", 1)
    assert film.dtype == np.float64
    np.testing.assert_allclose(film, _film(d, "rgb", 1), rtol=0, atol=1e-3)
    assert_driver_equivalent(ref["cbox"], film, max_flips=0, tol=1e-7)


@pytest.mark.parametrize("mode", MODES)
def test_atmosphere_double_matches_reference(ref, mode):
    """The atmosphere (17 x 16 x 16 grid, ground lowered) in each double
    mode on the scan driver against the reference's x64 film."""
    film = _film(lowered_atmosphere(), mode + "_double", 5)
    assert film.dtype == np.float64 and film[..., :3].mean() > 0.01
    assert_driver_equivalent(ref["atm_" + mode], film, max_flips=0,
                             tol=FILM_TOL[mode])


def test_slab_gradient_double_matches_reference(ref):
    """The 17^3 slab's grid gradient in rgb_double through the scan driver
    (autodiff.render(regen=False)) against the reference's x64 jax.grad."""
    scene = load_dict(slab_dict(grid_res=(17, 17, 17)), Variant("rgb_double"),
                      device="cpu")
    pm = autodiff.traverse(scene).keep([GRID])
    params = pm.trainable()
    img = autodiff.render(pm, params, seed=SEED, regen=False,
                          samples_per_pass=LANES)
    assert img.dtype == torch.float64
    img.mean().backward()
    grad = params[GRID].grad
    assert grad.dtype == torch.float64 and bool(grad.abs().sum() > 0)
    np.testing.assert_allclose(grad.numpy(), ref["slab_grad"], rtol=5e-5,
                               atol=1e-12)
