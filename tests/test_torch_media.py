"""The port's media (media/__init__.py), phase functions and medium scene
arrays against the reference on the same seeded inputs: the majorant,
control and residual profiles and the atmosphere's scene arrays bit for
bit; free-flight sampling, transmittance, optical depths, residual
collisions and the Rayleigh phase function within float32 tolerances."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_scene import port_config, reference_arrays
from eradiate_kernel_tpu import media as jmedia
from eradiate_kernel_tpu import phase as jphase
from eradiate_kernel_tpu.core.math import INVALID_T
from eradiate_kernel_tpu.core.ray import Ray as JRay
from eradiate_kernel_tpu.scene import build_spectra as jbs
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch import media, phase
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.scene import build_spectra, from_numpy, load_dict
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

# float32 arithmetic of the same expressions; the reference's XLA program
# contracts multiply-adds, eager torch rounds each product and sum
RTOL, ATOL = 1e-5, 1e-6


def _grid_row(kind, shape, wrap=0, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "constvolume":
        return {"value": np.asarray([0.7], np.float32)}
    return {"grid": rng.random(shape).astype(np.float32),
            "wrap": np.int32(wrap)}


@pytest.mark.parametrize("kind, shape, wrap", [
    ("gridvolume", (17, 6, 5, 1), 0),
    ("gridvolume", (9, 3, 70, 1), 0),
    ("gridvolume", (5, 4, 4, 3), 0),
    ("gridvolume", (6, 5, 4, 1), 1),
    ("constvolume", None, 0),
])
def test_build_profiles_bit_equal(kind, shape, wrap):
    row = _grid_row(kind, shape, wrap)
    vmax = float(row["grid"].max()) if "grid" in row else 0.7
    np.testing.assert_array_equal(
        build_spectra._axis_majorant_profiles(row, vmax),
        jbs._axis_majorant_profiles(row, vmax))
    for a, b in zip(build_spectra._control_and_residual_profiles(kind, row,
                                                                 vmax),
                    jbs._control_and_residual_profiles(kind, row, vmax)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("grid_res", [64, (17, 16, 16)], ids=["1d", "3d"])
def test_atmosphere_arrays_bit_equal(grid_res):
    d = atmosphere(8, 8, 4, 6, grid_res=grid_res)
    ref_scene = jload_dict(d)
    ref = reference_arrays(ref_scene)
    scene = load_dict(d, device="cpu")
    arrays = scene.arrays()
    for name in ("media.heterogeneous.resprof", "volumes.gridvolume.grid",
                 "phases.rayleigh._pad", "shape_interior", "medium_phase"):
        assert name in arrays
    for name, a in arrays.items():
        assert a.shape == ref[name].shape, name
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    assert scene.config == port_config(ref_scene.config)
    assert scene.config.het_profile1d == (grid_res == 64)
    carried = from_numpy(ref, port_config(ref_scene.config), device="cpu")
    for name, a in carried.arrays().items():
        np.testing.assert_array_equal(a, arrays[name], err_msg=name)
    if scene.vol_packed is not None:
        assert torch.equal(carried.vol_packed, scene.vol_packed)


_SCENES = {}


def _scenes(grid_res):
    """(reference scene, port scene) of the atmosphere, built once."""
    if grid_res not in _SCENES:
        d = atmosphere(8, 8, 4, 6, grid_res=grid_res)
        _SCENES[grid_res] = (jload_dict(d), load_dict(d, device="cpu"))
    return _SCENES[grid_res]


GRIDS = pytest.mark.parametrize("grid_res", [64, (17, 16, 16)],
                                ids=["1d", "3d"])


def _rays(n, seed, maxt=None):
    """Rays from inside the atmosphere slab in random directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-15, -15, 0.05], [15, 15, 0.95], (n, 3))
    d = rng.normal(size=(n, 3))
    d[: n // 8, 2] = 0.0  # some horizontal rays (constant-rate lanes)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    mint = np.zeros(n, np.float32)
    if maxt is None:
        maxt = np.full(n, INVALID_T, np.float32)
    jray = JRay(o=jnp.asarray(o), d=jnp.asarray(d), mint=jnp.asarray(mint),
                maxt=jnp.asarray(maxt), time=jnp.zeros(n),
                wavelengths=jnp.zeros((n, 0)))
    pray = Ray(o=torch.as_tensor(o), d=torch.as_tensor(d),
               mint=torch.as_tensor(mint), maxt=torch.as_tensor(maxt),
               time=torch.zeros(n))
    return jray, pray


def _close(out, ref, name):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=name)


@GRIDS
def test_sample_interaction_and_tr(grid_res):
    jscene, scene = _scenes(grid_res)
    n = 1024
    rng = np.random.default_rng(7)
    jray, pray = _rays(n, 7)
    xi = rng.random(n).astype(np.float32)
    ch = rng.integers(0, 3, n).astype(np.int32)
    active = rng.random(n) < 0.9
    med = np.zeros(n, np.int32)
    ref = jmedia.sample_interaction(jscene, jnp.asarray(med), jray,
                                    jnp.asarray(xi), jnp.asarray(ch),
                                    jnp.asarray(active))
    mi = media.sample_interaction(scene, torch.as_tensor(med), pray,
                                  torch.as_tensor(xi), torch.as_tensor(ch),
                                  torch.as_tensor(active))
    assert np.asarray(ref.is_valid).sum() > n // 4
    for f in dataclasses.fields(mi):
        a, b = getattr(mi, f.name).numpy(), np.asarray(getattr(ref, f.name))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            _close(a, b, f.name)

    # transmittance and pdf of the reference's interaction at surface hits
    # before, at and after the sampled event
    si_t = np.asarray(ref.t) * rng.choice([0.5, 1.0, 2.0], n)
    si_t = np.minimum(si_t, INVALID_T).astype(np.float32)
    jtr, jpdf = jmedia.eval_tr_and_pdf(ref, jnp.asarray(si_t))
    pmi = media.MediumInteraction(**{
        f.name: torch.as_tensor(np.array(getattr(ref, f.name)))
        for f in dataclasses.fields(mi)})
    tr, pdf = media.eval_tr_and_pdf(pmi, torch.as_tensor(si_t))
    _close(tr, jtr, "tr")
    _close(pdf, jpdf, "pdf")


def _segments(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 2.0, n).astype(np.float32)
    b = (a + rng.uniform(0.0, 8.0, n)).astype(np.float32)
    return a, b


def test_medium_tau_segment_closed_form():
    # the plane-parallel closed form (3D grids take the Gauss-Legendre
    # quadrature: tests/test_torch_nee_modes.py)
    jscene, scene = _scenes(64)
    assert scene.config.het_profile1d
    n = 1024
    jray, pray = _rays(n, 8)
    a, b = _segments(n, 8)
    med = np.zeros(n, np.int32)
    ref = jmedia.medium_tau_segment(jscene, jnp.asarray(med), jray,
                                    jnp.asarray(a), jnp.asarray(b),
                                    jray.wavelengths)
    out = media.medium_tau_segment(scene, torch.as_tensor(med), pray,
                                   torch.as_tensor(a), torch.as_tensor(b),
                                   pray.wavelengths)
    assert np.asarray(ref).max() > 0.01
    _close(out, ref, "tau")


@GRIDS
def test_residual_walk_pieces(grid_res):
    jscene, scene = _scenes(grid_res)
    n = 1024
    rng = np.random.default_rng(9)
    jray, pray = _rays(n, 9)
    a, b = _segments(n, 9)
    xi = rng.random(n).astype(np.float32)
    med = np.zeros(n, np.int32)
    jm, pm = jnp.asarray(med), torch.as_tensor(med)
    ref = jmedia.medium_residual_sample(jscene, jm, jray, jnp.asarray(a),
                                        jnp.asarray(b), jnp.asarray(xi))
    out = media.medium_residual_sample(scene, pm, pray, torch.as_tensor(a),
                                       torch.as_tensor(b),
                                       torch.as_tensor(xi))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    assert np.asarray(ref[0]).any() == (not scene.config.het_profile1d)
    for k, name in ((1, "dt"), (2, "rate")):
        _close(out[k], ref[k], name)
    tau = media.medium_ctrl_tau_segment(scene, pm, pray, torch.as_tensor(a),
                                        torch.as_tensor(b), pray.wavelengths)
    jtau = jmedia.medium_ctrl_tau_segment(jscene, jm, jray, jnp.asarray(a),
                                          jnp.asarray(b), jray.wavelengths)
    _close(tau, jtau, "ctrl tau")
    p = jray.o + jray.d * jnp.asarray(b)[:, None]
    for fn in ("medium_ctrl_sigma", "medium_sigma_t"):
        ref_v = getattr(jmedia, fn)(jscene, jm, p, jray.wavelengths)
        out_v = getattr(media, fn)(scene, pm, torch.as_tensor(np.array(p)),
                                   pray.wavelengths)
        _close(out_v, ref_v, fn)


def test_rayleigh_phase():
    jscene, scene = _scenes(64)
    n = 2048
    rng = np.random.default_rng(10)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    s1 = rng.random(n).astype(np.float32)
    s2 = rng.random((n, 2)).astype(np.float32)
    idx = np.zeros(n, np.int32)
    jwo, jpdf = jphase.phase_sample(jscene, jnp.asarray(idx), jnp.asarray(d),
                                    jnp.asarray(s1), jnp.asarray(s2))
    wo, pdf = phase.phase_sample(scene, torch.as_tensor(idx),
                                 torch.as_tensor(d), torch.as_tensor(s1),
                                 torch.as_tensor(s2))
    # torch has no cbrt: the inverse cdf's two cube roots are |x|^(1/3)
    # with the sign put back, a few ulps from jnp.cbrt
    _close(wo, jwo, "wo")
    _close(pdf, jpdf, "pdf")
    ref = jphase.phase_eval(jscene, jnp.asarray(idx), jnp.asarray(-d), jwo)
    out = phase.phase_eval(scene, torch.as_tensor(idx), torch.as_tensor(-d),
                           torch.as_tensor(np.array(jwo)))
    _close(out, ref, "phase_eval")
    assert np.asarray(ref).min() >= 3 / (16 * np.pi) * 0.999
