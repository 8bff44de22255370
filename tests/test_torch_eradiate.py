"""Eradiate's surface and measurement in the port against the JAX package
and against closed forms that share no code with either:

- bilambertian's eval, pdf and sample against the reference's on the same
  directions and samples (rtol 1e-5, atol 1e-6: a grazing cosine-warp
  sample differs by an ulp of z), its closed form and its white-sky albedo
  (tests/test_eradiate_oracles.py);
- the single-scattering closed form of
  tests/test_single_scattering_oracle.py (sky plus ground at one
  scattering order through a 1x1 distant sensor) at the reference's gate,
  |mean - closed form| < 4 sigma + 0.005 expected, over 4 seeds of 512 spp
  (the reference's 2,048 cut so that each case takes a few seconds here;
  sigma grows to match);
- a gradient through a distant sensor with cross-section targeting (an
  aperture draw before the wavelength draw in every replayed camera ray):
  the port's path replay against the reference's jax.grad at rtol 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.bsdfs import bsdf_sample as jbsdf_sample
from eradiate_kernel_tpu.core.rng import Sampler as JSampler
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu_torch import bsdfs, integrators
from eradiate_kernel_tpu_torch.core.rng import Sampler
from eradiate_kernel_tpu_torch.render.records import invalid_si
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff
from test_eradiate_oracles import _eval as jeval
from test_eradiate_oracles import _scene_si as jscene_si
from test_eradiate_oracles import sph_dirs
from test_single_scattering_oracle import CASES, _closed_form, _slab_scene
from test_torch_sensors import one_torch_thread  # noqa: F401


def _bilambertian(r, t):
    return {"type": "bilambertian", "reflectance": r, "transmittance": t}


def _port_si(bsdf, wi):
    scene = load_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "film": {"width": 2, "height": 2}},
        "rect": {"type": "rectangle", "bsdf": bsdf}}, device="cpu")
    n = wi.shape[0]
    si = dataclasses.replace(invalid_si(n, 0, device="cpu"), t=torch.ones(n),
                             wi=torch.as_tensor(wi),
                             shape_index=torch.zeros(n, dtype=torch.int32))
    return scene, si


def _directions(n, seed):
    rng = np.random.default_rng(seed)
    return (sph_dirs(rng.random(n) * np.pi, rng.random(n) * 2 * np.pi),
            sph_dirs(rng.random(n) * np.pi, rng.random(n) * 2 * np.pi))


@pytest.mark.parametrize("r,t", [(0.3, 0.6), (0.25, 0.55), (0.0, 0.4),
                                 ([0.2, 0.5, 0.1], [0.4, 0.1, 0.3])])
def test_bilambertian_matches_reference(r, t):
    """eval and pdf on both sides of the surface, and sample from the same
    sampler stream, against the reference, and eval against the
    closed form value = (r | t) |cos_o| / pi, pdf = the lobe's share times
    the cosine pdf (bilambertian.cpp:112-175)."""
    bsdf = _bilambertian(r, t)
    n = 512
    wi, wo = _directions(n, 11)
    scene, si = _port_si(bsdf, wi)
    idx = torch.zeros(n, dtype=torch.int32)
    on = torch.ones(n, dtype=torch.bool)
    val, pdf = bsdfs.bsdf_eval_pdf(scene, idx, si, torch.as_tensor(wo), on)
    jval, jpdf = jeval(bsdf, wi, wo)
    np.testing.assert_allclose(val.numpy(), jval, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), jpdf, rtol=1e-5, atol=1e-6)
    rr, tt = np.broadcast_to(r, 3), np.broadcast_to(t, 3)
    same = (np.sign(wi[:, 2]) == np.sign(wo[:, 2]))[:, None]
    np.testing.assert_allclose(
        val.numpy(), np.where(same, rr, tt) * np.abs(wo[:, 2:]) / np.pi,
        rtol=1e-5, atol=1e-6)

    smp, s1 = Sampler.seed(3, torch.arange(n)).next_1d()
    _smp, s2 = smp.next_2d()
    bs, w = bsdfs.bsdf_sample(scene, idx, si, s1, s2, on)
    jscene, jsi = jscene_si(bsdf, wi)
    jsmp, js1 = JSampler.seed(3, jnp.arange(n, dtype=jnp.uint32)).next_1d()
    _j, js2 = jsmp.next_2d()
    jbs, jw = jbsdf_sample(jscene, jnp.zeros(n, jnp.int32), jsi, js1, js2,
                           jnp.ones(n, bool))
    np.testing.assert_allclose(bs.wo.numpy(), np.asarray(jbs.wo), atol=1e-6)
    np.testing.assert_allclose(bs.pdf.numpy(), np.asarray(jbs.pdf),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(bs.sampled_type.numpy(),
                                  np.asarray(jbs.sampled_type))


def test_bilambertian_white_sky_albedo():
    """E[weight] = r + t, each lobe carrying its own albedo
    (tests/test_eradiate_oracles.py)."""
    r, t = 0.25, 0.55
    n = 200_000
    wi = np.tile(np.asarray([[0.0, 0.6, 0.8]], np.float32), (n, 1))
    scene, si = _port_si(_bilambertian(r, t), wi)
    smp, s1 = Sampler.seed(3, torch.arange(n)).next_1d()
    _smp, s2 = smp.next_2d()
    bs, weight = bsdfs.bsdf_sample(scene, torch.zeros(n, dtype=torch.int32),
                                   si, s1, s2, torch.ones(n, dtype=torch.bool))
    weight = weight[:, 0].numpy()
    reflect = bs.wo[:, 2].numpy() > 0
    assert abs(weight.mean() - (r + t)) < 5e-3
    assert abs(weight[reflect].sum() / n - r) < 5e-3
    assert abs(weight[~reflect].sum() / n - t) < 5e-3


SPP, SEEDS = 512, 4


@pytest.mark.parametrize("kind,albedo,rho,phase,d_sun,d_view", CASES)
def test_single_scattering_closed_form(kind, albedo, rho, phase, d_sun,
                                       d_view):
    D = 16
    z = (np.arange(D) + 0.5) / D
    if kind == "exp":
        profile = np.exp(-z / 0.25)
        profile *= 0.5 / profile.mean()
    else:
        profile = 0.8 * (1.0 - z) + 0.1
    l_sky, l_ground = _closed_form(profile, albedo, rho, phase, d_sun,
                                   d_view)
    expected = l_sky + l_ground
    scene = load_dict(_slab_scene(profile, albedo, rho, phase, d_sun,
                                  d_view, spp=SPP), device="cpu")
    vals = np.asarray([float(integrators.render(
        scene, seed=100 + s, regen=True, samples_per_pass=SPP).mean())
        for s in range(SEEDS)])
    mean, stderr = vals.mean(), vals.std(ddof=1) / np.sqrt(SEEDS)
    tol = 4.0 * stderr + 0.005 * expected
    assert abs(mean - expected) < tol, (mean, expected, stderr)


def _cross_section_slab():
    """The slab of the single-scattering test under a 1x1 distant sensor
    with cross-section targeting (no ``target``), RR from depth 1, a
    seeded 2x2x2 sigma_t grid."""
    profile = np.linspace(0.6, 0.2, 16)
    d = _slab_scene(profile, 0.8, 0.3, "rayleigh", (0.3, 0.0, -0.954),
                    (0.2, 0.1, -0.97), spp=64)
    del d["sensor"]["target"]
    d["integrator"].update(max_depth=4, rr_depth=1)
    d["atmo"]["interior"]["sigma_t"]["data"] = (
        0.2 + 0.6 * np.random.default_rng(3).random((2, 2, 2))
    ).astype(np.float32)
    return d


def test_distant_sensor_gradient_matches_reference():
    """d(film)/d(the sigma_t grid and the spectra) through the port's path
    replay (the hoisted pass regenerates every camera ray with its
    aperture draw) against the reference's jax.grad of its replay."""
    keys = ["volumes.gridvolume.grid", "spectra.baked.value"]
    d = _cross_section_slab()
    scene = load_dict(d, device="cpu")
    pm = autodiff.traverse(scene).keep(keys)
    params = pm.trainable()
    integrators.render(pm.with_trainable(params), seed=5, regen=True,
                       samples_per_pass=24).mean().backward()
    jpm = jad.traverse(jload_dict(d))
    jpm.keep(keys)

    def loss(tr):
        return jnp.mean(jintegrators.render(jpm.with_trainable(tr), seed=5,
                                            samples_per_pass=24, regen=True))

    ref = jax.grad(loss)(jpm.trainable())
    for k in keys:
        g, rk = params[k].grad.numpy(), np.asarray(ref[k])
        ok = np.isfinite(rk)
        assert ok.any() and np.abs(rk[ok]).sum() > 0, k
        assert np.isfinite(g[ok]).all(), k
        np.testing.assert_allclose(g[ok], rk[ok], rtol=5e-3, atol=1e-7,
                                   err_msg=k)
