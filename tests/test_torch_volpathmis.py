"""The port's volpathmis (integrators/volpathmis.py) against the JAX
package's on the same inputs:

- (a) the weight-matrix updates ``_update``, ``_mis1`` and ``_mis2`` on
  seeded random pf, p and f arrays with zeros in f and p (infinite and NaN
  ratios, which both scrub to 0): within 1e-6 relative;
- (b) an 8x8 spp 4 atmosphere at max_depth 4 (its ground lowered by 1e-3,
  tests/test_torch_volpath.py's reason), on the scan driver and on a lane
  pool of 64 lanes, each against the reference's same driver within
  assert_driver_equivalent's budget of 4 pixels (the twin of
  tests/test_volpath.py::test_regen_volpathmis), and with a 17x16x16 grid
  (the packed-corner lookups) on the scan driver;
- (c) a chromatic absorbing slab (tests/test_volpath.py::
  test_volpathmis_chromatic_absorption_unbiased's, at max_depth 6: the
  reference's max_depth 24 compile has crashed XLA on the CPU) through a
  radiancemeter: the port's film within 1e-4 of the reference's, and the
  transmittance exp(-2 sigma_t) within 3 % in every channel;
- (d) the scan driver's gradient of the mean image with respect to the
  sigma_t and albedo grids of tests/test_torch_replay.py's seeded slab
  (8x8 spp 4, max_depth 3) against ``jax.grad`` of the reference's scan
  driver, at rtol 5e-3 and atol 1e-7;
- (e) ``render(regen=True)`` under autograd raises and names the scan
  driver, for volpathmis and for a wrapper.

Each reference render is made once (module-scoped fixtures)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.integrators import volpathmis as jvpm
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.core.spectrum import xyz_to_srgb
from eradiate_kernel_tpu_torch.integrators import volpathmis as vpm
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere
from test_torch_replay import slab_dict

SEED, SPP, LANES = 2, 4, 64
RTOL, ATOL = 5e-3, 1e-7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (tests/test_torch_sensors.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- (a) the weight-matrix updates -----------------------------------------

def _weights(seed, n=512, nc=3):
    rng = np.random.default_rng(seed)
    pf = rng.uniform(0.0, 4.0, (n, nc, nc)).astype(np.float32)
    p = rng.uniform(0.0, 2.0, (n, nc)).astype(np.float32)
    f = rng.uniform(0.0, 2.0, (n, nc)).astype(np.float32)
    # zeros: p/0 = inf and 0/0 = NaN ratios, zero rows of pf
    p[rng.random((n, nc)) < 0.1] = 0.0
    f[rng.random((n, nc)) < 0.1] = 0.0
    pf[rng.random(n) < 0.1] = 0.0
    pf[rng.random((n, nc, nc)) < 0.02] = np.inf
    active = rng.random(n) < 0.8
    return pf, p, f, active


@pytest.mark.parametrize("seed", [0, 1])
def test_weight_updates_match_reference(seed):
    pf, p, f, active = _weights(seed)
    t = lambda a: torch.as_tensor(a)
    got = vpm._update(t(pf), t(p), t(f), t(active)).numpy()
    ref = np.asarray(jvpm._update(jnp.asarray(pf), jnp.asarray(p),
                                  jnp.asarray(f), jnp.asarray(active)))
    assert not np.isfinite(pf).all() and np.isfinite(ref[active]).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    fin = np.where(np.isfinite(pf), pf, 0.0).astype(np.float32)
    pf2 = np.roll(fin, 1, axis=0)
    np.testing.assert_allclose(vpm._mis1(t(fin)).numpy(),
                               np.asarray(jvpm._mis1(jnp.asarray(fin))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        vpm._mis2(t(fin), t(pf2)).numpy(),
        np.asarray(jvpm._mis2(jnp.asarray(fin), jnp.asarray(pf2))),
        rtol=1e-6)
    assert (np.asarray(jvpm._mis1(jnp.asarray(fin))) == 0).any()


# ---- (b) the atmosphere on both drivers ------------------------------------

def atmosphere_mis(grid_res=64, width=8, max_depth=4):
    d = atmosphere(width, width, SPP, max_depth, grid_res=grid_res)
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    d["integrator"]["type"] = "volpathmis"
    return d


_REF = {}


def reference(case):
    """The reference's film of a case, rendered once."""
    if case not in _REF:
        grid_res, driver = {"grid64 scan": (64, "scan"),
                            "grid64 pool": (64, "pool"),
                            "grid17x16x16 scan": ((17, 16, 16), "scan")}[case]
        scene = jload_dict(atmosphere_mis(grid_res))
        if driver == "pool":
            run = jax.jit(jintegrators.render_wavefront_regen,
                          static_argnames=("n_lanes", "spp"))
            film, _rays = run(scene, LANES, SEED, SPP)
        else:
            run = jax.jit(jintegrators.render_wavefront,
                          static_argnames=("n_lanes", "spp"))
            film = run(scene, jnp.uint32(0), 8 * 8 * SPP, SEED, SPP)
        _REF[case] = np.asarray(film)
    return _REF[case]


@pytest.mark.parametrize("case", ["grid64 scan", "grid64 pool",
                                  "grid17x16x16 scan"])
def test_atmosphere_film_matches_reference(case):
    grid_res = (17, 16, 16) if case.startswith("grid17") else 64
    scene = load_dict(atmosphere_mis(grid_res), device="cpu")
    assert (scene.vol_packed is not None) == (grid_res != 64)
    if case.endswith("pool"):
        assert integrators.regen_supported(scene.config)
        stats = {}
        film, rays = integrators.render_wavefront_regen(scene, LANES, SEED,
                                                        SPP, stats=stats)
        assert stats["dropped"] == 0 and stats["iterations"] > 4
    else:
        film = integrators.render_wavefront(scene, 0, 8 * 8 * SPP, SEED, SPP)
    film = film.numpy()
    ref = reference(case)
    assert film.shape == ref.shape == (8, 8, 5)
    assert np.isfinite(film).all() and film[..., :3].mean() > 0.05
    np.testing.assert_array_equal(film[..., 4], SPP)
    assert_driver_equivalent(ref, film, max_flips=4)


def test_pool_matches_scan_driver():
    """The pool and the scan driver draw the same samples (the pool's
    bounce gates are off, the scan's on)."""
    scene = load_dict(atmosphere_mis(), device="cpu")
    scan = integrators.render(scene, seed=SEED, develop_film=False)
    pool = integrators.render(scene, seed=SEED, develop_film=False,
                              regen=True, samples_per_pass=LANES)
    assert_driver_equivalent(scan.numpy(), pool.numpy(), max_flips=0,
                             tol=1e-6)


# ---- (c) a chromatic absorbing slab ----------------------------------------

SIGMA = [0.2, 1.0, 3.0]


def chromatic_slab(spp):
    return {
        "type": "scene",
        "integrator": {"type": "volpathmis", "max_depth": 6},
        "sensor": {"type": "radiancemeter",
                   "to_world": {"type": "look_at", "origin": [0, 0, -3],
                                "target": [0, 0, 1], "up": [0, 1, 0]},
                   "film": {"width": 1, "height": 1,
                            "rfilter": {"type": "box"}},
                   "sampler": {"sample_count": spp}},
        "slab": {"type": "cube", "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous",
                              "sigma_t": {"type": "rgb", "value": SIGMA},
                              "albedo": 0.0}},
        "env": {"type": "constant", "radiance": 1.0},
    }


def test_chromatic_absorption_matches_reference():
    d = chromatic_slab(256)
    ref = np.asarray(jintegrators.render(jload_dict(d), seed=5,
                                         develop_film=False))
    scene = load_dict(d, device="cpu")
    film = integrators.render(scene, seed=5, develop_film=False).numpy()
    assert_driver_equivalent(ref, film, max_flips=0)
    # the spectral MIS estimate of exp(-2 sigma_t) over the slab's 2 units
    big = load_dict(chromatic_slab(16384), device="cpu")
    img = integrators.render(big, seed=6, develop_film=False)
    rgb = xyz_to_srgb(img[..., :3] / img[..., 4:5]).numpy()[0, 0]
    np.testing.assert_allclose(rgb, np.exp(-2 * np.array(SIGMA)), rtol=0.03)


# ---- (d) the scan driver's gradient ----------------------------------------

GRID = "volumes.gridvolume.grid"


def _grid_parts(scene, g):
    a = {k: v.detach().cpu().numpy() for k, v in scene.tensors().items()}
    het = "media.heterogeneous."
    slot = lambda vol: int(a["vol_slot"][a[het + vol][0]])
    return {"sigma_t grid": g[slot("sigma_t_vol")],
            "albedo grid": g[slot("albedo_vol")]}


def test_scan_gradient_matches_reference():
    d = slab_dict(width=8, spp=SPP, max_depth=3)
    d["integrator"]["type"] = "volpathmis"
    scene = load_dict(d, device="cpu")
    pm = autodiff.traverse(scene).keep([GRID])
    params = pm.trainable()
    img = integrators.render(pm.with_trainable(params), seed=SEED)
    img.mean().backward()
    got = _grid_parts(scene, params[GRID].grad.numpy())

    jpm = jad.traverse(jload_dict(d))
    jpm.keep([GRID])
    tr0 = jpm.trainable()
    g = jax.grad(lambda tr: jnp.mean(jintegrators.render(
        jpm.with_trainable(tr), seed=SEED)))(tr0)
    ref = _grid_parts(scene, np.asarray(g[GRID]))
    for name in ("sigma_t grid", "albedo grid"):
        a, b = got[name], ref[name]
        assert np.isfinite(b).all() and np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


# ---- (e) the pool has no backward for these integrators --------------------

@pytest.mark.parametrize("kind", ["volpathmis", "moment"])
def test_regen_under_autograd_names_the_scan_driver(kind):
    d = slab_dict(width=4, spp=1, max_depth=2)
    if kind == "moment":
        d["integrator"] = {"type": "moment", "child": d["integrator"]}
    else:
        d["integrator"]["type"] = kind
    scene = load_dict(d, device="cpu")
    pm = autodiff.traverse(scene).keep([GRID])
    params = pm.trainable()
    with pytest.raises(NotImplementedError, match=r"scan driver"):
        integrators.render(pm.with_trainable(params), regen=True,
                           samples_per_pass=16)
    # without a tensor that requires a gradient the pool renders
    with torch.no_grad():
        img = integrators.render(pm.with_trainable(params), regen=True,
                                 samples_per_pass=16)
    assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
