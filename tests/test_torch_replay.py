"""The port's gradients of the atmosphere path (integrators/replay.py, the
detach discipline, the sample log) against the JAX package's on the same
seeded scene: a heterogeneous slab (the atmosphere cube of
utils.scenes.atmosphere with a null BSDF and 2x2x2 gridvolume sigma_t and
albedo from np.random.default_rng(3)) over the atmosphere's RPV ground,
lit by the directional sun and seen by the perspective camera; 4x4 film,
16 spp, max_depth 6, RR from depth 1 (so the RR probability is live), 48
lanes for the render and 80 for the replay (many refills of both pools).
The ground is lowered by 1e-3 to remove its tie with the cube's bottom face
(tests/test_torch_volpath.py's docstring).

The reference's radiancemeter and constant emitter are not in the port
(volpath takes delta emitters only so far), hence the sun and the camera.
Gradients are compared at rtol 5e-3 and atol 1e-7 (tests/test_autodiff.py's
replay-vs-scan figure). The RPV rows of spectra.baked.value (rho_0, g, k)
have NaN gradients in the reference (its RPV value is NaN in lanes that
the BSDF masks, and the mask's zero cotangent times NaN is NaN), so the
spectrum is compared on its irradiance row, the sun's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.films import develop
from eradiate_kernel_tpu_torch.integrators import replay
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere
from test_torch_sensors import one_torch_thread  # noqa: F401

SEED, SPP, LANES, REPLAY_LANES = 11, 16, 48, 80
KEYS = ["volumes.gridvolume.grid", "spectra.baked.value",
        "media.heterogeneous.majorant"]
RTOL, ATOL = 5e-3, 1e-7


def slab_dict(width=4, spp=SPP, grid_res=(2, 2, 2), max_depth=6, seed=3):
    """The atmosphere with a seeded heterogeneous slab: sigma_t in
    [0.2, 0.8] and albedo in [0.3, 0.8] on ``grid_res`` grids."""
    rng = np.random.default_rng(seed)
    d = atmosphere(width, width, spp, max_depth, grid_res=64)
    interior = d["atmo"]["interior"]
    tw = interior["sigma_t"]["to_world"]
    interior["sigma_t"]["data"] = (
        0.2 + 0.6 * rng.random(grid_res)).astype(np.float32)
    interior["albedo"] = {"type": "gridvolume", "to_world": tw, "data": (
        0.3 + 0.5 * rng.random(grid_res)).astype(np.float32)}
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    d["integrator"].update(rr_depth=1, replay_lanes=REPLAY_LANES)
    return d


def parts(scene, tensors):
    """The compared parts of the gradients of KEYS, as numpy (None: the
    tensor was not used, a zero gradient): the sigma_t and the albedo
    slots of the grid, the sun's row of the spectra, the majorant."""
    a = {k: v.detach().cpu().numpy() for k, v in scene.tensors().items()}
    het = "media.heterogeneous."
    slot = lambda vol: int(a["vol_slot"][a[het + vol][0]])
    sun = int(a["spec_slot"][a["emitters.directional.irradiance"][0]])
    grid, spec, maj = (np.zeros_like(a[k]) if tensors[k] is None
                       else np.asarray(tensors[k]) for k in KEYS)
    return {"sigma_t grid": grid[slot("sigma_t_vol")],
            "albedo grid": grid[slot("albedo_vol")],
            "irradiance": spec[sun], "majorant": maj}


def port_grads(scene, regen):
    pm = autodiff.traverse(scene).keep(KEYS)
    params = pm.trainable()
    img = integrators.render(pm.with_trainable(params), seed=SEED,
                             samples_per_pass=LANES, regen=regen)
    img.mean().backward()
    return parts(scene, {k: None if p.grad is None else p.grad.numpy()
                         for k, p in params.items()})


@pytest.fixture(scope="module")
def case():
    """The port's scene and its gradients through both drivers, and the
    reference's through both, computed once. The reference's replay runs
    with ERT_REPLAY_KW='{"prb_walks": true}' (tests/test_autodiff.py:391),
    which off its TPU is also its default (_REPLAY_BOUNCE_KWARGS). The
    reference's scan driver renders its 256 samples in one pass (its
    passes split no sample's arithmetic, only the film's sums, and one
    pass compiles in half the time of six); the lane pool's film and the
    replay's loop iterations are kept for the tests that read them."""
    d = slab_dict()
    scene = load_dict(d, device="cpu")
    jscene = jload_dict(d)
    pm = jad.traverse(jscene)
    pm.keep(KEYS)
    tr0 = pm.trainable()

    def ref_grads(regen):
        def loss(tr):
            return jnp.mean(jintegrators.render(
                pm.with_trainable(tr), seed=SEED,
                samples_per_pass=LANES if regen else 4 * 4 * SPP,
                regen=regen))
        g = jax.grad(loss)(tr0)
        return parts(scene, {k: np.asarray(g[k]) for k in KEYS})

    out = {"scene": scene, "jscene": jscene,
           "ref_scan": ref_grads(False), "scan": port_grads(scene, False)}
    before = dict(replay.counters)
    out["replay"] = port_grads(scene, True)
    out["iterations"] = {k: replay.counters[k] - before[k] for k in before}
    out["pool_film"] = integrators.render_wavefront_regen(scene, LANES, SEED,
                                                         SPP)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ERT_REPLAY_KW", json.dumps({"prb_walks": True}))
        out["ref_replay"] = ref_grads(True)
    return out


PARTS = ["sigma_t grid", "albedo grid", "irradiance", "majorant"]


def _close(a, b, what):
    assert np.isfinite(a).all() and np.isfinite(b).all(), what
    assert np.allclose(a, b, rtol=RTOL, atol=ATOL), \
        (what, np.abs(a - b).max(), np.abs(b).max())


@pytest.mark.parametrize("part", PARTS)
def test_scan_grad_matches_reference(case, part):
    """loss.backward() through the port's scan driver against jax.grad
    through the reference's. The majorant's gradient is zero in both: the
    majorants are detached sampling parameters. Without the detach
    discipline the sigma_t grid's gradient also takes the derivative of
    the detached sigma_n and sigma_t divisors and of the RR probability."""
    _close(case["scan"][part], case["ref_scan"][part], part)
    if part != "majorant":
        assert np.abs(case["scan"][part]).sum() > 0


@pytest.mark.parametrize("part", PARTS)
def test_replay_grad_matches_reference(case, part):
    """The port's path-replay gradient against the reference's, and
    against the port's own scan driver."""
    _close(case["replay"][part], case["ref_replay"][part], part)
    _close(case["replay"][part], case["scan"][part], part)


def test_walk_grad_matches_reference_prb_walks(case):
    """The replay differentiates the early-exiting NEE walk by autograd
    over its executed steps; the reference's PRB walk (ERT_REPLAY_KW
    prb_walks, its custom_vjp over the executed steps) gives the same grid
    gradient. The residual walk runs: the 2x2x2 grid is no vertical
    profile."""
    assert not case["scene"].config.het_profile1d
    for part in ("sigma_t grid", "albedo grid"):
        _close(case["replay"][part], case["ref_replay"][part], part)


def test_replay_primal_film_is_the_lane_pool_film(case):
    """The Function's primal film is render_wavefront_regen's, bit for bit,
    and render(regen=True) develops the same film with autograd on or
    off."""
    scene = case["scene"]
    film = case["pool_film"]  # render_wavefront_regen(scene, LANES, ...)
    pm = autodiff.traverse(scene).keep(KEYS)
    params = pm.trainable()
    diff = replay.render_regen_diff(pm.with_trainable(params), SEED, LANES,
                                    SPP)
    assert diff.grad_fn is not None
    assert torch.equal(diff.detach(), film)
    img = integrators.render(scene, seed=SEED, samples_per_pass=LANES,
                             regen=True)
    assert torch.equal(img, develop(film))
    img_diff = integrators.render(pm.with_trainable(params), seed=SEED,
                                  samples_per_pass=LANES, regen=True)
    assert torch.equal(img_diff.detach(), img)


def test_geo_gets_no_gradient_through_the_replay(case):
    """The geo subtree is trajectory-class: the replay leaves it out, so a
    geo tensor that requires a gradient gets none."""
    pm = autodiff.traverse(case["scene"]).keep(["geo.vertices", KEYS[0]])
    params = pm.trainable()
    img = integrators.render(pm.with_trainable(params), seed=SEED,
                             samples_per_pass=LANES, regen=True)
    img.mean().backward()
    assert params["geo.vertices"].grad is None
    assert params[KEYS[0]].grad.abs().sum() > 0


def test_sample_log_matches_reference(case):
    """Row s of the sample log is sample s's result before the ray weight:
    the reference's third output of render_wavefront_regen(...,
    sample_log=True), within assert_driver_equivalent's flip budget (a
    sample whose path took the other side of a decision, see
    tests/test_torch_volpath.py), and the film's rows sum to the film."""
    run = jax.jit(jintegrators.render_wavefront_regen,
                  static_argnames=("n_lanes", "spp", "sample_log"))
    _f, _r, ref_log = run(case["jscene"], n_lanes=LANES, seed=SEED, spp=SPP,
                          sample_log=True)
    scene = case["scene"]
    film, _rays, log = integrators.render_wavefront_regen(
        scene, LANES, SEED, SPP, sample_log=True)
    total = 4 * 4 * SPP
    assert log.shape == (total, 3)
    ref_log = np.asarray(ref_log)[:total]
    assert np.abs(ref_log).sum() > 0
    assert_driver_equivalent(ref_log, log.numpy(), max_flips=2)
    assert torch.equal(film, case["pool_film"])  # the film without the log


def test_replay_lanes_and_refills_are_used(case):
    """The adjoint runs its own pool (the replay_lanes extra), and both
    pools refill: more loop iterations than a single fill needs (counted
    over the case's replay gradient)."""
    fwd = case["iterations"]["forward_iterations"]
    adj = case["iterations"]["adjoint_iterations"]
    assert fwd > 6 and adj > 6 and fwd != adj, (fwd, adj)
