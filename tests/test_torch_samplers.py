"""The four stratifying samplers of slice 5c-2 (stratified, multijitter,
orthogonal, ldsampler; core/rng.py) against the JAX package's Sampler:
their draws bit-equal in the port's int64 encoding of uint32 (lanes near
2^32 among them, where ``s_idx + rot * 0x9E3779B9`` and the radical
inverse's shifts wrap), and renders with each kind on the scan driver and
the lane pool within tests/conftest.py::assert_driver_equivalent's budget
(1e-4 relative a pixel, 2 flipped pixels), with the path replay's
gradient against the port's scan driver (rtol 5e-3, atol 1e-7, the
replay-vs-scan figure of tests/test_autodiff.py) and, for the ldsampler,
against the reference's jax.grad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.core.rng import Sampler as JSampler
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu.utils import scenes as jscenes
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.core.rng import SAMPLER_KINDS, Sampler
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff, scenes

STRATIFYING = [k for k in SAMPLER_KINDS if k != "independent"]


def lanes():
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.arange(300), rng.integers(0, 2 ** 32, 700, dtype=np.uint64),
        2 ** 32 - 1 - np.arange(24)]).astype(np.uint64)


@pytest.mark.parametrize("kind", SAMPLER_KINDS)
@pytest.mark.parametrize("spp", [1, 6, 9, 16])
def test_draws_bit_equal_to_reference(kind, spp):
    lane = lanes()
    for seed in (0, 7, 0x1234567890):
        smp = Sampler.seed(seed, torch.as_tensor(lane.astype(np.int64)),
                           kind=kind, spp=spp)
        jsmp = JSampler.seed(seed, jnp.asarray(lane, jnp.uint32), kind=kind,
                             spp=spp)
        np.testing.assert_array_equal(smp.k0.numpy(), np.asarray(jsmp.k0))
        np.testing.assert_array_equal(smp.s_idx.numpy(),
                                      np.asarray(jsmp.s_idx))
        for step in range(8):  # 1d and 2d draws interleaved
            if step % 3 == 1:
                smp, u = smp.next_2d()
                jsmp, ju = jsmp.next_2d()
            else:
                smp, u = smp.next_1d()
                jsmp, ju = jsmp.next_1d()
            np.testing.assert_array_equal(u.numpy(), np.asarray(ju),
                                          err_msg=f"{kind} step {step}")
            assert (u.numpy() >= 0).all() and (u.numpy() < 1).all()
        forked, jforked = smp.fork(5), jsmp.fork(5)
        np.testing.assert_array_equal(forked.s_idx.numpy(),
                                      np.asarray(jforked.s_idx))
        np.testing.assert_array_equal(forked.next_1d()[1].numpy(),
                                      np.asarray(jforked.next_1d()[1]))


def test_stratified_draws_cover_every_stratum():
    """spp = 16 samples of one pixel put one 2D draw in each of the 4 x 4
    strata (stratified, multijitter, orthogonal) and one 1D draw in each
    sixteenth."""
    lane = torch.arange(16 * 64)
    for kind in ("stratified", "multijitter", "orthogonal"):
        smp = Sampler.seed(3, lane, kind=kind, spp=16)
        smp, u1 = smp.next_1d()
        _, u2 = smp.next_2d()
        cell = (torch.floor(u2[:, 0] * 4) * 4
                + torch.floor(u2[:, 1] * 4)).reshape(64, 16)
        assert all(len(torch.unique(row)) == 16 for row in cell), kind
        bins = torch.floor(u1 * 16).reshape(64, 16)
        assert all(len(torch.unique(row)) == 16 for row in bins), kind


def cornell_dicts(kind, spp=4):
    out = []
    for pkg in (scenes, jscenes):
        d = pkg.cornell_box(width=8, height=8, spp=spp, max_depth=3)
        d["sensor"]["sampler"] = {"type": kind, "sample_count": spp}
        out.append(d)
    return out


@pytest.mark.parametrize("kind", STRATIFYING)
def test_renders_match_reference(kind):
    """The scan driver and the lane pool, against the reference's film."""
    d, jd = cornell_dicts(kind)
    scene = load_dict(d, device="cpu")
    assert scene.config.sampler_kind == kind
    ref = np.asarray(jintegrators.render(jload_dict(jd), seed=2))
    assert_driver_equivalent(ref, integrators.render(scene, seed=2).numpy(),
                             max_flips=2)
    pool = integrators.render(scene, seed=2, regen=True,
                              samples_per_pass=50).numpy()
    assert_driver_equivalent(ref, pool, max_flips=2)
    indep = integrators.render(load_dict(cornell_dicts("independent")[0],
                                         device="cpu"), seed=2).numpy()
    assert not np.array_equal(indep, ref)  # another sequence


KEY = "spectra.baked.value"


def port_grad(scene, regen):
    pm = autodiff.traverse(scene).keep([KEY])
    params = pm.trainable()
    integrators.render(pm.with_trainable(params), seed=2, regen=regen,
                       samples_per_pass=64).mean().backward()
    return params[KEY].grad.numpy()


@pytest.mark.parametrize("kind", STRATIFYING)
def test_replay_gradient_matches_scan(kind):
    d, jd = cornell_dicts(kind, spp=4)
    scene = load_dict(d, device="cpu")
    replay = port_grad(scene, True)
    scan = port_grad(scene, False)
    assert np.isfinite(replay).all() and np.abs(scan).sum() > 0
    np.testing.assert_allclose(replay, scan, rtol=5e-3, atol=1e-7)
    if kind != "ldsampler":
        return
    jpm = jad.traverse(jload_dict(jd))
    jpm.keep([KEY])

    def loss(tr):
        return jnp.mean(jintegrators.render(jpm.with_trainable(tr), seed=2,
                                            samples_per_pass=64))

    ref = np.asarray(jax.grad(loss)(jpm.trainable())[KEY])
    np.testing.assert_allclose(replay, ref, rtol=5e-3, atol=1e-7)
