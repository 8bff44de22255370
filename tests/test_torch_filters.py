"""The port's reconstruction filters and wide-filter films against the JAX
package's on the same numpy inputs:

- eval_filter of the six kinds at 1e-6, filter_radius equal;
- film_put and film_gather under wide filters against the reference's on
  the same samples (rtol 1e-5: the order of the film's sums differs), and
  the adjoint identity <film_put(0, pos, v), img> = <v, film_gather(img,
  pos)>;
- a 16x16 scene whose film names no rfilter (the reference's default,
  gaussian of stddev 0.5) through the scan driver and the lane pool,
  within assert_driver_equivalent of the reference's films;
- a gradient through the path replay under that gaussian against the
  reference's jax.grad at rtol 5e-3 (tests/test_autodiff.py's figure).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import films as jfilms
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu import rfilters as jrfilters
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu.utils import scenes as jscenes
from eradiate_kernel_tpu_torch import films, integrators, rfilters
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff, scenes
from test_torch_sensors import one_torch_thread  # noqa: F401

KINDS = {"box": {"radius": 1.5}, "tent": {}, "gaussian": {},
         "mitchell": {}, "catmullrom": {}, "lanczos": {"lobes": 2}}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_eval_filter_matches_reference(kind):
    x = np.linspace(-4.5, 4.5, 2001).astype(np.float32)
    for params in ({}, KINDS[kind]):
        assert rfilters.filter_radius(kind, params) == \
            jrfilters.filter_radius(kind, params)
        ref = np.asarray(jrfilters.eval_filter(kind, jnp.asarray(x), params))
        out = rfilters.eval_filter(kind, torch.as_tensor(x), params).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def _samples(n=3000, H=9, W=11, C=5, seed=0):
    rng = np.random.default_rng(seed)
    # positions past the film's edges too: their outside taps weigh 0
    pos = rng.uniform([-2, -2], [W + 2, H + 2], (n, 2)).astype(np.float32)
    return (pos, rng.random((n, C)).astype(np.float32),
            rng.random((H, W, C)).astype(np.float32))


@pytest.mark.parametrize("kind", ["gaussian", "tent", "lanczos", "box"])
def test_wide_film_put_and_gather_match_reference(kind):
    params = KINDS[kind]
    pos, v, img = _samples()
    ref_put = np.asarray(jfilms.film_put(jnp.zeros(img.shape),
                                         jnp.asarray(pos), jnp.asarray(v),
                                         kind, params))
    put = films.film_put(torch.zeros(img.shape), torch.as_tensor(pos),
                         torch.as_tensor(v), kind, params)
    np.testing.assert_allclose(put.numpy(), ref_put, rtol=1e-5, atol=1e-5)
    ref_gather = np.asarray(jfilms.film_gather(jnp.asarray(img),
                                               jnp.asarray(pos), kind,
                                               params))
    gather = films.film_gather(torch.as_tensor(img), torch.as_tensor(pos),
                               kind, params)
    np.testing.assert_allclose(gather.numpy(), ref_gather, rtol=1e-5,
                               atol=1e-6)
    lhs = float(torch.sum(put.double() * torch.as_tensor(img).double()))
    rhs = float(torch.sum(torch.as_tensor(v).double() * gather.double()))
    assert lhs == pytest.approx(rhs, rel=1e-5)


def _default_filter_cbox(factory, **kw):
    d = factory(width=16, height=16, spp=4, max_depth=3, **kw)
    del d["sensor"]["film"]["rfilter"]
    return d


@pytest.fixture(scope="module")
def default_filter_films():
    jscene = jload_dict(_default_filter_cbox(jscenes.cornell_box))
    scene = load_dict(_default_filter_cbox(scenes.cornell_box),
                      device="cpu")
    assert scene.config.rfilter == "gaussian"
    out = {}
    for regen in (False, True):
        kw = dict(seed=2, regen=regen, samples_per_pass=96,
                  develop_film=False)
        out[regen] = (np.asarray(jintegrators.render(jscene, **kw)),
                      integrators.render(scene, **kw).numpy())
    return out


@pytest.mark.parametrize("regen", [False, True], ids=["scan", "pool"])
def test_default_filter_renders_match_reference(default_filter_films, regen):
    """The film with no rfilter (gaussian, radius 2) through each driver
    against the reference's same driver, and the pool against the port's
    scan driver."""
    ref, film = default_filter_films[regen]
    assert film.shape == (16, 16, 5)
    # every sample spreads over up to 5x5 pixels (the gaussian's weights
    # are not normalised: develop divides them out)
    assert (film[..., 4] > 1.0).all()
    assert_driver_equivalent(ref, film, max_flips=1)
    assert_driver_equivalent(default_filter_films[False][1], film,
                             max_flips=1)


def test_default_filter_replay_gradient_matches_reference():
    """d(mean image)/d(the light's radiance and the walls' reflectance)
    through the path replay under the gaussian film, against the
    reference's jax.grad of its replay."""
    jscene = jload_dict(_default_filter_cbox(jscenes.cornell_box))
    scene = load_dict(_default_filter_cbox(scenes.cornell_box), device="cpu")
    key = "spectra.baked.value"
    pm = autodiff.traverse(scene).keep([key])
    params = pm.trainable()
    integrators.render(pm.with_trainable(params), seed=3, regen=True,
                       samples_per_pass=96).mean().backward()
    g = params[key].grad.numpy()
    jpm = jad.traverse(jscene)
    jpm.keep([key])

    def loss(tr):
        return jnp.mean(jintegrators.render(jpm.with_trainable(tr), seed=3,
                                            samples_per_pass=96, regen=True))

    ref = np.asarray(jax.grad(loss)(jpm.trainable())[key])
    assert np.isfinite(g).all() and np.abs(ref).sum() > 0
    np.testing.assert_allclose(g, ref, rtol=5e-3, atol=1e-7)
