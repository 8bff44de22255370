"""The port's autodiff helpers against the JAX package's on the same seeded
inputs: film_gather (the adjoint of film_put), the grid gradient of a
gridvolume above 4,096 voxels (the packed lookup's backward), the
ParameterMap, the SGD and Adam steps, the unbiased render, and the replay
gradient against central finite differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_replay import LANES, SEED, slab_dict
from test_torch_sensors import one_torch_thread  # noqa: F401
from eradiate_kernel_tpu import films as jfilms
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.films import film_gather, film_put
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.textures import volumes
from eradiate_kernel_tpu_torch.utils import autodiff

GRID = "volumes.gridvolume.grid"


def _samples(n=500, H=6, W=7, C=5, seed=0):
    rng = np.random.default_rng(seed)
    # positions past the film's edges too (film_put clamps them)
    pos = rng.uniform([-1, -1], [W + 1, H + 1], (n, 2)).astype(np.float32)
    return (pos, rng.random((n, C)).astype(np.float32),
            rng.random((H, W, C)).astype(np.float32))


def test_film_gather_is_the_adjoint_of_film_put():
    """<film_put(0, pos, v), ct> == <v, film_gather(ct, pos)>."""
    pos, v, ct = (torch.as_tensor(a) for a in _samples())
    lhs = torch.sum(film_put(torch.zeros_like(ct), pos, v, "box") * ct)
    rhs = torch.sum(v * film_gather(ct, pos, "box"))
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-6)
    # a wide filter: up to 4 x 4 taps a sample, those outside the film
    # weighing 0
    wide = {"radius": 1.5}
    lhs = torch.sum(film_put(torch.zeros_like(ct), pos, v, "box", wide) * ct)
    rhs = torch.sum(v * film_gather(ct, pos, "box", wide))
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-5)


def test_film_gather_matches_reference():
    pos, _v, ct = _samples(seed=1)
    ref = np.asarray(jfilms.film_gather(jnp.asarray(ct), jnp.asarray(pos),
                                        "box", {}))
    out = film_gather(torch.as_tensor(ct), torch.as_tensor(pos), "box")
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.fixture(scope="module")
def large_grid():
    """The slab with 17x17x17 sigma_t and albedo grids (two slots of 4,913
    voxels: the packed gather path) and its grid gradient through both scan
    drivers (the reference's in one pass of its 256 samples: its passes
    split only the film's sums, and one compiles in half the time)."""
    d = slab_dict(grid_res=(17, 17, 17))
    scene = load_dict(d, device="cpu")
    jscene = jload_dict(d)
    pm = jad.traverse(jscene)
    pm.keep([GRID])

    def loss(tr):
        return jnp.mean(jintegrators.render(pm.with_trainable(tr), seed=SEED,
                                            samples_per_pass=4 * 4 * 16))

    ref = np.asarray(jax.grad(loss)(pm.trainable())[GRID])
    ppm = autodiff.traverse(scene).keep([GRID])
    params = ppm.trainable()
    integrators.render(ppm.with_trainable(params), seed=SEED,
                       samples_per_pass=LANES).mean().backward()
    return scene, ref, params[GRID].grad.numpy()


def test_grid_gradient_above_4096_voxels_matches_reference(large_grid):
    """The grid of the packed path gets the reference's gradient: the
    lookup is differentiable in the grid (GridTrilinear), not in the
    packed table built from it."""
    scene, ref, grad = large_grid
    assert scene.vol_packed is not None
    assert np.abs(grad).sum() > 0
    np.testing.assert_allclose(grad, ref, rtol=5e-3, atol=1e-7)


def test_parameter_map_keys_match_reference():
    """The port's names are the reference's for the same scene: its value-
    class keys (grids and baked spectra, tests/test_autodiff.py's
    _value_class_keys) are the reference's, and every key of the port's map
    is a reference key of the same shape."""
    d = slab_dict(grid_res=(17, 17, 17))
    pm = autodiff.traverse(load_dict(d, device="cpu"))
    jpm = jad.traverse(jload_dict(d))
    value_class = lambda keys: sorted(
        k for k in keys if k.endswith("gridvolume.grid")
        or ("baked" in k and "value" in k))
    assert value_class(pm.keys()) == value_class(jpm._values) == [
        "spectra.baked.value", GRID]
    for k, v in pm.items():
        assert tuple(v.shape) == tuple(jpm[k].shape), k


def test_with_trainable_rebuilds_the_packed_table():
    """A new grid through the map comes with its own packed corner table
    (the lookup reads the table, so a stale one would render the old
    grid)."""
    scene = load_dict(slab_dict(grid_res=(17, 17, 17)), device="cpu")
    pm = autodiff.traverse(scene).keep([GRID])
    new = pm[GRID] * 1.5 + 0.1
    sc = pm.with_trainable({GRID: new})
    assert torch.equal(sc.vol_packed, volumes.packed_corners(new))
    assert not torch.equal(sc.vol_packed, scene.vol_packed)
    assert sc.geo is scene.geo
    pm[GRID] = new
    assert torch.equal(pm.scene().vol_packed, sc.vol_packed)


@pytest.mark.parametrize("opt", ["sgd", "sgd_momentum", "adam"])
def test_optimizer_steps_match_reference(opt):
    """Three steps on the same gradients give the reference's parameters."""
    rng = np.random.default_rng(4)
    p0 = {"a": rng.random((3, 4)).astype(np.float32),
          "b": rng.random(5).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    make = {"sgd": lambda m, p: m.SGD(p, lr=0.1),
            "sgd_momentum": lambda m, p: m.SGD(p, lr=0.1, momentum=0.9),
            "adam": lambda m, p: m.Adam(p, lr=0.05)}[opt]
    ref = make(jad, {k: jnp.asarray(v) for k, v in p0.items()})
    port = make(autodiff, {k: torch.as_tensor(v) for k, v in p0.items()})
    for g in grads:
        ref.step({k: jnp.asarray(v) for k, v in g.items()})
        # the torch idiom: the gradients arrive in .grad
        port.zero_grad()
        for k, v in g.items():
            port[k].grad = torch.as_tensor(v)
        port.step()
    for k in p0:
        assert port[k].requires_grad and port[k].is_leaf
        np.testing.assert_allclose(port[k].detach().numpy(),
                                   np.asarray(ref.params[k]), rtol=1e-6)
    state = port.state_dict()
    again = make(autodiff, {k: torch.zeros_like(torch.as_tensor(v))
                            for k, v in p0.items()})
    again.load_state_dict(state)
    for k in p0:
        assert torch.equal(again[k], port[k])


def test_unbiased_render_takes_its_gradient_from_another_seed():
    """render(unbiased=True): the image of ``seed``, the gradient of the
    render of seed + 0x9E3779B9 (a pool of one lane a sample: the film
    and the gradient do not depend on the lane count)."""
    scene = load_dict(slab_dict(spp=4), device="cpu")
    pm = autodiff.traverse(scene).keep([GRID])

    def grad_of(seed, unbiased):
        params = pm.trainable()
        img = autodiff.render(pm, params, seed=seed, unbiased=unbiased,
                              regen=True, samples_per_pass=4 * 4 * 4)
        img.mean().backward()
        return img.detach(), params[GRID].grad

    img_u, g_u = grad_of(SEED, True)
    img, _g = grad_of(SEED, False)
    _img, g_other = grad_of(SEED + 0x9E3779B9, False)
    assert torch.equal(img_u, img)
    assert torch.equal(g_u, g_other) and not torch.equal(g_u, _g)


def test_replay_grad_matches_finite_differences():
    """The replay gradient of the albedo grid, all voxels perturbed
    together, against central finite differences of the same-seed render
    at rel 0.08 (tests/test_autodiff.py's figure): 2x2 film, 128 spp, on
    a pool of one lane a sample (the film and the gradient do not depend
    on the lane count; 48 lanes took 4x the forward time)."""
    scene = load_dict(slab_dict(width=2, spp=128), device="cpu")
    pm = autodiff.traverse(scene).keep([GRID])
    a = {k: v.numpy() for k, v in scene.tensors().items()}
    mask = torch.zeros(pm[GRID].shape)
    mask[int(a["vol_slot"][a["media.heterogeneous.albedo_vol"][0]])] = 1.0

    def loss(params):
        return integrators.render(pm.with_trainable(params), seed=5,
                                  samples_per_pass=2 * 2 * 128,
                                  regen=True).mean()

    params = pm.trainable()
    loss(params).backward()
    g = float((params[GRID].grad * mask).sum())
    eps = 2e-2
    with torch.no_grad():
        at = lambda s: float(loss({GRID: pm[GRID] + s * eps * mask}))
        fd = (at(1) - at(-1)) / (2 * eps)
    assert g > 0
    assert g == pytest.approx(fd, rel=0.08), (g, fd)
