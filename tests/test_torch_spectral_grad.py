"""The spectral variant's gradients in the port (slice 6c-2) against the
JAX package's on the same seeded scenes:

- (a) the heterogeneous slab of tests/test_autodiff.py:348 (2x2x2 sigma_t
  grid from np.random.default_rng(5), a null cube under a constant sky,
  a radiancemeter, 32 spp, max_depth 8): the port's path replay (the
  lane pool's backward) and its scan driver (autograd) against the
  reference's scan-driver ``jax.grad``, and against each other, at the
  reference's rtol 5e-3 and atol 1e-7; the value+grad film bit-equal to
  the primal's;
- (b) a 4x4 spp 4 atmosphere whose sigma_t is a 17^3 x 8 gridvolume_spectral
  and whose albedo a 17^3 rgb grid (packed at load as gridvolume_srgb):
  above 4,096 voxels both take the packed lookups (GridTrilinear at
  C = 8 and PackedRowGather, through their plain versions here); the
  gradients of both grids through both drivers against the reference's
  scan gradient, rtol 5e-3, atol 1e-7;
- (c) ``Scene.with_tensors`` repacks vol_packed_spectral: the table of a
  scene given a new grid equals a fresh build's;
- (d) the spectral lookups' vjps (srgb and spectral grids of 2^3 and
  17^3, and spectrum_to_xyz / luminance with respect to the value) against
  ``jax.vjp`` of the reference's, rtol 1e-5 (the sigmoid's exp is an ulp
  from XLA's) and atol 1e-6 (for the grids' cotangents 1e-5 of the
  largest: the srgb coefficients' reach 1e5 and cancel in a voxel's
  sum);
- (e) ``traverse`` names the grids as the reference does, and SGD and
  Adam steps through ``autodiff.render`` lower a loss on both grids.

Each reference ``jax.grad`` compiles once (module-scoped fixtures)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_measured import synth_fields
from test_torch_nee_modes import one_torch_thread
from test_torch_scene import port_config, reference_arrays
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.core import spectrum as jsp
from eradiate_kernel_tpu.core.types import Variant as JVariant
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.textures import volumes as jvol
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.core import spectrum as sp
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.films import develop
from eradiate_kernel_tpu_torch.scene import from_numpy, load_dict
from eradiate_kernel_tpu_torch.textures import volumes
from eradiate_kernel_tpu_torch.utils import autodiff
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

__all__ = ["one_torch_thread"]  # the module's autouse fixture

SPECTRAL = Variant("spectral")
RTOL, ATOL = 5e-3, 1e-7
SRGB = "volumes.gridvolume_srgb.grid"
SPEC = "volumes.gridvolume_spectral.grid"


def _port_grads(scene, keys, seed, regen, lanes=None):
    """{key: gradient} of the developed image's mean through one driver,
    and the raw film."""
    pm = autodiff.traverse(scene).keep(keys)
    params = pm.trainable()
    film = integrators.render(pm.with_trainable(params), seed=seed,
                              samples_per_pass=lanes, regen=regen,
                              develop_film=False)
    develop(film).mean().backward()
    return {k: params[k].grad.numpy() for k in keys}, film.detach()


def _carried(jscene):
    """The port's scene of the reference's arrays (scene.from_numpy): the
    same rgb2spec coefficients (the two packages' fits differ within
    tests/test_torch_spectral.py's tolerance) and tables."""
    return from_numpy(reference_arrays(jscene), port_config(jscene.config),
                      device="cpu")


def _ref_scan_grads(jscene, keys, seed, lanes=None):
    jpm = jad.traverse(jscene)
    jpm.keep(keys)
    g = jax.grad(lambda tr: jnp.mean(jintegrators.render(
        jpm.with_trainable(tr), seed=seed, samples_per_pass=lanes)))(
        jpm.trainable())
    return {k: np.asarray(g[k]) for k in keys}


# ---- (a) tests/test_autodiff.py:348's slab ----------------------------------

def slab348():
    rng = np.random.default_rng(5)
    grid = (0.3 + 0.5 * rng.random((2, 2, 2))).astype(np.float32)
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 8,
                       "max_iterations": 16},
        "sensor": {"type": "radiancemeter",
                   "to_world": {"type": "look_at",
                                "origin": [0.5, 0.5, -3],
                                "target": [0.5, 0.5, 1], "up": [0, 1, 0]},
                   "film": {"width": 2, "height": 2,
                            "rfilter": {"type": "box"}},
                   "sampler": {"sample_count": 32}},
        "slab": {"type": "cube", "bsdf": {"type": "null"},
                 "interior": {"type": "heterogeneous",
                              "sigma_t": {"type": "gridvolume",
                                          "data": grid},
                              "albedo": 0.6}},
        "light": {"type": "constant", "radiance": 1.0},
    }


GRID = "volumes.gridvolume.grid"


@pytest.fixture(scope="module")
def slab():
    d = slab348()
    scene = load_dict(d, SPECTRAL, device="cpu")
    out = {"scene": scene, "ref": _ref_scan_grads(
        jload_dict(d, JVariant("spectral")), [GRID], 9)[GRID]}
    for regen in (False, True):
        g, film = _port_grads(scene, [GRID], 9, regen)
        out["replay" if regen else "scan"] = g[GRID]
        out[f"film {regen}"] = film
    return out


@pytest.mark.parametrize("case", ["scan vs reference", "replay vs reference",
                                  "replay vs scan"])
def test_slab_gradients_match(slab, case):
    a, b = {"scan vs reference": ("scan", "ref"),
            "replay vs reference": ("replay", "ref"),
            "replay vs scan": ("replay", "scan")}[case]
    assert np.abs(slab[b]).sum() > 0 and np.isfinite(slab[a]).all()
    np.testing.assert_allclose(slab[a], slab[b], rtol=RTOL, atol=ATOL)


def test_replay_film_equals_the_primal(slab):
    """The value+grad's film is the lane pool's primal film bit for bit
    (the sample log rides beside it), and the scan driver's within its
    budget."""
    primal = integrators.render(slab["scene"], seed=9, regen=True,
                                develop_film=False)
    assert torch.equal(slab["film True"], primal)
    np.testing.assert_allclose(slab["film False"].numpy(), primal.numpy(),
                               rtol=1e-5, atol=1e-7)


# ---- (b) 17^3 srgb and spectral grids --------------------------------------

N_GRID, BANDS = 17, 8


def grids_dict(n=N_GRID, width=4, spp=4, max_depth=4):
    """The atmosphere (ground lowered by 1e-3, tests/test_torch_replay.py's
    reason) with sigma_t an n^3 x BANDS gridvolume_spectral over 400-800
    nm (the density times (550 / lambda)^2) and an n^3 rgb albedo grid
    from np.random.default_rng(3)."""
    rng = np.random.default_rng(3)
    d = atmosphere(width, width, spp, max_depth, grid_res=(n, n, n))
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    med = d["atmo"]["interior"]
    tw = med["sigma_t"]["to_world"]
    lam = np.linspace(400.0, 800.0, BANDS)
    med["sigma_t"] = {"type": "gridvolume_spectral", "to_world": tw,
                      "data": (med["sigma_t"]["data"][..., None]
                               * (550.0 / lam) ** 2).astype(np.float32),
                      "lambda_min": 400.0, "lambda_max": 800.0}
    med["albedo"] = {"type": "gridvolume", "to_world": tw, "data": rng.uniform(
        0.5, 0.95, (n, n, n, 3)).astype(np.float32)}
    return d


@pytest.fixture(scope="module")
def grids():
    jscene = jload_dict(grids_dict(), JVariant("spectral"))
    scene = _carried(jscene)
    assert set(scene.vol_packed_spectral) == {"gridvolume_srgb",
                                              "gridvolume_spectral"}
    out = {"ref": _ref_scan_grads(jscene, [SPEC, SRGB], 3, lanes=32),
           "scenes": (jscene, scene)}
    for regen in (False, True):
        out["pool" if regen else "scan"] = _port_grads(
            scene, [SPEC, SRGB], 3, regen, lanes=32)[0]
    return out


@pytest.mark.parametrize("driver", ["scan", "pool"])
@pytest.mark.parametrize("key", [SPEC, SRGB], ids=["spectral", "srgb"])
def test_packed_grid_gradients_match_reference(grids, key, driver):
    got, ref = grids[driver][key], grids["ref"][key]
    assert got.shape == ref.shape and np.abs(ref).sum() > 0
    assert np.count_nonzero(ref) > 256  # the voxels the 64 paths reach
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# ---- (c) with_tensors repacks ----------------------------------------------

@pytest.mark.parametrize("kind", ["gridvolume_srgb", "gridvolume_spectral"])
def test_with_tensors_repack_equals_a_fresh_build(kind):
    """A scene built from one grid, given another scene's grid through
    with_tensors (and through ParameterMap.with_trainable), carries that
    scene's packed table, bit for bit; its lookups follow."""
    d_a, d_b = grids_dict(n=N_GRID), grids_dict(n=N_GRID)
    med = d_b["atmo"]["interior"]
    vol = med["sigma_t" if kind == "gridvolume_spectral" else "albedo"]
    vol["data"] = (vol["data"][::-1] * 0.8).copy()
    a = load_dict(d_a, SPECTRAL, device="cpu")
    b = load_dict(d_b, SPECTRAL, device="cpu")
    key = f"volumes.{kind}.grid"
    new = b.volumes[kind]["grid"]
    assert not torch.equal(a.vol_packed_spectral[kind],
                           b.vol_packed_spectral[kind])
    for scene in (a.with_tensors({key: new}),
                  autodiff.traverse(a).with_trainable({key: new})):
        for k, table in b.vol_packed_spectral.items():
            assert torch.equal(scene.vol_packed_spectral[k], table), k
    rng = np.random.default_rng(4)
    p = torch.as_tensor(rng.uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
                        * np.float32([40, 40, 1]) + np.float32([0, 0, 0.5]))
    lam = torch.as_tensor(rng.uniform(400, 800, (512, 4)).astype(np.float32))
    idx = torch.full((512,), _vol_index(b, kind), dtype=torch.int32)
    got = volumes.volume_eval(a.with_tensors({key: new}), idx, p, lam)
    assert torch.equal(got, volumes.volume_eval(b, idx, p, lam))


def _vol_index(scene, kind):
    kinds = scene.config.volume_kinds
    return [i for i, k in enumerate(scene.vol_kind.tolist())
            if kinds[k] == kind][0]


# ---- (d) the lookups' and the estimators' vjps ------------------------------

def _lookup_scene(kind, shape, grids):
    """(reference scene, port scene, seeded lookup points) of a grid of
    ``kind`` and ``shape``: at 17^3 the scenes of (b) (its srgb albedo and
    8-band sigma_t, points over the medium's 40 x 40 x 1 box), else a unit
    cube holding a seeded grid."""
    rng = np.random.default_rng(47)
    if shape == (N_GRID,) * 3:
        p = rng.uniform(-0.55, 0.55, (2048, 3)) * [40.0, 40.0, 1.1] + [
            0.0, 0.0, 0.5]
        return (*grids["scenes"], p.astype(np.float32), rng)
    p = rng.uniform(-0.1, 1.1, (2048, 3)).astype(np.float32)
    data_rng = np.random.default_rng(46)
    if kind == "gridvolume_srgb":
        vol = {"type": "gridvolume", "data": data_rng.uniform(
            0.05, 2.5, shape + (3,)).astype(np.float32)}
    else:
        vol = {"type": "gridvolume_spectral", "data": data_rng.uniform(
            0.1, 2.0, shape + (6,)).astype(np.float32),
            "lambda_min": 400.0, "lambda_max": 800.0}
    d = {"type": "scene",
         "sensor": {"type": "perspective", "film": {"width": 2,
                                                    "height": 2}},
         "cube": {"type": "cube", "bsdf": {"type": "null"},
                  "interior": {"type": "heterogeneous", "sigma_t": vol,
                               "albedo": 0.5}}}
    jscene = jload_dict(d, JVariant("spectral"))
    return jscene, _carried(jscene), p, rng


@pytest.mark.parametrize("shape", [(2, 2, 2), (N_GRID,) * 3],
                         ids=["2^3", "17^3"])
@pytest.mark.parametrize("kind", ["gridvolume_srgb", "gridvolume_spectral"])
def test_lookup_vjp_matches_reference(grids, kind, shape):
    """d(sum(ct * volume_eval))/d(grid) at 2,048 seeded points: 2^3 the
    srgb gather path and the spectral einsum, 17^3 both packed paths
    (PackedRowGather; GridTrilinear at C = 8) on (b)'s grids."""
    jscene, scene, p, rng = _lookup_scene(kind, shape, grids)
    key = f"volumes.{kind}.grid"
    n = len(p)
    lam = rng.uniform(350, 850, (n, 4)).astype(np.float32)
    ct = rng.normal(size=(n, 4)).astype(np.float32)
    vidx = np.full(n, _vol_index(scene, kind), np.int32)
    jpm = jad.traverse(jscene)

    def ref_fn(g):
        sc = jpm.with_trainable({key: g})
        return jvol.volume_eval(sc, jnp.asarray(vidx), jnp.asarray(p),
                                jnp.asarray(lam))

    out, ref = jax.jit(lambda g, c: (lambda o, f: (o, f(c)[0]))(
        *jax.vjp(ref_fn, g)))(jnp.asarray(jpm[key]), jnp.asarray(ct))
    grid = scene.volumes[kind]["grid"].clone().requires_grad_()
    got = volumes.volume_eval(scene.with_tensors({key: grid}),
                              torch.as_tensor(vidx), torch.as_tensor(p),
                              torch.as_tensor(lam))
    (got * torch.as_tensor(ct)).sum().backward()
    ref = np.asarray(ref)
    assert np.count_nonzero(ref) > 0 and np.isfinite(ref).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    # the coefficients' cotangents through the sigmoid reach 1e5 and
    # cancel in the voxel sums: atol 1e-5 of the largest
    np.testing.assert_allclose(grid.grad.numpy(), ref, rtol=1e-5,
                               atol=max(1e-6, 1e-5 * np.abs(ref).max()))


def test_estimator_vjps_match_reference():
    """spectrum_to_xyz and luminance(value, wavelengths) carry the
    gradient of the value (the wavelengths are the sampled trajectory's);
    bit-equal values, vjps within 1e-6 relative."""
    rng = np.random.default_rng(48)
    n = 4096
    v = rng.uniform(0, 2, (n, 4)).astype(np.float32)
    lam = rng.uniform(350, 850, (n, 4)).astype(np.float32)
    for name, ct_shape in (("spectrum_to_xyz", (n, 3)), ("luminance", (n,))):
        ct = rng.normal(size=ct_shape).astype(np.float32)
        out, vjp = jax.vjp(lambda x: getattr(jsp, name)(x, jnp.asarray(lam)),
                           jnp.asarray(v))
        (ref,) = vjp(jnp.asarray(ct))
        x = torch.as_tensor(v).requires_grad_()
        got = getattr(sp, name)(x, torch.as_tensor(lam))
        (got * torch.as_tensor(ct)).sum().backward()
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-7)


# ---- (e) from_numpy, traverse, render, SGD and Adam -------------------------

def test_from_numpy_carries_the_spectral_tables():
    """A spectral scene of both grid kinds, a measured BSDF and spectral
    emitters (blackbody, regular): the port's own build has the
    reference's names, and from_numpy of the reference's arrays carries
    every one of them bit for bit, the packed tables rebuilt from the
    carried grids."""
    d = grids_dict(n=5)
    d["surface"]["bsdf"] = {"type": "measured",
                            "fields": synth_fields(T=4, L=3, res=9, seed=8)}
    d["sun"]["irradiance"] = {"type": "blackbody", "temperature": 5800.0}
    d["lamp"] = {"type": "point", "position": [0.0, 0.0, 2.0],
                 "intensity": {"type": "regular", "lambda_min": 500.0,
                               "lambda_max": 600.0,
                               "values": [1.0, 3.0, 2.0]}}
    jscene = jload_dict(d, JVariant("spectral"))
    ref = reference_arrays(jscene)
    own = load_dict(d, SPECTRAL, device="cpu").arrays()
    carried = _carried(jscene)
    arrays = carried.arrays()
    assert set(arrays) == set(own)
    assert {"bsdfs.measured.spectra", "spectra.blackbody.smp_cdf", SPEC,
            SRGB, "spectra.regular.smp_cdf"} <= set(arrays), sorted(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    for kind, table in carried.vol_packed_spectral.items():
        want = volumes.packed_corners(
            torch.as_tensor(np.array(ref[f"volumes.{kind}.grid"])))
        assert torch.equal(table, want), kind


def test_traverse_and_optimizers_on_spectral_grids(grids):
    """The grids' parameter names are the reference's; steps of SGD (the
    scan driver) and of Adam (the lane pool and its replay) through
    autodiff.render, at a fixed seed, lower the squared distance to a
    render of other grids."""
    d = grids_dict(n=5, width=4, spp=2, max_depth=3)
    names = set(autodiff.traverse(load_dict(d, SPECTRAL, device="cpu"))
                .keys())
    jnames = set(jad.traverse(grids["scenes"][0])._values)  # (b)'s scene
    assert {k for k in names if k.startswith("volumes.")} == {
        k for k in jnames if k.startswith("volumes.")}
    assert {SPEC, SRGB} <= names
    target_d = grids_dict(n=5, width=4, spp=2, max_depth=3)
    med = target_d["atmo"]["interior"]
    med["sigma_t"]["data"] = med["sigma_t"]["data"] * 1.5
    med["albedo"]["data"] = med["albedo"]["data"] * 0.7
    target = integrators.render(load_dict(target_d, SPECTRAL, device="cpu"),
                                seed=1, regen=True, samples_per_pass=32)
    for opt_cls, lr, regen in ((autodiff.SGD, 2.0, False),
                               (autodiff.Adam, 0.02, True)):
        pm = autodiff.traverse(load_dict(d, SPECTRAL, device="cpu"))
        pm.keep([SPEC, SRGB])
        opt = opt_cls(pm.trainable(), lr=lr)
        start = {k: v.detach().clone() for k, v in opt.items()}
        losses = []
        for _ in range(2):
            img = autodiff.render(pm, opt.params, seed=1, regen=regen,
                                  samples_per_pass=32)
            loss = ((img - target) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            losses.append(float(loss.detach()))
            opt.step()
        assert losses[1] < losses[0], (opt_cls.__name__, losses)
        for k, v in opt.items():
            assert torch.isfinite(v).all() and not torch.equal(v, start[k])
