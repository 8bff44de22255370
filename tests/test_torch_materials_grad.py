"""The gradient of slice 5c-1's materials Cornell box (chip_smoke.py phase
26's scene at 8x8, spp 4, max_depth 3) in the port against the JAX
package's jax.grad at the same seed: d(mean image)/d(spectra.baked.value)
through the port's path replay (render(regen=True)) and its scan driver,
against the reference's scan driver, at rtol 5e-3 and atol 1e-7
(tests/test_torch_surface_grad.py's bound).

The scene is compared in two halves: "objects" (the three spheres and
the checkerboard cube on plain walls) and "wrappers" (the bump-mapped
back wall and the normal-mapped floor, no objects). The reference's
jax.grad of the whole scene compiles for ~400 s on a CPU (its compile
grows faster than the kinds it sweeps: each wrapper re-dispatches every
other kind); each half compiles in ~22 s. The rows held finite and not
all zero: the cube's checkerboard colours and the gold's eta and k
(objects), the walls' reflectances and the light (both); every other
finite row is compared too. chip_smoke.py's phase 26 differentiates the
whole scene on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu_torch.scene import load_dict
from test_torch_materials_render import materials_scenes
from test_torch_sensors import one_torch_thread  # noqa: F401
from test_torch_surface_grad import ATOL, KEYS, RTOL, SEED, port_grads

LANES = 64


def half(name):
    """(reference dict, port dict) of one half of the scene."""
    dicts = materials_scenes("cornell", width=8, height=8, spp=4,
                             max_depth=3)
    for d in dicts:
        if name == "objects":
            for wall in ("back", "floor"):
                d[wall]["bsdf"] = {"type": "ref", "id": "white_bsdf"}
        else:
            for key in ("glass", "gold", "frosted", "cube"):
                del d[key]
    return dicts


@pytest.fixture(scope="module", params=["objects", "wrappers"])
def grads(request):
    jd, d = half(request.param)
    scene = load_dict(d, device="cpu")
    out = {"arrays": {k: v.numpy() for k, v in scene.tensors().items()}}
    for regen in (False, True):
        out["replay" if regen else "scan"] = port_grads(
            scene, KEYS, regen, LANES)["spectra.baked.value"]
    pm = jad.traverse(jload_dict(jd))
    pm.keep(KEYS)

    def loss(tr):
        return jnp.mean(jintegrators.render(pm.with_trainable(tr), seed=SEED,
                                            samples_per_pass=LANES))

    out["reference"] = np.asarray(
        jax.grad(loss)(pm.trainable())["spectra.baked.value"])
    out["half"] = request.param
    return out


def named_rows(a):
    """spectra.baked.value rows by name."""
    row = lambda spec: int(a["spec_slot"][spec])
    const = lambda tex: row(a["textures.constant.spec"][a["tex_slot"][tex]])
    refl = a["bsdfs.diffuse.reflectance"]
    rows = {"white": const(refl[0]), "red": const(refl[1]),
            "green": const(refl[2]),
            "light": const(a["emitters.area.radiance"][0])}
    if "bsdfs.roughplastic.diffuse_reflectance" in a:
        plastic = a["bsdfs.roughplastic.diffuse_reflectance"]
        checker = a["tex_slot"][plastic[0]]
        rows.update({
            "checkerboard color0": row(a["textures.checkerboard.spec0"][
                checker]),
            "checkerboard color1": row(a["textures.checkerboard.spec1"][
                checker]),
            "gold eta": row(a["bsdfs.roughconductor.eta"][0]),
            "gold k": row(a["bsdfs.roughconductor.k"][0])})
    return rows


@pytest.mark.parametrize("driver", ["replay", "scan"])
def test_materials_gradient_matches_reference(grads, driver):
    ref, g = grads["reference"], grads[driver]
    rows = named_rows(grads["arrays"])
    assert len(rows) == (8 if grads["half"] == "objects" else 4)
    for name, row in rows.items():
        assert np.isfinite(g[row]).all(), (name, driver)
        assert np.abs(ref[row]).sum() > 0, name
    ok = np.isfinite(ref)
    assert np.array_equal(ok, np.isfinite(g)), driver
    assert np.allclose(g[ok], ref[ok], rtol=RTOL, atol=ATOL), \
        (driver, np.abs(g[ok] - ref[ok]).max())
