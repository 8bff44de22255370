"""Gradients of the polarized transport (integrators/stokes.py over
polarized_vol.py and polarized.py) in the port against the JAX package's
jax.grad, both through the scan driver: d(mean film)/d(value-class keys)
by autograd through the port's ``render(regen=False)`` and by the
reference's ``jax.grad`` of its ``render(regen=False)``, at the same seed.

- stokes(volpath) over the Rayleigh atmosphere of utils.scenes.atmosphere
  with a 17x16x16 sigma_t grid (4,352 voxels: above 4,096 the port looks
  it up through volumes.GridTrilinear, whose backward on the card is the
  grid_trilinear_bwd kernel), a pplastic ground (lowered by 1e-3, ROADMAP
  Queue 3) and a sun of irradiance 2; 8x8 spp 4, max_depth 4. Keys: the
  grid's data, the medium's albedo, and the pplastic reflectance's and
  the sun's rows of the rgb spectra.
- stokes(path) over tests/test_torch_polarized.py's surface scene (gold,
  glass, rough copper, a polarizer and a pplastic ground under a sun and
  a sky; 8x8 spp 4, max_depth 4). Keys: the pplastic reflectance's, the
  sun's and the sky's rows, and every row of the rgb spectra. A surface
  scene has no grid and no medium: with one, stokes takes the Mueller
  volpath.

Every entry is held at rtol 1e-4 and an atol of 1e-6 of the key's
largest entry; the grid at an atol of 5e-5 of its largest: each voxel
sums the 8-corner scatters of hundreds of lookups in another order than
XLA's transpose of its gather, which leaves entries ~1e-3 off by up to
2.6e-7 (2.8e-5 of the largest) under plain volpath too. Under autograd
``render(regen=True)`` raises for both children, as the reference's
replay refuses them (no ``_REPLAY_OK``).

The reference's gradients run in two subprocesses started with the
module (its jax.grad compiles take 24-32 s), the port's meanwhile."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere
from test_torch_polarized import surface_dict

SEED = 1
RTOL, ATOL = 1e-4, 1e-6
GRID_ATOL = 5e-5
PPLASTIC = [0.3, 0.4, 0.5]


def volpath_dict():
    d = atmosphere(8, 8, 4, 4, grid_res=(17, 16, 16))
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    d["surface"]["bsdf"] = {"type": "pplastic", "alpha": 0.2,
                            "diffuse_reflectance": PPLASTIC}
    d["sun"]["irradiance"] = 2.0
    d["integrator"] = {"type": "stokes",
                       "child": {"type": "volpath", "max_depth": 4}}
    return d


# child -> (scene dict, keys)
CASES = {
    "volpath": (volpath_dict(), ["volumes.gridvolume.grid",
                                 "volumes.constvolume.value",
                                 "spectra.baked.value"]),
    "path": (surface_dict(8, 4, 4), ["spectra.baked.value"]),
}
# child -> [(case, key, the spectra row's value or None for every row)]
CHECKS = {
    "volpath": [("grid", "volumes.gridvolume.grid", None),
                ("albedo", "volumes.constvolume.value", None),
                ("pplastic reflectance", "spectra.baked.value", PPLASTIC),
                ("sun", "spectra.baked.value", [2.0] * 3)],
    "path": [("pplastic reflectance", "spectra.baked.value", PPLASTIC),
             ("sun", "spectra.baked.value", [3.0] * 3),
             ("sky", "spectra.baked.value", [0.3] * 3),
             ("every spectrum", "spectra.baked.value", None)],
}

_SCRIPT = r"""
import pickle
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from eradiate_kernel_tpu import integrators
from eradiate_kernel_tpu.core.types import Variant
from eradiate_kernel_tpu.scene import load_dict
from eradiate_kernel_tpu.utils import autodiff

with open(sys.argv[2], "rb") as f:
    d, keys, seed = pickle.load(f)[sys.argv[3]]
scene = load_dict(d, Variant("rgb", polarized=True))
pm = autodiff.traverse(scene)
pm.keep(keys)
cfg = scene.config
total = cfg.film_width * cfg.film_height * cfg.spp
loss = lambda tr: jnp.mean(integrators.render(
    pm.with_trainable(tr), seed=seed, samples_per_pass=total, regen=False))
g = jax.grad(loss)(pm.trainable())
np.savez(sys.argv[1], **{k: np.asarray(g[k]) for k in keys})
"""


class _Reference:
    """The reference's jax.grad of each child's scene, one subprocess
    each, side by side."""

    def __init__(self, tmp):
        cases = {c: (d, keys, SEED) for c, (d, keys) in CASES.items()}
        with open(tmp / "cases.pkl", "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        self.procs = {
            c: (str(tmp / f"{c}.npz"), subprocess.Popen(
                [sys.executable, "-c", _SCRIPT, str(tmp / f"{c}.npz"),
                 str(tmp / "cases.pkl"), c], env=env, cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for c in CASES}
        self.grads = {}

    def __getitem__(self, child):
        if child not in self.grads:
            path, proc = self.procs[child]
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, out[-2000:] + err[-3000:]
            self.grads[child] = dict(np.load(path))
        return self.grads[child]

    def stop(self):
        for _path, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """The reference's gradients, with one torch thread for the module
    meanwhile (tests/test_torch_sensors.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    reference = _Reference(tmp_path_factory.mktemp("stokes_grad"))
    yield reference
    reference.stop()
    torch.set_num_threads(n)


def scene_of(child):
    return load_dict(CASES[child][0], Variant("rgb", polarized=True),
                     device="cpu")


@pytest.fixture(scope="module")
def port():
    """The port's gradients of each child's scene (autograd through the
    scan driver) and the scene's spectra rows."""
    out = {}
    for child, (_d, keys) in CASES.items():
        scene = scene_of(child)
        pm = autodiff.traverse(scene).keep(keys)
        params = pm.trainable()
        integrators.render(pm.with_trainable(params), seed=SEED,
                           regen=False).mean().backward()
        out[child] = ({k: p.grad.numpy() for k, p in params.items()},
                      scene.tensors()["spectra.baked.value"].numpy())
    return out


@pytest.mark.parametrize("child,case,key,row", [
    (child, case, key, row) for child, checks in CHECKS.items()
    for case, key, row in checks],
    ids=[f"{child}-{case}" for child, checks in CHECKS.items()
         for case, _k, _r in checks])
def test_gradient_matches_reference(ref, port, child, case, key, row):
    grads, spectra = port[child]
    got, want = grads[key], ref[child][key]
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if row is not None:
        hit = np.nonzero(np.all(spectra == np.float32(row), axis=-1))[0]
        assert len(hit) == 1, (row, spectra)
        got, want = got[hit[0]], want[hit[0]]
    assert np.all(np.isfinite(got)) and np.any(got != 0)
    atol = (GRID_ATOL if key == "volumes.gridvolume.grid" else ATOL) * scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("child", list(CASES))
def test_pool_under_autograd_raises(child):
    """render(regen=True) of stokes has no backward (the path replay needs
    the _REPLAY_OK hook, which neither polarized child has), so under
    autograd it raises and points to the scan driver."""
    scene = scene_of(child)
    pm = autodiff.traverse(scene).keep(["spectra.baked.value"])
    params = pm.trainable()
    with pytest.raises(NotImplementedError, match="regen=False"):
        integrators.render(pm.with_trainable(params), seed=SEED, regen=True,
                           samples_per_pass=64)
