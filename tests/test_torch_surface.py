"""Surface scenes of slice 5a in the port against the JAX package: the
analytic gates (a constant environment, the furnace sphere, the Cornell
box's mean), the Cornell box through
the scan driver and the lane pool, the ``direct`` and ``depth``
integrators, an emissive mesh over the terrain, and ``render(regen=True)``
on a path scene running the lane pool (it used to take the scan driver
without a word).

Films are compared at the same seed within
tests/conftest.py::assert_driver_equivalent's budget (1e-4 relative a
pixel, 2 flipped pixels): both packages draw the same random numbers, and
the reference renders its meshes with its brute-force sweep (its CPU
policy), the port with the plain tile sweep, which agree to an ulp."""

import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from bench_mesh import terrain
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import scenes as jscenes
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.integrators import replay
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff, scenes
from test_torch_scene import terrain_scene

LANES = 100  # a pool far smaller than the films' samples: many refills


def both(name, *args, **kw):
    """(reference scene, port scene) of utils.scenes.<name>(...), each
    package's own factory."""
    return (jload_dict(getattr(jscenes, name)(*args, **kw)),
            load_dict(getattr(scenes, name)(*args, **kw), device="cpu"))


def test_gate_constant_environment():
    """Escaped rays see the constant environment exactly: 0.7 -> 0.7."""
    scene = load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 8, "height": 8,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 4}},
        "env": {"type": "constant", "radiance": 0.7},
    }, device="cpu")
    for regen in (False, True):
        img = integrators.render(scene, regen=regen, samples_per_pass=64)
        torch.testing.assert_close(img, torch.full_like(img, 0.7),
                                   rtol=0, atol=1e-3)


def test_gate_furnace_sphere():
    """A diffuse sphere in a constant environment: the centre pixels see
    albedo x radiance (tests/test_render.py's figures: atol 0.02 at 128
    spp), the corners the environment."""
    scene = load_dict(scenes.furnace(albedo=0.6, radiance=1.0, width=16,
                                     height=16, spp=128, max_depth=16),
                      device="cpu")
    img = integrators.render(scene, seed=3).numpy()
    np.testing.assert_allclose(img[6:10, 6:10].mean(axis=(0, 1)), 0.6,
                               atol=0.02)
    np.testing.assert_allclose(img[0, 0], 1.0, atol=0.02)


def test_gate_cornell_box_and_reference_film():
    """The Cornell box at 16x16, 8 spp: mean 0.14 (the repository's gate,
    within 0.005), and the reference's film through the port's scan driver and
    lane pool."""
    jscene, scene = both("cornell_box", width=16, height=16, spp=8,
                         max_depth=3)
    ref = np.asarray(jintegrators.render(jscene, seed=0))
    scan = integrators.render(scene, seed=0).numpy()
    pool = integrators.render(scene, seed=0, regen=True,
                              samples_per_pass=LANES).numpy()
    assert abs(scan.mean() - 0.14) < 0.005, scan.mean()
    assert_driver_equivalent(ref, scan, max_flips=2)
    assert_driver_equivalent(ref, pool, max_flips=2)


@pytest.mark.parametrize("kind", ["direct", "depth"])
def test_direct_and_depth_match_reference(kind):
    """direct: the Cornell box (area light, MIS of light and BSDF
    samples); depth: the furnace sphere (distance to the first hit). Both
    take the scan driver under render(regen=True), as in the reference."""
    name = "cornell_box" if kind == "direct" else "furnace"
    jscene, scene = both(name, width=16, height=16, spp=8,
                         integrator=kind)
    ref = np.asarray(jintegrators.render(jscene, seed=2))
    img = integrators.render(scene, seed=2).numpy()
    assert ref.mean() > 0.05
    assert_driver_equivalent(ref, img, max_flips=2)
    assert not integrators.regen_supported(scene.config)
    regen = integrators.render(scene, seed=2, regen=True).numpy()
    np.testing.assert_array_equal(regen, img)
    if kind == "depth":
        assert img[8, 8, 0] == pytest.approx(3.0, abs=0.1)
        assert img[0, 0, 0] == 0.0


def emissive_terrain_dict():
    """terrain(23) (968 triangles, 8 tiles: the plain sweep) lit by an
    emissive mesh quad above it facing down, and the sun."""
    d = terrain_scene(n=23, width=16, height=16, spp=4, max_depth=3)
    d["light"] = {
        "type": "mesh",
        "vertices": np.float32([[-0.4, -0.2, 1.0], [0.4, -0.2, 1.0],
                                [0.4, 0.4, 0.9], [-0.4, 0.4, 0.9]]),
        "faces": np.int32([[0, 2, 1], [0, 3, 2]]),
        "emitter": {"type": "area", "radiance": [4.0, 3.0, 2.0]}}
    return d


def test_emissive_mesh_over_terrain_matches_reference():
    """The mesh branch of shape sampling (a face picked by one
    searchsorted over the face-area cumsum) with the plain sweep, through
    both drivers."""
    d = emissive_terrain_dict()
    jscene = jload_dict(d)
    scene = load_dict(d, device="cpu")
    assert scene.config.emitter_kinds == ("directional", "area")
    ref = np.asarray(jintegrators.render(jscene, seed=4))
    img = integrators.render(scene, seed=4).numpy()
    assert ref.mean() > 0.05
    assert_driver_equivalent(ref, img, max_flips=2)
    pool = integrators.render(scene, seed=4, regen=True,
                              samples_per_pass=LANES).numpy()
    assert_driver_equivalent(ref, pool, max_flips=2)


def test_regen_runs_the_lane_pool_on_a_path_scene(monkeypatch):
    """render(regen=True) on a path scene runs the lane pool (it used to
    take the scan driver), and its film is the reference's
    render(regen=True) film; under autograd it runs the path replay."""
    d = terrain_scene(n=23, width=16, height=16, spp=4, max_depth=3)
    jscene = jload_dict(d)
    scene = load_dict(d, device="cpu")
    ref = np.asarray(jintegrators.render(jscene, seed=5, regen=True,
                                         samples_per_pass=128))
    pools = []
    run_pool = integrators._run_pool

    def counted(*a, stats=None, **kw):
        stats = {} if stats is None else stats
        out = run_pool(*a, stats=stats, **kw)
        pools.append(stats)
        return out

    monkeypatch.setattr(integrators, "_run_pool", counted)
    img = integrators.render(scene, seed=5, regen=True,
                             samples_per_pass=128).numpy()
    assert integrators.regen_supported(scene.config)
    assert len(pools) == 1 and pools[0]["dropped"] == 0
    assert pools[0]["iterations"] > 3  # 1,024 samples through 128 lanes
    assert_driver_equivalent(ref, img, max_flips=2)

    monkeypatch.setattr(replay, "_run_pool", counted)
    pm = autodiff.traverse(scene).keep(["spectra.baked.value"])
    params = pm.trainable()
    before = dict(replay.counters)
    out = integrators.render(pm.with_trainable(params), seed=5, regen=True,
                             samples_per_pass=128)
    out.mean().backward()
    assert replay.counters["forward_iterations"] > before[
        "forward_iterations"]
    assert replay.counters["adjoint_iterations"] > before[
        "adjoint_iterations"]
    assert len(pools) == 3  # the forward and the adjoint
    np.testing.assert_array_equal(out.detach().numpy(), img)
