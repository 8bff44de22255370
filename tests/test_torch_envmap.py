"""The spot, projector and envmap emitters of slice 5c-2 and the
Hierarchical2D warp in the port against the JAX package, on one scene
(loaded by both packages from one dict) and the same numpy inputs made
from a seed.

- Hierarchical2D ``sample``, ``pdf`` and ``invert`` on a grid with a hot
  texel, odd sizes (padded mip levels) and zero rows.
- Each of spot, projector and envmap: ``sample_direction``; the envmap's
  ``eval`` and ``pdf_direction``; scene-level ``eval_environment`` and
  ``pdf_emitter_direction`` (the escaped ray's direction ``d``).
- ``sample_emitter_ray`` for every kind that has one (area, constant,
  point, directional, spot, projector), and the envmap's refusal.
- An envmap read from an EXR file: the reference's arrays.
- Renders on the scan driver and the lane pool, by ``path`` and
  ``volpath``, within tests/conftest.py::assert_driver_equivalent's budget
  (1e-4 relative a pixel, 2 flipped pixels); the gradient with respect to
  the envmap's ``image`` against the reference's jax.grad (rtol 5e-3, atol
  1e-7).

Values within rtol 1e-5 (atol 1e-6), as tests/test_torch_lights.py: the
same float32 expressions but for XLA's contracted multiply-adds. On at
most 0.5 % of the lanes within rtol 1e-3 only: the hierarchical descent
compares running sums with its mip sums (an ulp may send a lane to the
neighbouring patch), the spot's falloff (cos - cos_cutoff) cancels at the
cutoff, and next to the sun texel, 10^3 times the sky, an ulp of acos or
atan2 moves the interpolated radiance by 1e-4 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import emitters as jemitters
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.core import hierarchical2d as jh2d
from eradiate_kernel_tpu.core.rng import Sampler as JSampler
from eradiate_kernel_tpu.core.ray import Ray as JRay
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu_torch import emitters, integrators
from eradiate_kernel_tpu_torch.core import hierarchical2d as h2d
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.core.rng import Sampler
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff, bitmap
from test_torch_lights import floor_points, lights_dict, samples
from test_torch_scene import reference_arrays

N = 4096
RTOL, ATOL = 1e-5, 1e-6


def close(a, b, what, rtol=RTOL, atol=ATOL, mask=None, miss=0.005):
    """Rows of a and b within rtol/atol but for ``miss`` of them, which
    must agree within rtol 1e-3."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    if mask is not None:
        a, b = a[mask], b[mask]
    a = a.reshape(len(a), -1)
    b = b.reshape(len(b), -1)
    tight = np.isclose(a, b, rtol=rtol, atol=atol).all(-1)
    assert (~tight).mean() <= miss, (what, (~tight).mean())
    np.testing.assert_allclose(a, b, rtol=max(rtol, 1e-3), atol=atol,
                               err_msg=what)


def sky(h=9, w=14, seed=0):
    """A smooth lat-long sky with a one-texel sun 10^3 times brighter."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, np.pi, h)[:, None, None]
    img = (0.2 + 0.1 * np.cos(theta) + 0.05 * rng.random((h, w, 3)))
    img[2, 5] = 300.0
    return img.astype(np.float32)


def emitters_dict(env=True):
    d = lights_dict("three")
    del d["sky"]
    d["spot"] = {"type": "spot", "position": [0.3, -0.2, 1.6],
                 "direction": [-0.1, 0.2, -1.0], "cutoff_angle": 35.0,
                 "beam_width": 20.0, "intensity": [4.0, 3.0, 2.0]}
    rng = np.random.default_rng(9)
    d["slides"] = {
        "type": "projector", "fov": 50.0,
        "to_world": [{"type": "lookat", "origin": [-0.6, 0.5, 1.8],
                      "target": [0.0, 0.0, 0.0], "up": [0, 1, 0]}],
        "irradiance": {"type": "bitmap",
                       "data": rng.random((12, 16, 3)).astype(np.float32)}}
    if env:
        d["env"] = {"type": "envmap", "data": sky(), "scale": 0.7,
                    "to_world": [{"type": "rotate", "axis": [0, 0, 1],
                                  "angle": 30.0}]}
    return d


_SCENES = {}


def scenes(env=True):
    if env not in _SCENES:
        d = emitters_dict(env)
        _SCENES[env] = (jload_dict(d), load_dict(d, device="cpu"))
    return _SCENES[env]


def slot_of(scene, kind):
    k = scene.config.emitter_kinds.index(kind)
    return int(scene.emitter_slot[scene.emitter_kind == k][0])


def test_hierarchical2d_matches_reference():
    rng = np.random.default_rng(1)
    grid = rng.random((2, 11, 14)) ** 2
    grid[0, 4, 6] = 500.0
    grid[1, 3] = 0.0
    tabs, jtabs = h2d.build_hierarchical2d(grid), \
        jh2d.build_hierarchical2d(grid)
    assert set(tabs) == set(jtabs)
    for k in tabs:
        np.testing.assert_array_equal(tabs[k], jtabs[k], err_msg=k)
    params = {k: torch.as_tensor(v) for k, v in tabs.items()}
    jparams = {k: jnp.asarray(v) for k, v in jtabs.items()}
    slot = (np.arange(N) % 2).astype(np.int32)
    u = rng.random((N, 2), dtype=np.float32)
    pos, pdf = h2d.h2d_sample(params, torch.as_tensor(slot),
                              torch.as_tensor(u))
    jpos, jpdf = jh2d.h2d_sample(jparams, jnp.asarray(slot), jnp.asarray(u))
    close(pos, jpos, "sample pos", rtol=RTOL, atol=ATOL)
    close(pdf, jpdf, "sample pdf")
    close(h2d.h2d_pdf(params, torch.as_tensor(slot), pos),
          jh2d.h2d_pdf(jparams, jnp.asarray(slot), jpos), "pdf")
    inv, ipdf = h2d.h2d_invert(params, torch.as_tensor(slot), pos)
    jinv, jipdf = jh2d.h2d_invert(jparams, jnp.asarray(slot), jpos)
    close(inv, jinv, "invert", atol=1e-5)
    close(ipdf, jipdf, "invert pdf")
    np.testing.assert_allclose(inv.numpy(), u, atol=1e-3)  # a round trip
    # the sun's patch gets its share of the samples
    assert (pdf.numpy()[slot == 0] > 50).mean() > 0.3


@pytest.mark.parametrize("kind", ["spot", "projector", "envmap"])
def test_kind_sample_direction_matches_reference(kind):
    jscene, scene = scenes()
    slot = np.full(N, slot_of(scene, kind), np.int32)
    ref_p = floor_points(N, seed=1)
    _s_pick, s1, s2 = samples(N, seed=2)
    active = np.ones(N, bool)
    jds, jv = jemitters.KIND_SAMPLERS[kind](
        jscene, jscene.emitters[kind], jnp.asarray(slot), jnp.asarray(ref_p),
        jnp.zeros((N, 0)), jnp.asarray(s1), jnp.asarray(s2),
        jnp.asarray(active))
    ds, v = emitters.KIND_SAMPLERS[kind](
        scene, scene.emitters[kind], torch.as_tensor(slot),
        torch.as_tensor(ref_p), torch.zeros(N, 0), torch.as_tensor(s1),
        torch.as_tensor(s2), torch.as_tensor(active))
    same = np.isclose(ds.d.numpy(), np.asarray(jds.d), rtol=RTOL,
                      atol=1e-5).all(-1)
    assert same.mean() >= 0.995
    for name in ("p", "n", "uv", "d", "dist", "pdf"):
        close(getattr(ds, name), getattr(jds, name), name, mask=same)
    np.testing.assert_array_equal(ds.delta.numpy(), np.asarray(jds.delta))
    close(v, jv, "value", mask=same)
    assert (v.numpy().max(-1) > 0).mean() > 0.2
    if kind == "envmap":
        pdf = emitters.envmap_pdf_direction(
            scene, scene.emitters["envmap"], torch.as_tensor(slot), ds.d,
            torch.as_tensor(active))
        close(pdf, ds.pdf, "pdf_direction vs the sample's", rtol=1e-3)


def test_envmap_eval_and_mis_pdf_match_reference():
    """Escaped rays: the environment's radiance and emitter sampling's pdf
    of their direction (the MIS weight's), by direction ``d``."""
    jscene, scene = scenes()
    o = floor_points(N, seed=3) + np.float32([0, 0, 1e-3])
    rng = np.random.default_rng(4)
    d = rng.normal(size=(N, 3))
    d[:, 2] = np.abs(d[:, 2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jray = JRay.make(jnp.asarray(o), jnp.asarray(d))
    ray = Ray.make(torch.as_tensor(o), torch.as_tensor(d))
    from eradiate_kernel_tpu.render import geometry as jgeometry
    from eradiate_kernel_tpu_torch.render import geometry

    jsi = jgeometry.ray_intersect(jscene.geo, jray)
    si = geometry.ray_intersect(scene.geo, ray)
    escaped = ~si.is_valid
    assert escaped.float().mean() > 0.5
    act = torch.ones(N, dtype=torch.bool)
    jact = jnp.ones(N, bool)
    close(emitters.eval_environment(scene, ray, escaped, act),
          jemitters.eval_environment(jscene, jray, ~jsi.is_valid, jact),
          "eval_environment")
    close(emitters.pdf_emitter_direction(scene, ray.o, si, escaped, act,
                                         d=ray.d),
          jemitters.pdf_emitter_direction(jscene, jray.o, jsi,
                                          ~jsi.is_valid, jact, d=jray.d),
          "pdf_emitter_direction")
    slot = torch.full((N,), slot_of(scene, "envmap"), dtype=torch.int32)
    close(emitters.envmap_eval(scene, scene.emitters["envmap"], slot, ray.d,
                               torch.zeros(N, 0), act),
          jemitters.envmap_eval(jscene, jscene.emitters["envmap"],
                                jnp.asarray(slot.numpy()), jray.d,
                                jnp.zeros((N, 0)), jact), "envmap_eval")


@pytest.mark.parametrize("seed", [0, 11])
def test_sample_emitter_ray_matches_reference(seed):
    """Every kind with a ray sampler: area (sphere), point, spot,
    projector (scene 'three' without its sky) plus the constant sky and
    the directional sun."""
    d = emitters_dict(env=False)
    d["sky"] = {"type": "constant", "radiance": [0.2, 0.3, 0.4]}
    d["sun"] = {"type": "directional", "direction": [0.2, 0.1, -1.0],
                "irradiance": 0.5}
    jscene, scene = jload_dict(d), load_dict(d, device="cpu")
    assert set(scene.config.emitter_kinds) == set(
        emitters.KIND_RAY_SAMPLERS)
    lane = np.arange(N, dtype=np.uint32)
    ray, w, idx, _ = emitters.sample_emitter_ray(
        scene, Sampler.seed(seed, torch.as_tensor(lane.astype(np.int64))),
        torch.zeros(N))
    jray, jw, jidx, _ = jemitters.sample_emitter_ray(
        jscene, JSampler.seed(seed, jnp.asarray(lane)), jnp.zeros(N))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert len(np.unique(idx.numpy())) == scene.config.n_emitters
    for name in ("o", "d", "mint", "maxt"):
        close(getattr(ray, name), getattr(jray, name), name)
    close(w, jw, "weight")
    assert (w.numpy().max(-1) > 0).mean() > 0.5


def test_sample_emitter_ray_refuses_an_envmap():
    jscene, scene = scenes()
    lane = torch.arange(8)
    with pytest.raises(NotImplementedError, match="envmap"):
        emitters.sample_emitter_ray(scene, Sampler.seed(0, lane),
                                    torch.zeros(8))
    with pytest.raises(NotImplementedError, match="envmap"):
        jemitters.sample_emitter_ray(jscene, JSampler.seed(
            0, jnp.arange(8, dtype=jnp.uint32)), jnp.zeros(8))


def test_envmap_from_a_file_refuses(tmp_path, monkeypatch):
    """An envmap read from a ZIP EXR (f16) loads the reference's arrays bit
    for bit; one compressed with DWAA, which only libOpenEXR reads,
    refuses where the port's OpenEXR bridge is absent (made so here)."""
    d = emitters_dict()
    path = str(tmp_path / "sky.exr")
    bitmap.write_exr(path, d["env"].pop("data"), pixel_type="f16")
    d["env"]["filename"] = path
    ref = reference_arrays(jload_dict(d))
    arrays = load_dict(d, device="cpu").arrays()
    assert arrays["emitters.envmap.image"].shape[1:] == (9, 15, 3)
    for name, a in arrays.items():
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    key = b"compression\x00compression\x00\x01\x00\x00\x00"
    data[data.index(key) + len(key)] = 8  # DWAA
    with open(path, "wb") as f:
        f.write(bytes(data))
    monkeypatch.setattr(bitmap, "_load_bridge", lambda: None)
    with pytest.raises(NotImplementedError, match="libOpenEXR"):
        load_dict(d, device="cpu")


def render_dict(integrator):
    d = emitters_dict()
    d["camera"] = {
        "type": "perspective", "fov": 60.0,
        "to_world": [{"type": "lookat", "origin": [0.0, -2.5, 1.6],
                      "target": [0.0, 0.0, 0.5], "up": [0, 0, 1]}],
        "film": {"type": "hdrfilm", "width": 16, "height": 16,
                 "rfilter": {"type": "box"}},
        "sampler": {"type": "independent", "sample_count": 4}}
    d["integrator"] = {"type": integrator, "max_depth": 4}
    return d


@pytest.mark.parametrize("integrator", ["path", "volpath"])
def test_renders_match_reference(integrator):
    d = render_dict(integrator)
    jscene = jload_dict(d)
    scene = load_dict(d, device="cpu")
    assert scene.config.env_emitter >= 0
    ref = np.asarray(jintegrators.render(jscene, seed=3))
    assert ref.mean() > 0.1
    assert_driver_equivalent(ref, integrators.render(scene, seed=3).numpy(),
                             max_flips=2)
    pool = integrators.render(scene, seed=3, regen=True,
                              samples_per_pass=200).numpy()
    assert_driver_equivalent(ref, pool, max_flips=2)


def test_envmap_image_gradient_matches_reference():
    d = render_dict("path")
    d["camera"]["film"].update(width=8, height=8)
    key = "emitters.envmap.image"
    jpm = jad.traverse(jload_dict(d))
    jpm.keep([key])

    def loss(tr):
        return jnp.mean(jintegrators.render(jpm.with_trainable(tr), seed=2,
                                            samples_per_pass=64))

    ref = np.asarray(jax.grad(loss)(jpm.trainable())[key])
    pm = autodiff.traverse(load_dict(d, device="cpu")).keep([key])
    for regen in (False, True):
        params = pm.trainable()
        integrators.render(pm.with_trainable(params), seed=2,
                           samples_per_pass=64,
                           regen=regen).mean().backward()
        g = params[key].grad.numpy()
        assert np.isfinite(g).all() and np.abs(ref).sum() > 0
        np.testing.assert_allclose(g, ref, rtol=5e-3, atol=1e-7,
                                   err_msg=f"regen={regen}")
