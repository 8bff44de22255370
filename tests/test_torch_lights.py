"""The port's emitters against the JAX package's on one scene (loaded by
both packages from one dict) and the same numpy rays and samples: area
lights on a sphere, a disk, a rectangle and a mesh quad, a point light,
the constant environment and the directional sun.

Per kind: area ``eval``, ``sample_direction`` and ``pdf_direction``,
constant ``eval`` and ``sample_direction``, point ``sample_direction``.
Scene level: ``sample_emitter_direction`` (uniform pick, the kind's
sample, the shadow ray) with three emitters of mixed kinds (area, point,
constant) and with all seven, ``pdf_emitter_direction``,
``eval_emitter_hit`` and ``eval_environment``. Directions, points and
values within rtol 1e-5 (atol 1e-6), pdfs within rtol 1e-5: the same
float32 expressions, rounded alike but for XLA's contracted
multiply-adds; a shadow ray or a mesh face pick that flips on such an
ulp is allowed on at most 0.5 % of the lanes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu import emitters as jemitters
from eradiate_kernel_tpu.core.ray import Ray as JRay
from eradiate_kernel_tpu.render import geometry as jgeometry
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch import emitters
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.render import geometry
from eradiate_kernel_tpu_torch.scene import load_dict
from test_torch_shapes import rays

RTOL, ATOL = 1e-5, 1e-6
N = 2048


def lights_dict(which="all"):
    """Emitters over a diffuse floor; ``which`` = 'three' keeps one area
    light (the sphere), the point light and the environment."""
    floor = [[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]]
    d = {
        "type": "scene",
        "floor": {"type": "mesh", "vertices": np.float32(floor),
                  "faces": np.int32([[0, 1, 2], [0, 2, 3]]),
                  "bsdf": {"type": "diffuse", "reflectance": 0.4}},
        "bulb": {"type": "sphere", "center": [0.4, 0.3, 0.9],
                 "radius": 0.2,
                 "emitter": {"type": "area", "radiance": [3.0, 2.0, 1.0]}},
        "lamp": {"type": "point", "position": [-0.5, 0.2, 1.4],
                 "intensity": [2.0, 2.5, 3.0]},
        "sky": {"type": "constant", "radiance": [0.2, 0.3, 0.4]},
        "camera": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}}},
    }
    if which == "all":
        d["panel"] = {
            "type": "rectangle",
            "to_world": [{"type": "scale", "value": [0.3, 0.2, 1.0]},
                         {"type": "rotate", "axis": [1, 0, 0],
                          "angle": 160.0},
                         {"type": "translate", "value": [-0.4, -0.5, 1.3]}],
            "emitter": {"type": "area", "radiance": 5.0}}
        d["spot"] = {
            "type": "disk",
            "to_world": [{"type": "scale", "value": 0.25},
                         {"type": "rotate", "axis": [0, 1, 0],
                          "angle": 150.0},
                         {"type": "translate", "value": [0.6, -0.4, 1.1]}],
            "emitter": {"type": "area", "radiance": [1.0, 4.0, 2.0]}}
        d["quad"] = {
            "type": "mesh",
            "vertices": np.float32([[-0.3, 0.5, 1.6], [0.3, 0.5, 1.6],
                                    [0.3, 1.0, 1.5], [-0.3, 1.0, 1.5]]),
            "faces": np.int32([[0, 2, 1], [0, 3, 2]]),
            "emitter": {"type": "area", "radiance": [2.0, 2.0, 6.0]}}
        d["sun"] = {"type": "directional", "direction": [0.2, 0.1, -1.0],
                    "irradiance": 0.5}
    return d


_SCENES = {}


def scenes(which="all"):
    if which not in _SCENES:
        d = lights_dict(which)
        _SCENES[which] = (jload_dict(d), load_dict(d, device="cpu"))
    return _SCENES[which]


def floor_points(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform([-1.5, -1.5, 0.0], [1.5, 1.5, 0.0], (n, 3))
    return p.astype(np.float32)


def samples(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(n, dtype=np.float32), rng.random(n, dtype=np.float32),
            rng.random((n, 2), dtype=np.float32))


def close(a, b, what, rtol=RTOL, atol=ATOL, mask=None):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def kind_slots(scene, kind):
    k = scene.config.emitter_kinds.index(kind)
    return (scene.emitter_slot[scene.emitter_kind == k]).numpy()


@pytest.mark.parametrize("kind", ["area", "constant", "point"])
def test_kind_sample_direction_matches_reference(kind):
    jscene, scene = scenes()
    slots = kind_slots(scene, kind)
    ref_p = floor_points(N, seed=1)
    _s_pick, s1, s2 = samples(N, seed=2)
    slot = slots[np.arange(N) % len(slots)].astype(np.int32)
    active = np.ones(N, bool)
    jds, jv = jemitters.KIND_SAMPLERS[kind](
        jscene, jscene.emitters[kind], jnp.asarray(slot), jnp.asarray(ref_p),
        jnp.zeros((N, 0)), jnp.asarray(s1), jnp.asarray(s2),
        jnp.asarray(active))
    ds, v = emitters.KIND_SAMPLERS[kind](
        scene, scene.emitters[kind], torch.as_tensor(slot),
        torch.as_tensor(ref_p), torch.zeros(N, 0), torch.as_tensor(s1),
        torch.as_tensor(s2), torch.as_tensor(active))
    # an area sample picks a mesh face by a searchsorted: an ulp at a
    # cumsum edge may pick the neighbour
    same = np.isclose(ds.p.numpy(), np.asarray(jds.p), rtol=RTOL,
                      atol=1e-5).all(-1)
    assert same.mean() > 0.995
    for name in ("p", "n", "uv", "d", "dist", "pdf"):
        close(getattr(ds, name), getattr(jds, name), name, mask=same)
    np.testing.assert_array_equal(ds.delta.numpy(), np.asarray(jds.delta))
    close(v, jv, "value", mask=same)
    if kind == "area":
        assert (ds.pdf.numpy() > 0).mean() > 0.3  # front-facing samples
        pdf = emitters.area_pdf_direction(
            scene, scene.emitters["area"], torch.as_tensor(slot),
            torch.as_tensor(ref_p), ds.p, ds.n, torch.as_tensor(active))
        jpdf = jemitters.area_pdf_direction(
            jscene, jscene.emitters["area"], jnp.asarray(slot),
            jnp.asarray(ref_p), jds.p, jds.n, jnp.asarray(active))
        close(pdf, jpdf, "area pdf", mask=same)
        # pdf_direction agrees with the sample's own pdf where it is front
        front = same & (ds.pdf.numpy() > 0)
        close(pdf, ds.pdf, "pdf vs sample pdf", rtol=1e-4, mask=front)


def intersections(jscene, scene, o, d):
    """The reference's surface interaction of rays (o, d) and the port's,
    recomputed from the reference's preliminary hit."""
    jray = JRay.make(jnp.asarray(o), jnp.asarray(d))
    jpi = jgeometry.ray_intersect_preliminary(jscene.geo, jray)
    jsi = jgeometry.compute_surface_interaction(jscene.geo, jray, jpi)
    pi = geometry.PreliminaryIntersection(
        *[torch.tensor(np.asarray(x)) for x in (
            jpi.t, jpi.prim_uv, jpi.prim_index, jpi.shape_index)])
    ray = Ray.make(torch.as_tensor(o), torch.as_tensor(d))
    return jray, jsi, ray, geometry.compute_surface_interaction(scene.geo,
                                                               ray, pi)


def test_hit_eval_and_pdf_match_reference():
    """Rays from the floor up toward the lights: the radiance an area
    light emits toward them, the environment's for the escaped ones, and
    emitter sampling's pdf of each direction (the MIS weight's)."""
    jscene, scene = scenes()
    o = floor_points(N, seed=3) + np.float32([0, 0, 1e-3])
    rng = np.random.default_rng(4)
    tgt = rng.uniform([-0.8, -0.8, 0.8], [0.8, 1.2, 1.7], (N, 3))
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    jray, jsi, ray, si = intersections(jscene, scene, o, d)
    em = scene.shape_emitter[si.shape_index.clamp(min=0)].numpy()
    hit_light = si.is_valid.numpy() & (em >= 0)
    assert hit_light.mean() > 0.2 and (~si.is_valid.numpy()).mean() > 0.1
    active = np.ones(N, bool)
    jact = jnp.asarray(active)
    act = torch.as_tensor(active)
    close(emitters.eval_emitter_hit(scene, si, act),
          jemitters.eval_emitter_hit(jscene, jsi, jact), "eval_emitter_hit")
    escaped = ~si.is_valid
    close(emitters.eval_environment(scene, ray, escaped, act),
          jemitters.eval_environment(jscene, jray, ~jsi.is_valid, jact),
          "eval_environment")
    close(emitters.pdf_emitter_direction(scene, ray.o, si, escaped, act),
          jemitters.pdf_emitter_direction(jscene, jray.o, jsi, ~jsi.is_valid,
                                          jact, d=jray.d),
          "pdf_emitter_direction")
    v = emitters.eval_emitter_hit(scene, si, act).numpy()
    assert (v[hit_light].max(-1) > 0).mean() > 0.3  # front faces


@pytest.mark.parametrize("which", ["three", "all"])
def test_scene_sampling_matches_reference(which):
    """Scene::sample_emitter_direction with the shadow ray, from floor
    points: the pick, the sample and the visibility-tested weight."""
    jscene, scene = scenes(which)
    assert scene.config.n_emitters == (3 if which == "three" else 7)
    o = floor_points(N, seed=5) + np.float32([0, 0, 1e-3])
    d = np.tile(np.float32([0, 0, -1]), (N, 1))  # down onto the floor
    o = o + np.float32([0, 0, 0.5])
    jray, jsi, ray, si = intersections(jscene, scene, o, d)
    assert si.is_valid.all()
    s_pick, s1, s2 = samples(N, seed=6)
    active = np.ones(N, bool)
    jds, jw = jemitters.sample_emitter_direction(
        jscene, jsi, jnp.asarray(s_pick), jnp.asarray(s1), jnp.asarray(s2),
        jnp.asarray(active))
    ds, w = emitters.sample_emitter_direction(
        scene, si, torch.as_tensor(s_pick), torch.as_tensor(s1),
        torch.as_tensor(s2), torch.as_tensor(active))
    np.testing.assert_array_equal(ds.emitter_index.numpy(),
                                  np.asarray(jds.emitter_index))
    kinds = scene.emitter_kind[ds.emitter_index.long()].numpy()
    assert len(set(kinds)) == len(scene.config.emitter_kinds)
    same = np.isclose(ds.p.numpy(), np.asarray(jds.p), rtol=RTOL,
                      atol=1e-5).all(-1)
    same &= np.isclose(w.numpy(), np.asarray(jw), rtol=RTOL,
                       atol=ATOL).all(-1)
    assert same.mean() > 0.995, same.mean()
    for name in ("p", "n", "uv", "d", "dist", "pdf"):
        close(getattr(ds, name), getattr(jds, name), name, mask=same)
    np.testing.assert_array_equal(ds.delta.numpy(), np.asarray(jds.delta))
    close(w, jw, "weight", mask=same)
    unoccluded = w.numpy().max(-1) > 0
    assert 0.2 < unoccluded.mean() < 1.0
