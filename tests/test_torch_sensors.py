"""The port's sensors against the JAX package's on the same scene dicts:

- the cases of tests/test_sensors.py that the port carries (the spectral
  srf cases and the XML tag are slice 6 and 7), rendered by both packages
  at the same seed: the films agree within 1e-5 and both pass the
  analytic gate of the reference's test;
- each sensor's ``sample_ray`` from the same sampler state: origins and
  directions within 1e-6 (absolute, scaled by the scene's bounding
  sphere for origins), weights within 1e-5 relative, times equal, and the
  sampler counters equal (every draw in the reference's order: the
  shutter's time first, distant's aperture before the wavelength draw,
  irradiancemeter's 1-D, 2-D, 2-D);
- the scene arrays (``_build_srf``'s among them) bit for bit, and the
  config equal;
- a radiancemeter inside a medium (the sensor's medium reaches volpath);
- the distant-sensor geometry oracles of tests/test_eradiate_oracles.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu import sensors as jsensors
from eradiate_kernel_tpu.core.rng import Sampler as JSampler
from eradiate_kernel_tpu.core.transform import \
    AnimatedTransform as JAnimatedTransform
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import scenes as jscenes
from eradiate_kernel_tpu_torch import integrators, sensors
from eradiate_kernel_tpu_torch.core.rng import Sampler
from eradiate_kernel_tpu_torch.core.transform import AnimatedTransform
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import scenes
from test_torch_scene import port_config, reference_arrays

BOX = {"type": "box"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests: several pytest workers
    on one host each running torch's full thread pool spin against each
    other (a 1-second render took 100 s under four workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(d, jd=None):
    """(reference scene, port scene) of one dict (``jd`` for the reference
    where the two packages' factories differ), their arrays bit-equal and
    their configs equal."""
    jscene = jload_dict(jd if jd is not None else d)
    scene = load_dict(d, device="cpu")
    ref = reference_arrays(jscene)
    for name, a in scene.arrays().items():
        assert a.shape == ref[name].shape, name
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    assert scene.config == port_config(jscene.config)
    return jscene, scene


def env_dict(sensor, radiance=0.7, extra=None, spp=32):
    d = {"type": "scene", "integrator": {"type": "path", "max_depth": 4},
         "sensor": {**sensor, "sampler": {"type": "independent",
                                          "sample_count": spp}},
         "env": {"type": "constant", "radiance": radiance}}
    d.update(extra or {})
    return d


def _rect(scale, refl):
    return {"type": "rectangle", "to_world": {"type": "scale",
                                              "value": scale},
            "bsdf": {"type": "diffuse", "reflectance": refl}}


def _close(v):
    return lambda img: np.allclose(img, v, atol=1e-3)


# (dict, seed, gate on the port's developed image): tests/test_sensors.py
GATES = {
    "distant_single_direction": (env_dict({
        "type": "distant", "direction": [0, 0, 1],
        "film": {"width": 1, "height": 1, "rfilter": BOX}}), 1, _close(0.7)),
    "distant_plane_mode": (env_dict({
        "type": "distant", "target": [0.0, 0.0, 0.0],
        "film": {"width": 8, "height": 1, "rfilter": BOX}}), 1, _close(0.7)),
    "distant_hemisphere_mode": (env_dict({
        "type": "distant", "target": [0.0, 0.0, 0.0],
        "film": {"width": 4, "height": 4, "rfilter": BOX}}), 1, _close(0.7)),
    "distant_cross_section_cosine_weight": (env_dict({
        "type": "distant", "direction": [0.6, 0.0, 0.8],
        "film": {"width": 1, "height": 1, "rfilter": BOX}}), 1,
        _close(0.7 / 0.8)),
    "distant_sees_surface": (env_dict({
        "type": "distant", "direction": [0, 0, 1], "target": [0.0, 0.0, 0.0],
        "film": {"width": 1, "height": 1, "rfilter": BOX}}, radiance=1.0,
        spp=512, extra={"surf": _rect(100.0, 0.4)}), 1,
        lambda img: np.allclose(img, 0.4, atol=0.02)),
    "distant_point_target": (env_dict({
        "type": "distant", "direction": [0, 0, 1], "target": [0.0, 0.0, 0.0],
        "film": {"width": 1, "height": 1, "rfilter": BOX}}), 1, _close(0.7)),
    "mdistant": (env_dict({
        "type": "mdistant",
        "directions": [[0, 0, -1], [0.6, 0, -0.8], [0, 0.6, -0.8]]}), 1,
        lambda img: img.shape[:2] == (1, 3) and _close(0.7)(img)),
    "mradiancemeter": (env_dict({
        "type": "mradiancemeter", "origins": [[0, 0, 3], [5, 5, 3]],
        "directions": [[0, 0, -1], [0, 0, 1]]}), 1,
        lambda img: img.shape[:2] == (1, 2) and _close(0.7)(img)),
    "distantflux_constant_env": (env_dict({
        "type": "distantflux",
        "film": {"width": 4, "height": 4, "rfilter": BOX}}, radiance=1.0), 1,
        lambda img: abs(img.sum(axis=(0, 1))[1] - math.pi) < 0.01 * math.pi),
    "irradiancemeter_constant_env": ({
        "type": "scene", "integrator": {"type": "path", "max_depth": 4},
        "meter_shape": _rect(1.0, 0.0),
        "sensor": {"type": "irradiancemeter",
                   "shape": {"type": "ref", "id": "meter_shape"},
                   "film": {"width": 1, "height": 1, "rfilter": BOX},
                   "sampler": {"type": "independent", "sample_count": 256}},
        "env": {"type": "constant", "radiance": 1.0}}, 2,
        lambda img: abs(img[0, 0, 1] - math.pi) < 0.02 * math.pi),
}


@pytest.mark.parametrize("name", sorted(GATES))
def test_sensor_gate_matches_reference(name):
    d, seed, gate = GATES[name]
    jscene, scene = both(d)
    ref = np.asarray(jintegrators.render(jscene, seed=seed))
    img = integrators.render(scene, seed=seed).numpy()
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-5)
    assert gate(img), img


def test_animated_transform_interpolation():
    """Keyframe endpoints, the translation's lerp and the rotation's slerp
    (tests/test_sensors.py), against the reference's eval at 1e-6."""
    frames = [[(0.0, {"type": "look_at", "origin": [0, 0, 3],
                      "target": [0, 0, 0], "up": [0, 1, 0]}),
               (1.0, {"type": "look_at", "origin": [2, 0, 3],
                      "target": [2, 0, 0], "up": [0, 1, 0]})],
              [(0.0, {"type": "rotate", "axis": [0, 0, 1], "angle": 0.0}),
               (1.0, {"type": "rotate", "axis": [0, 0, 1], "angle": 90.0})]]
    ts = np.asarray([0.0, 0.25, 0.5, 1.0, 1.5], np.float32)
    for f in frames:
        at, jat = (AnimatedTransform.from_keyframes(f),
                   JAnimatedTransform.from_keyframes(f))
        for name in ("times", "translations", "quats", "stretches"):
            np.testing.assert_array_equal(getattr(at, name),
                                          np.asarray(getattr(jat, name)))
        m = at.eval(torch.as_tensor(ts)).m.numpy()
        np.testing.assert_allclose(m, np.asarray(jat.eval(jnp.asarray(ts)).m),
                                   atol=1e-6)
    v = at.eval(torch.tensor(0.5)).transform_vector(
        torch.tensor([1.0, 0.0, 0.0])).numpy()
    assert np.allclose(v, [math.sqrt(0.5), math.sqrt(0.5), 0.0], atol=1e-6)


def _motion_blur(factory):
    d = factory(width=8, height=8, spp=4, max_depth=3)
    d["sensor"]["to_world"] = {"type": "animation", "keyframes": [
        [0.0, {"type": "look_at", "origin": [0, 0, -3.9],
               "target": [0, 0, 0], "up": [0, 1, 0]}],
        [1.0, {"type": "look_at", "origin": [0.4, 0, -3.9],
               "target": [0.4, 0, 0], "up": [0, 1, 0]}]]}
    d["sensor"].update(shutter_open=0.0, shutter_close=1.0)
    return d


def test_motion_blur_camera():
    """An animated camera with a shutter: ray origins span the keyframe
    path, and the film is the reference's and not the static one."""
    jscene, scene = both(_motion_blur(scenes.cornell_box),
                         _motion_blur(jscenes.cornell_box))
    assert "to_world_anim" in scene.sensor
    n = 64
    smp, _j = Sampler.seed(0, torch.arange(n)).next_2d()
    ray, _w, _s = sensors.sample_ray(scene, smp, torch.full((n, 2), 0.5),
                                     torch.zeros(n))
    ox = ray.o[:, 0].numpy()
    assert ox.min() < 0.05 and ox.max() > 0.35
    img = integrators.render(scene).numpy()
    np.testing.assert_allclose(img, np.asarray(jintegrators.render(jscene)),
                               rtol=1e-4, atol=1e-5)
    static = integrators.render(load_dict(scenes.cornell_box(
        width=8, height=8, spp=4, max_depth=3), device="cpu")).numpy()
    assert not np.allclose(img, static, atol=1e-3)


def test_parse_fov_axes():
    """parse_fov's axes and focal length give the reference's
    tan_half_fov bit for bit (both() compares the arrays)."""
    base = {"type": "perspective",
            "film": {"width": 32, "height": 16, "rfilter": BOX}}
    for extra in ({"fov": 40.0}, {"fov": 40.0, "fov_axis": "y"},
                  {"fov": 40.0, "fov_axis": "smaller"},
                  {"fov": 40.0, "fov_axis": "larger"},
                  {"fov": 40.0, "fov_axis": "diagonal"},
                  {"focal_length": "50mm"}, {}):
        both(env_dict({**base, **extra}))
    # 50 mm on a square film: ~34.02 degrees horizontal
    _j, scene = both(env_dict({"type": "perspective",
                               "film": {"width": 16, "height": 16}}))
    assert float(scene.sensor["tan_half_fov"]) == pytest.approx(
        math.tan(math.radians(34.0222 / 2)), rel=1e-3)
    with pytest.raises(ValueError, match="focal length"):
        load_dict(env_dict({**base, "fov": 30.0, "focal_length": "50mm"}),
                  device="cpu")


SHAPES = {"s": {"type": "sphere", "radius": 1.0, "center": [0.3, -0.2, 0.1],
                "bsdf": {"type": "diffuse"}},
          "meter": {"type": "rectangle",
                    "to_world": [{"type": "scale", "value": [0.5, 0.8, 1]},
                                 {"type": "rotate", "axis": [1, 0, 0],
                                  "angle": 30.0}],
                    "bsdf": {"type": "diffuse"}}}
SHUTTER = {"shutter_open": 0.2, "shutter_close": 0.7}
ANIM = {"type": "animation", "keyframes": [
    [0.0, {"type": "look_at", "origin": [0, -3, 1], "target": [0, 0, 0],
           "up": [0, 0, 1]}],
    [1.0, {"type": "look_at", "origin": [1, -3, 2], "target": [0, 0, 0],
           "up": [0, 0, 1]}]]}
F1 = {"width": 1, "height": 1}
SAMPLE_CASES = {
    "perspective": {"type": "perspective", "fov": 50.0,
                    "to_world": {"type": "look_at", "origin": [0, -4, 1],
                                 "target": [0, 0, 0], "up": [0, 0, 1]},
                    "film": {"width": 6, "height": 4}},
    "perspective shutter anim": {"type": "perspective", "fov": 50.0,
                                 "to_world": ANIM, **SHUTTER,
                                 "film": {"width": 6, "height": 4}},
    "thinlens": {"type": "thinlens", "fov": 40.0, "aperture_radius": 0.2,
                 "focus_distance": 3.0,
                 "to_world": {"type": "look_at", "origin": [0, -4, 1],
                              "target": [0, 0, 0], "up": [0, 0, 1]},
                 "film": {"width": 5, "height": 5}},
    "radiancemeter shutter": {"type": "radiancemeter", **SHUTTER,
                              "to_world": {"type": "look_at",
                                           "origin": [0, 0, 5],
                                           "target": [0.1, 0.2, 0],
                                           "up": [0, 1, 0]},
                              "film": F1},
    "radiancemeter anim": {"type": "radiancemeter", "to_world": ANIM,
                           **SHUTTER, "film": F1},
    "mradiancemeter": {"type": "mradiancemeter",
                       "origins": [[0, 0, 3], [1, 2, 3], [-1, 0, 4]],
                       "directions": [[0, 0, -1], [0.2, 0, -1], [0, 1, 0]]},
    "distant single": {"type": "distant", "direction": [0.3, -0.2, 0.93],
                       "film": F1},
    "distant single target flip": {
        "type": "distant", "direction": [0.3, -0.2, 0.93],
        "target": [0.1, 0.2, 0.0], "flip_directions": True, "film": F1},
    "distant orientation": {"type": "distant", "direction": [0, 0.6, 0.8],
                            "orientation": [1, 0, 0], "film": F1},
    "distant plane": {"type": "distant", "film": {"width": 8, "height": 1}},
    "distant hemisphere": {"type": "distant",
                           "to_world": {"type": "rotate", "axis": [1, 0, 0],
                                        "angle": 20.0},
                           "film": {"width": 4, "height": 3}},
    "mdistant": {"type": "mdistant",
                 "directions": [[0, 0, -1], [0.6, 0, -0.8], [0, 0.6, -0.8]]},
    "mdistant target": {"type": "mdistant", "target": [0.2, 0, 0],
                        "directions": [[0, 0, -1], [0.6, 0, -0.8]]},
    "distantflux": {"type": "distantflux",
                    "film": {"width": 4, "height": 4}},
    "irradiancemeter shutter": {"type": "irradiancemeter", **SHUTTER,
                                "shape": {"type": "ref", "id": "meter"},
                                "film": F1},
}


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_ray_matches_reference(case):
    d = env_dict(SAMPLE_CASES[case], extra=SHAPES)
    jscene, scene = both(d)
    n = 512
    pos = np.random.default_rng(7).random((n, 2)).astype(np.float32)
    jsmp, _ = JSampler.seed(5, jnp.arange(n, dtype=jnp.uint32)).next_2d()
    smp, _ = Sampler.seed(5, torch.arange(n)).next_2d()
    jray, jw, jsmp = jsensors.sample_ray(jscene, jsmp, jnp.asarray(pos),
                                         jnp.zeros(n))
    ray, w, smp = sensors.sample_ray(scene, smp, torch.as_tensor(pos),
                                     torch.zeros(n))
    r = float(scene.bsphere_radius) + 1.0
    np.testing.assert_allclose(ray.o.numpy(), np.asarray(jray.o),
                               atol=1e-6 * r)
    np.testing.assert_allclose(ray.d.numpy(), np.asarray(jray.d), atol=1e-6)
    # the cross-section weight 1/cos(-d, z) turns an ulp of d into ~5e-6
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_allclose(ray.time.numpy(), np.asarray(jray.time),
                               atol=1e-7)
    assert (np.asarray(jsmp.dim) == smp.dim).all(), (smp.dim, jsmp.dim)


SRFS = [{"type": "uniform", "lambda_min": 400.0, "lambda_max": 700.0},
        {"type": "regular", "lambda_min": 500.0, "lambda_max": 600.0,
         "values": [0.2, 1.0, 0.4]},
        {"type": "irregular", "wavelengths": [440.0, 550.0, 560.0, 610.0],
         "values": [0.0, 1.0, 0.7, 0.1]},
        {"type": "discrete", "wavelengths": [450.0, 550.0, 650.0],
         "values": [1.0, 2.0, 0.5]}]


@pytest.mark.parametrize("srf", SRFS, ids=[s["type"] for s in SRFS])
def test_build_srf_matches_reference(srf):
    """The srf's tables are stored (read by the spectral variant only) bit
    for bit as the reference builds them; the film is unchanged by them."""
    d = env_dict({"type": "distant", "direction": [0, 0, 1], "film": F1,
                  "srf": srf}, spp=4)
    _j, scene = both(d)
    assert "srf_integral" in scene.sensor
    plain = dict(d, sensor={k: v for k, v in d["sensor"].items()
                            if k != "srf"})
    assert torch.equal(integrators.render(scene, seed=2),
                       integrators.render(load_dict(plain, device="cpu"),
                                          seed=2))


def test_radiancemeter_in_a_medium():
    """A radiancemeter inside a homogeneous sphere: the sensor's medium
    reaches the config and volpath's lanes start in it (scan driver and
    lane pool), as in the reference."""
    d = {"type": "scene",
         "integrator": {"type": "volpath", "max_depth": 8},
         "fog": {"type": "homogeneous", "sigma_t": 0.8, "albedo": 0.6},
         "ball": {"type": "sphere", "radius": 2.0, "bsdf": {"type": "null"},
                  "interior": {"type": "ref", "id": "fog"}},
         "sensor": {"type": "radiancemeter",
                    "to_world": {"type": "look_at", "origin": [0, 0, 0.5],
                                 "target": [0.3, 0, 2], "up": [0, 1, 0]},
                    "medium": {"type": "ref", "id": "fog"}, "film": F1,
                    "sampler": {"type": "independent", "sample_count": 256}},
         "env": {"type": "constant", "radiance": 1.0}}
    jscene, scene = both(d)
    assert scene.config.sensor_medium == 0
    ref = np.asarray(jintegrators.render(jscene, seed=4))
    for regen in (False, True):
        img = integrators.render(scene, seed=4, regen=regen,
                                 samples_per_pass=64).numpy()
        np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-6)
    free = dict(d, sensor={k: v for k, v in d["sensor"].items()
                           if k != "medium"})
    img_free = integrators.render(load_dict(free, device="cpu"), seed=4)
    assert abs(float(img_free.mean()) - float(ref.mean())) > 0.01


def _sensor_rays(sensor, n, extra=None):
    d = env_dict(sensor, extra=extra)
    scene = load_dict(d, device="cpu")
    smp = Sampler.seed(0, torch.arange(n))
    pos = torch.as_tensor(np.random.default_rng(0).random((n, 2)),
                          dtype=torch.float32)
    ray, weight, _ = sensors.sample_ray(scene, smp, pos, torch.zeros(n))
    return scene, pos.numpy(), ray, weight.numpy()


def test_distant_single_ray_geometry():
    """tests/test_eradiate_oracles.py: rays travel along -direction from
    target - 2 R d with weight 1; flip_directions reverses them."""
    direction = np.asarray([0.3, -0.2, -0.93])
    direction /= np.linalg.norm(direction)
    target = [0.1, 0.2, 0.0]
    sphere = {"s": {"type": "sphere", "radius": 1.0}}
    sensor = {"type": "distant", "direction": list(direction),
              "target": target, "film": {**F1, "rfilter": BOX}}
    scene, _pos, ray, weight = _sensor_rays(sensor, 64, sphere)
    r = float(scene.bsphere_radius)
    assert np.allclose(ray.d.numpy(), -direction, atol=1e-6)
    assert np.allclose(ray.o.numpy(), np.asarray(target)
                       + direction * 2.0 * r, atol=1e-5)
    assert np.allclose(weight, 1.0)
    _s, _p, ray_f, _w = _sensor_rays(dict(sensor, flip_directions=True), 8,
                                     sphere)
    assert np.allclose(ray_f.d.numpy(), direction, atol=1e-6)


def test_distant_plane_arc_directions():
    _scene, pos, ray, _w = _sensor_rays(
        {"type": "distant", "film": {"width": 8, "height": 1,
                                     "rfilter": BOX}}, 256)
    ang = np.pi * pos[:, 0]
    expect = -np.stack([np.cos(ang), np.zeros_like(ang), np.sin(ang)], -1)
    assert np.allclose(ray.d.numpy(), expect, atol=1e-5)


def test_distant_hemisphere_directions_cover():
    _scene, _pos, ray, _w = _sensor_rays(
        {"type": "distant", "film": {"width": 4, "height": 4,
                                     "rfilter": BOX}}, 8192)
    dz = ray.d[:, 2].numpy()
    assert (dz <= 1e-6).all()
    assert abs(dz.mean() + 0.5) < 0.02
    assert abs(ray.d[:, 0].numpy().mean()) < 0.02


def test_distant_disk_target_origins():
    scene, _pos, ray, _w = _sensor_rays(
        {"type": "distant", "direction": [0.0, 0.0, 1.0],
         "film": {**F1, "rfilter": BOX}}, 8192,
        extra={"s": {"type": "sphere", "radius": 2.0,
                     "center": [1.0, 0.0, 0.0]}})
    r = float(scene.bsphere_radius)
    c = scene.bsphere_center.numpy()
    target = ray.o.numpy() + ray.d.numpy() * r
    assert np.allclose(target[:, 2], c[2], atol=1e-4)
    rad = np.linalg.norm(target[:, :2] - c[None, :2], axis=-1)
    assert (rad <= r * (1 + 1e-4)).all()
    assert abs(target[:, 0].mean() - c[0]) < r * 0.05
    assert abs((rad ** 2).mean() - r * r / 2) < r * r * 0.05
