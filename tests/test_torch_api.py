"""The port's public API held to the JAX package's, name for name:

- (a) every public module-level function, class and upper-case constant
  of every reference module, and every public method and dataclass field
  of a class both packages define, exists in the port's counterpart
  module under the same name;
- (b) every function and method both packages define takes the
  reference's parameters in the reference's order, with the reference's
  names and defaults; the port may add trailing parameters of its own
  that have defaults (``device``, ``dtype``, ``backend``, ``stats``),
  and may give a default to a parameter the reference requires (a call
  written for the reference binds the same there);
- one test for each signature fault the port had against the
  reference, each a call written for the reference.

The walk reads every ``.py`` file of the reference, the directories
without an ``__init__.py`` (render/, textures/, utils/) too, which
``pkgutil.walk_packages`` skips. A function or class counts for the
module that defines it; a constant for the module that assigns it.
``EXCEPTIONS`` lists what is deliberately not in the port, each with
its reason (ROADMAP.md, Queue 1)."""

import ast
import dataclasses
import importlib
import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REF, PORT = "eradiate_kernel_tpu", "eradiate_kernel_tpu_torch"
T = torch.as_tensor
J = jnp.asarray
ROOT = pathlib.Path(__file__).resolve().parents[1]

# what the port deliberately lacks: modules, then names
EXCEPTIONS = {
    # the port's ray/box slab test lives in media/__init__.py
    f"{REF}.core.bbox": "module",
    # the port gathers by torch indexing
    f"{REF}.core.gather": "module",
    # its Pallas kernels are the port's csrc/*.cu
    f"{REF}.ops.pallas_intersect": "module",
    # nothing imports it; the port's utils/autodiff.py has SGD and Adam
    f"{REF}.utils.optim": "module",
    # registers a dataclass as a JAX pytree
    f"{REF}.core.types.pytree_dataclass": "name",
    # picks jax.checkpoint for the bounce scan
    f"{REF}.integrators.common.remat_scan_body": "name",
    # pins a lax.scan carry's dtypes under x64
    f"{REF}.integrators.volpath.match_dtypes": "name",
    # JAX's PartitionSpec
    f"{REF}.parallel.P": "name",
    # autograd differentiates the port's early-exiting walk
    f"{REF}.integrators.volpath._run_walk_prb": "name",
    # bridges a JAX render into torch
    f"{REF}.utils.autodiff.render_torch": "name",
}


def reference_modules():
    """Dotted names of every module of the reference (namespace
    directories included), but __main__."""
    out = []
    for f in sorted((ROOT / REF).rglob("*.py")):
        parts = list(f.relative_to(ROOT).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts[-1] != "__main__":
            out.append(".".join(parts))
    return out


def public_names(mod):
    """{name: object} of the public functions and classes ``mod`` defines
    and the upper-case constants it assigns."""
    tree = ast.parse(inspect.getsource(mod))
    consts = set()
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        consts |= {t.id for t in targets if isinstance(t, ast.Name)
                   and t.id.isupper() and not t.id.startswith("_")}
    out = {}
    for name in dir(mod):
        obj = getattr(mod, name)
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        if name in consts or (callable(obj) and getattr(
                obj, "__module__", None) == mod.__name__):
            out[name] = obj
    return out


def members(cls):
    names = {k for k in dir(cls) if not k.startswith("_")}
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    return names


def port_of(name):
    return PORT + name[len(REF):]


def shared():
    """(reference name, reference object, port object) of every public
    function and method both packages define, and the names the port
    lacks."""
    missing, pairs = [], []
    for mname in reference_modules():
        if EXCEPTIONS.get(mname) == "module":
            continue
        ref = importlib.import_module(mname)
        try:
            port = importlib.import_module(port_of(mname))
        except ModuleNotFoundError:
            missing.append(mname)
            continue
        for name, obj in public_names(ref).items():
            full = f"{mname}.{name}"
            if full in EXCEPTIONS:
                continue
            if not hasattr(port, name):
                missing.append(full)
                continue
            pobj = getattr(port, name)
            if inspect.isclass(obj):
                for k in sorted(members(obj)):
                    if not (hasattr(pobj, k) or k in members(pobj)):
                        missing.append(f"{full}.{k}")
                    elif callable(getattr(obj, k, None)) and callable(
                            getattr(pobj, k, None)):
                        pairs.append((f"{full}.{k}", getattr(obj, k),
                                      getattr(pobj, k)))
            elif callable(obj) and callable(pobj):
                pairs.append((full, obj, pobj))
    return missing, pairs


@pytest.fixture(scope="module")
def api():
    return shared()


def test_every_public_name_is_in_the_port(api):
    missing, _ = api
    assert not missing, missing


def _default(d):
    """A default comparable across the packages: dtypes by name."""
    if d is inspect.Parameter.empty or isinstance(
            d, (int, float, str, bool, tuple, type(None))):
        return d
    s = str(d)
    for name in ("float32", "float64", "int32", "int64"):
        if name in s:
            return name
    return type(d).__name__


def signature_gaps(ref_fn, port_fn):
    """What differs between the two signatures, or None."""
    try:
        rs, ps = inspect.signature(ref_fn), inspect.signature(port_fn)
    except (TypeError, ValueError):
        return None
    rp, pp = list(rs.parameters.values()), list(ps.parameters.values())
    gaps = [(a.name, b.name) for a, b in zip(rp, pp) if a.name != b.name
            or (a.default is not inspect.Parameter.empty
                and _default(a.default) != _default(b.default))]
    if len(pp) < len(rp):
        gaps.append(("missing", [p.name for p in rp[len(pp):]]))
    gaps += [("no default", p.name) for p in pp[len(rp):]
             if p.default is inspect.Parameter.empty
             and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    return gaps and (str(rs), str(ps))


def test_every_shared_signature_matches_the_reference(api):
    _, pairs = api
    assert len(pairs) > 500
    bad = {name: gap for name, ref_fn, port_fn in pairs
           if (gap := signature_gaps(ref_fn, port_fn))}
    assert not bad, bad


def test_the_walk_sees_every_module_and_the_exceptions_are_live():
    """The file walk reaches the namespace directories (render/,
    textures/, utils/), and every listed exception names something the
    reference has."""
    mods = reference_modules()
    for m in ("render.texture", "textures.volumes", "utils.autodiff",
              "core.warp", "bsdfs.roughdielectric"):
        assert f"{REF}.{m}" in mods, m
    for full, kind in EXCEPTIONS.items():
        if kind == "module":
            assert full in mods, full
        else:
            mod, _, name = full.rpartition(".")
            assert hasattr(importlib.import_module(mod), name), full


# ---- the faults, each a call written for the reference ----------------------

def test_variant_fields_in_reference_order():
    from eradiate_kernel_tpu.core.types import Variant as JVariant
    from eradiate_kernel_tpu_torch.core.types import DEFAULT_VARIANT, Variant

    assert [f.name for f in dataclasses.fields(Variant)] == [
        f.name for f in dataclasses.fields(JVariant)]
    v = Variant("rgb", torch.float64)
    assert v.is_double and not v.polarized
    assert Variant("mono", torch.float32, True).polarized
    assert DEFAULT_VARIANT == Variant("rgb")


def test_pack_tiles_takes_the_reference_arguments():
    from eradiate_kernel_tpu.ops import accel as jaccel
    from eradiate_kernel_tpu_torch.ops import accel

    rng = np.random.default_rng(0)
    V = rng.random((60, 3), dtype=np.float32)
    F = rng.integers(0, 60, (150, 3)).astype(np.int32)
    shape = (np.arange(150) % 2).astype(np.int32)
    got = accel.pack_tiles(V, None, F, shape, 64)
    want = jaccel.pack_tiles(V, None, F, shape, 64)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dot_takes_keepdims():
    from eradiate_kernel_tpu.core import math as jm
    from eradiate_kernel_tpu_torch.core import math as m

    a = np.random.default_rng(1).random((5, 3), dtype=np.float32)
    got = m.dot(torch.as_tensor(a), torch.as_tensor(a), keepdims=True)
    want = jm.dot(jnp.asarray(a), jnp.asarray(a), keepdims=True)
    assert got.shape == want.shape == (5, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_zero_bsdf_sample_takes_the_reference_batch():
    from eradiate_kernel_tpu.bsdfs.common import zero_bsdf_sample as jzero
    from eradiate_kernel_tpu_torch.bsdfs.common import zero_bsdf_sample

    for batch in ((4,), (2, 3)):
        bs, w = zero_bsdf_sample(batch, 3, device="cpu")
        jbs, jw = jzero(batch, 3)
        assert w.shape == jw.shape
        for k in ("wo", "pdf", "eta", "sampled_type"):
            np.testing.assert_array_equal(getattr(bs, k).numpy(),
                                          np.asarray(getattr(jbs, k)), k)
    assert zero_bsdf_sample(4, 1, "cpu")[0].wo.shape == (4, 3)
    if not torch.cuda.is_available():
        # the device resolves as the entry points resolve it: CUDA
        with pytest.raises(RuntimeError, match="device='cpu'"):
            zero_bsdf_sample((4,), 3)


def test_finalize_takes_the_reference_arguments():
    from eradiate_kernel_tpu_torch.scene.build import SceneBuilder
    from eradiate_kernel_tpu_torch.core.types import Variant

    b = SceneBuilder(Variant("rgb"))
    assert b.sensor_static == ()
    assert list(inspect.signature(b.finalize).parameters) == [
        "sensor_kind", "sensor_params", "film_cfg", "integrator_cfg", "spp"]
    assert b.add_texture_row("constant", {"spec": np.int32(0)}) == 0


# ---- the faults and single names that need a scene --------------------------

@pytest.fixture(scope="module")
def sky_atmosphere():
    """The 4^3 Rayleigh atmosphere over its RPV ground, under a constant
    sky beside its sun, in both packages."""
    from eradiate_kernel_tpu.scene import load_dict as jload_dict
    from eradiate_kernel_tpu.utils.scenes import atmosphere as jatmosphere
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    out = []
    for load, make, dev in ((jload_dict, jatmosphere, {}),
                            (load_dict, atmosphere, {"device": "cpu"})):
        d = make(4, 4, 2, 4, grid_res=4)
        d["sky"] = {"type": "constant", "radiance": [0.2, 0.3, 0.4]}
        out.append(load(d, **dev))
    return out


def _rays(n, seed):
    """Seeded rays from above the 4^3 atmosphere, mostly downwards."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(0.1, 0.9, (n, 2)),
                        np.full((n, 1), 1.5)], -1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_constant_eval_takes_uv_before_wavelengths(sky_atmosphere):
    from eradiate_kernel_tpu import emitters as jemitters
    from eradiate_kernel_tpu_torch import emitters

    jscene, scene = sky_atmosphere
    n = 16
    slot = scene.emitter_slot[scene.config.env_emitter].expand(n)
    uv = np.random.default_rng(2).random((n, 2), dtype=np.float32)
    got = emitters.constant_eval(
        scene, scene.emitters["constant"], slot, T(uv),
        torch.zeros(n, 0), torch.ones(n, dtype=torch.bool))
    want = jemitters.constant_eval(
        jscene, jscene.emitters["constant"], J(np.asarray(slot)), J(uv),
        jnp.zeros((n, 0)), jnp.ones(n, bool))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), np.tile([0.2, 0.3, 0.4],
                                                    (n, 1)), rtol=1e-6)
    # the kinds' wavelengths by the reference's keyword
    ds, v = emitters.constant_sample_direction(
        scene, scene.emitters["constant"], slot, torch.zeros(n, 3),
        wavelengths=torch.zeros(n, 0), s1=T(uv[:, 0]), s2=T(uv),
        active=torch.ones(n, dtype=torch.bool))
    assert v.shape == (n, 3)


def test_combined_extinction_takes_p_before_wavelengths(sky_atmosphere):
    from eradiate_kernel_tpu import media as jmedia
    from eradiate_kernel_tpu_torch import media

    jscene, scene = sky_atmosphere
    n = 8
    p = np.random.default_rng(3).random((n, 3), dtype=np.float32)
    got = media.medium_combined_extinction(
        scene, torch.zeros(n, dtype=torch.int32), T(p), torch.zeros(n, 0))
    want = jmedia.medium_combined_extinction(
        jscene, jnp.zeros(n, jnp.int32), J(p), jnp.zeros((n, 0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("mode", [None, "profile", "segment"])
def test_sample_interaction_takes_the_majorant_mode(sky_atmosphere, mode):
    """``mode`` overrides the integrator's ff_majorant (profile by
    default): the free-flight distances match the reference's within
    rtol 1e-5 (atol 1e-6), and segment flights differ from profile
    ones."""
    from eradiate_kernel_tpu import media as jmedia
    from eradiate_kernel_tpu.core.ray import Ray as JRay
    from eradiate_kernel_tpu_torch import media
    from eradiate_kernel_tpu_torch.core.ray import Ray

    jscene, scene = sky_atmosphere
    n = 512
    o, d = _rays(n, 4)
    u = np.random.default_rng(5).random(n, dtype=np.float32)
    idx = torch.zeros(n, dtype=torch.int32)
    act = torch.ones(n, dtype=torch.bool)

    def port(m):
        return media.sample_interaction(
            scene, idx, Ray.make(T(o), T(d)), T(u), idx, act, m)

    got = port(mode)
    want = jmedia.sample_interaction(
        jscene, jnp.zeros(n, jnp.int32), JRay.make(J(o), J(d)), J(u),
        jnp.zeros(n, jnp.int32), jnp.ones(n, bool), mode)
    for f in ("t", "mint", "maxt", "combined_extinction"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    if mode == "segment":
        assert not torch.equal(got.t, port("profile").t)
    else:
        assert torch.equal(got.t, port("profile").t)


def test_eval_rpv_takes_active(sky_atmosphere):
    from eradiate_kernel_tpu.bsdfs import rpv as jrpv
    from eradiate_kernel_tpu_torch.bsdfs import rpv
    from test_torch_polarized_bsdfs import interactions, unit

    jscene, scene = sky_atmosphere
    n = 256
    si, jsi = interactions(n, 6)
    rng = np.random.default_rng(7)
    wi, wo = np.abs(unit(rng, n)), np.abs(unit(rng, n))
    act = rng.random(n) < 0.5
    got = rpv.eval_rpv(scene, scene.bsdfs["rpv"], torch.zeros(
        n, dtype=torch.int32), si, T(wi), T(wo), T(act))
    want = jrpv.eval_rpv(jscene, jscene.bsdfs["rpv"], jnp.zeros(
        n, jnp.int32), jsi, J(wi), J(wo), J(act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_sample_emitter_ray_defaults_to_every_lane(sky_atmosphere):
    from eradiate_kernel_tpu import emitters as jemitters
    from eradiate_kernel_tpu.core.rng import Sampler as JSampler
    from eradiate_kernel_tpu_torch import emitters
    from eradiate_kernel_tpu_torch.core.rng import Sampler

    jscene, scene = sky_atmosphere
    n = 256
    lane = np.arange(n)
    want = jemitters.sample_emitter_ray(
        jscene, JSampler.seed(1, J(lane.astype(np.uint32))), jnp.zeros(n))
    for active in ({}, {"active": True}):
        ray, w, idx, _ = emitters.sample_emitter_ray(
            scene, Sampler.seed(1, T(lane)), torch.zeros(n), **active)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(w.numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ray.o.numpy(), np.asarray(want[0].o),
                                   rtol=1e-5, atol=1e-5)


def test_media_and_volume_helpers_match_reference(sky_atmosphere):
    """medium_is_homogeneous, volume_max and volume_eval_gradient (within
    rtol 1e-5, atol 1e-5 of the largest |gradient|: the trilinear
    interpolant's derivative cancels corner differences)."""
    from eradiate_kernel_tpu import media as jmedia
    from eradiate_kernel_tpu.textures import volumes as jvolumes
    from eradiate_kernel_tpu_torch import media
    from eradiate_kernel_tpu_torch.textures import volumes

    jscene, scene = sky_atmosphere
    n = 256
    idx = torch.zeros(n, dtype=torch.int32)
    assert not media.medium_is_homogeneous(scene, idx).any()
    np.testing.assert_array_equal(
        media.medium_is_homogeneous(scene, idx).numpy(),
        np.asarray(jmedia.medium_is_homogeneous(jscene, jnp.zeros(
            n, jnp.int32))))
    vidx = torch.arange(scene.vol_kind.shape[0], dtype=torch.int32)
    np.testing.assert_allclose(
        volumes.volume_max(scene, vidx).numpy(),
        np.asarray(jvolumes.volume_max(jscene, J(vidx.numpy()))),
        rtol=1e-6)
    p = np.random.default_rng(8).uniform(-0.1, 1.1, (n, 3)).astype(
        np.float32)
    vi = np.zeros(n, np.int32)
    got = volumes.volume_eval_gradient(scene, T(vi), T(p), torch.zeros(n, 0))
    want = np.asarray(jvolumes.volume_eval_gradient(jscene, J(vi), J(p),
                                                    jnp.zeros((n, 0))))
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_null_transmission_dispatch_matches_reference():
    """The null kind's own eval_null_transmission: a null lane of the
    dispatch transmits 1, a diffuse one 0."""
    from eradiate_kernel_tpu import bsdfs as jbsdfs
    from eradiate_kernel_tpu.scene import load_dict as jload_dict
    from eradiate_kernel_tpu_torch import bsdfs
    from eradiate_kernel_tpu_torch.scene import load_dict
    from test_torch_polarized_bsdfs import interactions

    d = {"type": "scene",
         "sensor": {"type": "perspective", "film": {"width": 2,
                                                    "height": 2}},
         "a": {"type": "rectangle", "bsdf": {"type": "null"}},
         "b": {"type": "rectangle", "bsdf": {"type": "diffuse"}}}
    jscene, scene = jload_dict(d), load_dict(d, device="cpu")
    n = 64
    idx = np.arange(n, dtype=np.int32) % scene.bsdf_kind.shape[0]
    si, jsi = interactions(n, 9)
    got = bsdfs.eval_null_transmission(scene, T(idx), si,
                                       torch.ones(n, dtype=torch.bool))
    want = jbsdfs.eval_null_transmission(jscene, J(idx), jsi,
                                         jnp.ones(n, bool))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0
    np.testing.assert_array_equal(
        bsdfs.bsdf_flags(scene, T(idx)).numpy(),
        np.asarray(jbsdfs.bsdf_flags(jscene, J(idx))))


@pytest.mark.parametrize("integrator", ["path", "volpath"])
def test_sample_counted_matches_reference(integrator):
    """sample() and its ray count on 256 seeded rays into a 4x4 Cornell
    box: the radiance within rtol 1e-5 (atol 1e-6), the count exactly."""
    from eradiate_kernel_tpu.core.ray import Ray as JRay
    from eradiate_kernel_tpu.core.rng import Sampler as JSampler
    from eradiate_kernel_tpu.scene import load_dict as jload_dict
    from eradiate_kernel_tpu.utils.scenes import cornell_box as jcornell
    from eradiate_kernel_tpu_torch.core.ray import Ray
    from eradiate_kernel_tpu_torch.core.rng import Sampler
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import cornell_box

    mod = importlib.import_module(
        f"eradiate_kernel_tpu_torch.integrators.{integrator}")
    jmod = importlib.import_module(
        f"eradiate_kernel_tpu.integrators.{integrator}")
    jscene = jload_dict(jcornell(4, 4, 1, 3))
    scene = load_dict(cornell_box(4, 4, 1, 3), device="cpu")
    n = 256
    rng = np.random.default_rng(0)
    o = (np.float32([0, 0, -3.0]) + rng.normal(0, 0.01, (n, 3))).astype(
        np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = mod.sample_counted(scene, Sampler.seed(3, torch.arange(n)),
                             Ray.make(T(o), T(d)))
    want = jmod.sample_counted(
        jscene, JSampler.seed(3, jnp.arange(n, dtype=jnp.uint32)),
        JRay.make(J(o), J(d)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    assert int(got[3]) == int(want[3]) > n
    same = mod.sample(scene, Sampler.seed(3, torch.arange(n)),
                      Ray.make(T(o), T(d)))
    assert torch.equal(same[0], got[0])


def test_records_transforms_and_rays_match_reference():
    """Transform.perspective, transform_point, transform_unit_vector and
    transform_ray, Ray.with_bounds, spawn_ray, invalid_si, .replace,
    empty_geometry and the single names against the reference (float32
    within rtol 1e-6, atol 1e-6)."""
    from eradiate_kernel_tpu.core import ray as jray
    from eradiate_kernel_tpu.core.transform import Transform as JTransform
    from eradiate_kernel_tpu.render import geometry as jgeometry
    from eradiate_kernel_tpu.render import records as jrecords
    from eradiate_kernel_tpu_torch import emitters
    from eradiate_kernel_tpu_torch.core import ray
    from eradiate_kernel_tpu_torch.core.transform import Transform
    from eradiate_kernel_tpu_torch.integrators import common
    from eradiate_kernel_tpu_torch.render import geometry, records

    rng = np.random.default_rng(10)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    for t, jt in ((Transform.perspective(40.0, 0.1, 100.0),
                   JTransform.perspective(40.0, 0.1, 100.0)),
                  (Transform.look_at([1, 2, 3], [0, 0, 0], [0, 0, 1]),
                   JTransform.look_at([1, 2, 3], [0, 0, 0], [0, 0, 1]))):
        np.testing.assert_array_equal(t.m, np.asarray(jt.m))
        tt = Transform(m=T(t.m), inv_t=T(t.inv_t))
        jtt = JTransform(m=J(jt.m), inv_t=J(jt.inv_t))
        for got, want in ((tt.transform_point(T(p)),
                           jtt.transform_point(J(p))),
                          (tt.transform_unit_vector(T(v)),
                           jtt.transform_unit_vector(J(v))),
                          (torch.cat(tt.transform_ray(T(p), T(v)), -1),
                           jnp.concatenate(jtt.transform_ray(J(p), J(v)),
                                           -1))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
        assert tt.replace(m=tt.inv_t).m is tt.inv_t
    r = ray.Ray.make(T(p), T(v)).with_bounds(mint=0.5, maxt=T(
        np.float32(7.0)))
    assert r.mint.tolist() == [0.5] * 64 and r.maxt.tolist() == [7.0] * 64
    n = p / np.linalg.norm(p, axis=-1, keepdims=True)
    got = ray.spawn_ray(T(p), T(n), T(v), torch.zeros(64, 0),
                        torch.zeros(64))
    want = jray.spawn_ray(J(p), J(n), J(v), jnp.zeros((64, 0)),
                          jnp.zeros(64))
    for f in ("o", "d", "mint", "maxt"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   err_msg=f)
    si = records.invalid_si((5,), 4, device="cpu")
    jsi = jrecords.invalid_si((5,), 4)
    for f in ("t", "n", "wi", "wavelengths", "shape_index"):
        np.testing.assert_array_equal(getattr(si, f).numpy(),
                                      np.asarray(getattr(jsi, f)), f)
    spawned = si.replace(p=T(p[:5]), n=T(n[:5])).spawn_ray(T(v[:5]),
                                                          T([3.0] * 5))
    assert spawned.maxt.tolist() == [3.0] * 5
    geo = geometry.empty_geometry(3, device="cpu")
    jgeo = jgeometry.empty_geometry(3)
    assert geo.n_shapes == jgeo.n_shapes == 3 and not geo.has_tiles
    assert (emitters.DELTA_POSITION, emitters.DELTA_DIRECTION,
            emitters.INFINITE, emitters.SURFACE) == (1, 2, 4, 8)
    # the package's ``bins`` is the wrapper; the module has make
    bins = importlib.import_module(f"{PORT}.integrators.bins")
    assert bins.make(True).narrow and not bins.make(False).narrow
    from eradiate_kernel_tpu_torch.core.types import Variant

    class _Cfg:
        variant = Variant("spectral")

    scene = type("S", (), {"config": _Cfg})()
    assert common.spec_channels(scene, torch.zeros(2, 4)) == 4


def test_optimizer_checkpoints_load_across_packages(tmp_path):
    """An Adam checkpoint saved by either package loads in the other with
    the same parameters, moments and step."""
    from eradiate_kernel_tpu.utils import autodiff as jad
    from eradiate_kernel_tpu_torch.utils import autodiff

    x = np.float32([0.5, -1.0, 2.0])
    g = np.float32([0.1, 0.2, -0.3])
    opt = autodiff.Adam({"x": x}, lr=0.1)
    opt.step({"x": T(g)})
    opt.save(tmp_path / "port.npz")
    jopt = jad.Adam({"x": J(x)}, lr=0.1)
    jopt.load(str(tmp_path / "port.npz"))
    assert jopt.t == 1
    np.testing.assert_array_equal(np.asarray(jopt.params["x"]),
                                  opt.params["x"].detach().numpy())
    jopt.step({"x": J(g)})
    jopt.save(str(tmp_path / "ref.npz"))
    back = autodiff.Adam({"x": x}, lr=0.1)
    back.load(tmp_path / "ref.npz")
    assert back.t == 2
    for a, b in zip(back.state["x"], jopt.state["x"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
