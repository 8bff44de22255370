"""The port's measured BSDF (slice 5c-2) against the JAX package's, on the
same numpy inputs made from a seed: the tensor file (a round trip, and the
port reading a file the reference wrote), Marginal2D's ``eval``,
``sample`` and ``invert`` (with and without conditioning parameters), the
measured BSDF's ``eval_pdf`` and ``sample`` on 4,096 seeded directions,
and a 16x16 render of a measured ground on both drivers.

Budgets. The tables and the warps' index arithmetic are bit-equal (the
same float32 expressions, the same fixed-step binary search). The BSDF
chain composes three warps and divides by sin(theta_m) and by
2 pi^2 u sin(theta_m): torch's atan2, asin, sin and cos differ from XLA's
by 1-4 ulp, and near the specular direction (u -> 0) that ulp is amplified
by 1/u^3. So, as for slice 5c-1's BSDFs: at most 1 % of the lanes may miss
rtol 1e-5 (atol 1e-6), and those lanes must agree within rtol 5e-3; at
most 0.1 % may flip a decision (a CDF interval, a hemisphere) and differ
by more. ``sample`` runs two Marginal2D inversions more than ``eval``
(the luminance and VNDF warps' square roots, which XLA contracts into
multiply-adds): 3 % of its lanes may miss rtol 1e-5 (1.9 % do on this
seed, all within 4e-4). Marginal2D alone: 1 % may miss rtol 1e-5 and none
may flip. Films: tests/conftest.py::assert_driver_equivalent (1e-4
relative a pixel, 2 flipped pixels). Gradients with respect to the
measured ``spectra``: rtol 5e-3, atol 1e-7 against the reference's
jax.grad (tests/test_autodiff.py's replay-vs-scan figure)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import bsdfs as jbsdfs
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.core import marginal2d as jm2d
from eradiate_kernel_tpu.core.frame import Frame as JFrame
from eradiate_kernel_tpu.render.records import SurfaceInteraction as JSI
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu.utils import tensorfile as jtensorfile
from eradiate_kernel_tpu_torch import bsdfs, integrators
from eradiate_kernel_tpu_torch.core import marginal2d as m2d
from eradiate_kernel_tpu_torch.render.records import invalid_si
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff, tensorfile
from test_measured import synth_fields
from test_torch_scene import terrain_scene

N = 4096
RTOL, ATOL = 1e-5, 1e-6
LOOSE = 5e-3


def budget(a, b, what, rtol=RTOL, atol=ATOL, miss=0.01, flip=0.001):
    """a and b within rtol/atol on all but ``miss`` of the rows, which
    must agree within LOOSE but for ``flip`` of the rows."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    assert np.isfinite(a).all() and np.isfinite(b).all(), what
    tight = np.isclose(a, b, rtol=rtol, atol=atol).all(-1)
    loose = np.isclose(a, b, rtol=LOOSE, atol=atol).all(-1)
    assert (~tight).mean() <= miss, (what, (~tight).mean())
    assert (~loose).mean() <= flip, (what, (~loose).mean())


# --- the tensor file -------------------------------------------------------

def test_tensorfile_round_trip_and_reference_file(tmp_path):
    fields = synth_fields(T=3, L=2, res=5, seed=1)
    fields["extra"] = np.arange(6, dtype=np.int16).reshape(2, 3)
    port_path = tmp_path / "port.bsdf"
    ref_path = tmp_path / "ref.bsdf"
    tensorfile.write_tensor_file(port_path, fields)
    jtensorfile.write_tensor_file(ref_path, fields)
    assert port_path.read_bytes() == ref_path.read_bytes()
    for path in (port_path, ref_path):
        got = tensorfile.read_tensor_file(path)
        want = jtensorfile.read_tensor_file(path)
        assert set(got) == set(want) == set(fields)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    desc = tensorfile.read_tensor_file(ref_path)["description"]
    assert desc.tobytes().decode() == fields["description"]


# --- Marginal2D --------------------------------------------------------------

def tables(params):
    """A (3, 4, 9, 7) table with zero rows and columns (ties and
    zero-width intervals), its parameter grid and lane parameters."""
    rng = np.random.default_rng(4)
    data = rng.random((3, 4, 9, 7)).astype(np.float32) ** 3
    data[..., 2, :] = 0.0
    data[..., :, 3] = 0.0
    data[1] = 0.0
    data[1, :, 4, :] = 1.0
    if not params:
        data = data[0, 0]
    return m2d.build_continuous(data), jm2d.build_continuous(data)


@pytest.mark.parametrize("params", [False, True], ids=["plain", "params"])
def test_marginal2d_matches_reference(params):
    built, jbuilt = tables(params)
    for k in built:
        np.testing.assert_array_equal(built[k], jbuilt[k], err_msg=k)
    rng = np.random.default_rng(5)
    pv = (np.float32([0.0, 0.5, 2.0]), np.float32([-1.0, 0.0, 1.0, 3.0]))
    lanes = (rng.uniform(-0.5, 2.5, N).astype(np.float32),
             rng.uniform(-2.0, 4.0, N).astype(np.float32))
    u = rng.random((N, 2), dtype=np.float32)
    u[:64] = np.float32([0.5, 0.25])  # ties at CDF edges
    u[64:128] = 0.0
    tabs = {k: torch.as_tensor(v) for k, v in built.items()}
    jtabs = {k: jnp.asarray(v) for k, v in jbuilt.items()}
    args = ((tuple(torch.as_tensor(v) for v in pv),
             tuple(torch.as_tensor(v) for v in lanes)) if params else ())
    jargs = ((tuple(jnp.asarray(v) for v in pv),
              tuple(jnp.asarray(v) for v in lanes)) if params else ())
    act = torch.ones(N, dtype=torch.bool)
    jact = jnp.ones(N, bool)

    pos, pdf = m2d.sample(tabs, torch.as_tensor(u), *args, act)
    jpos, jpdf = jm2d.sample(jtabs, jnp.asarray(u), *jargs, jact)
    budget(pos, jpos, "sample pos", miss=0.01, flip=0.0)
    budget(pdf, jpdf, "sample pdf", miss=0.01, flip=0.0)
    assert (pdf.numpy() > 0).mean() > 0.9

    q = rng.random((N, 2), dtype=np.float32)
    val = m2d.eval(tabs, torch.as_tensor(q), *args, act)
    jval = jm2d.eval(jtabs, jnp.asarray(q), *jargs, jact)
    budget(val, jval, "eval", miss=0.0, flip=0.0)

    inv, ipdf = m2d.invert(tabs, torch.as_tensor(q), *args, act)
    jinv, jipdf = jm2d.invert(jtabs, jnp.asarray(q), *jargs, jact)
    budget(inv, jinv, "invert", miss=0.01, flip=0.0)
    budget(ipdf, jipdf, "invert pdf", miss=0.0, flip=0.0)
    # invert undoes sample
    back, _ = m2d.invert(tabs, pos, *args, act)
    ok = pdf.numpy() > 1e-3
    np.testing.assert_allclose(back.numpy()[ok],
                               np.clip(u, 1e-7, 1 - 1e-6)[ok], atol=2e-3)


# --- the measured BSDF -----------------------------------------------------

def measured_dict(fields, twosided=False):
    bsdf = {"type": "measured", "fields": fields}
    if twosided:
        bsdf = {"type": "twosided", "inner": bsdf}
    return {
        "type": "scene",
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 2, "height": 2}},
        "a": {"type": "rectangle", "bsdf": bsdf},
        "b": {"type": "rectangle", "bsdf": {
            "type": "measured", "fields": synth_fields(T=4, L=3, res=9,
                                                       seed=8)}},
    }


def directions(n, seed, upper=True):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    if upper:
        v[:, 2] = np.abs(v[:, 2]) + 0.05
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def interactions(wi):
    n = len(wi)
    si = invalid_si(n, 0, device="cpu")
    si = dataclasses.replace(si, wi=torch.as_tensor(wi),
                             t=torch.ones(n))
    z3 = jnp.zeros((n, 3))
    jsi = JSI(t=jnp.ones(n), p=z3, n=z3.at[:, 2].set(1.0),
              sh_frame=JFrame.from_normal(z3.at[:, 2].set(1.0)),
              uv=jnp.full((n, 2), 0.5), prim_uv=jnp.zeros((n, 2)),
              dp_du=z3.at[:, 0].set(1.0), dp_dv=z3.at[:, 1].set(1.0),
              wi=jnp.asarray(wi), wavelengths=jnp.zeros((n, 0)),
              time=jnp.zeros(n), prim_index=jnp.zeros(n, jnp.int32),
              shape_index=jnp.zeros(n, jnp.int32))
    return si, jsi


@pytest.fixture(scope="module")
def measured_scenes():
    d = measured_dict(synth_fields(T=6, L=16, res=32, seed=2),
                      twosided=True)
    return jload_dict(d), load_dict(d, device="cpu")


def test_measured_scene_arrays_match_reference(measured_scenes):
    jscene, scene = measured_scenes
    assert scene.config.bsdf_static == tuple(
        (k, tuple(v)) for k, v in jscene.config.bsdf_static)
    for k, v in scene.bsdfs["measured"].items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(jscene.bsdfs["measured"][k]), err_msg=k)


def test_measured_eval_pdf_and_sample_match_reference(measured_scenes):
    jscene, scene = measured_scenes
    wi = directions(N, 1, upper=False)  # back sides: the twosided frame
    wo = directions(N, 2, upper=False)
    rng = np.random.default_rng(3)
    s1 = rng.random(N, dtype=np.float32)
    s2 = rng.random((N, 2), dtype=np.float32)
    idx = (np.arange(N) % 2).astype(np.int32)  # both slots
    si, jsi = interactions(wi)
    act = torch.ones(N, dtype=torch.bool)
    jact = jnp.ones(N, bool)

    v, p = bsdfs.bsdf_eval_pdf(scene, torch.as_tensor(idx), si,
                               torch.as_tensor(wo), act)
    jv, jp = jbsdfs.bsdf_eval_pdf(jscene, jnp.asarray(idx), jsi,
                                  jnp.asarray(wo), jact)
    budget(v, jv, "eval")
    budget(p, jp, "pdf")
    assert (p.numpy() > 0).mean() > 0.2

    bs, w = bsdfs.bsdf_sample(scene, torch.as_tensor(idx), si,
                              torch.as_tensor(s1), torch.as_tensor(s2), act)
    jbs, jw = jbsdfs.bsdf_sample(jscene, jnp.asarray(idx), jsi,
                                 jnp.asarray(s1), jnp.asarray(s2), jact)
    budget(bs.wo, jbs.wo, "sample wo", miss=0.03)
    budget(bs.pdf, jbs.pdf, "sample pdf", miss=0.03)
    budget(w, jw, "sample weight", miss=0.03)
    np.testing.assert_array_equal(bs.sampled_type.numpy(),
                                  np.asarray(jbs.sampled_type))
    assert (bs.pdf.numpy() > 0).mean() > 0.4


# --- renders and gradients -------------------------------------------------

def measured_ground_dict(bsdf, spp=4):
    """terrain(17) under a measured BRDF (``bsdf``: its fields or its
    filename), lit by the sun."""
    d = terrain_scene(n=17, width=16, height=16, spp=spp, max_depth=3)
    d["terrain"]["bsdf"] = {"type": "measured", **bsdf}
    return d


def test_measured_ground_render_matches_reference(tmp_path):
    """The filename form (a tensor file the reference wrote) on both
    drivers."""
    fields = synth_fields(T=6, L=16, res=32, seed=4)
    path = tmp_path / "ground.bsdf"
    jtensorfile.write_tensor_file(path, fields)
    d = measured_ground_dict({"filename": str(path)})
    jscene = jload_dict(d)
    scene = load_dict(d, device="cpu")
    ref = np.asarray(jintegrators.render(jscene, seed=6))
    assert ref.mean() > 5e-4 and (ref.max(-1) > 0).mean() > 0.5
    assert_driver_equivalent(ref, integrators.render(scene, seed=6).numpy(),
                             max_flips=2)
    pool = integrators.render(scene, seed=6, regen=True,
                              samples_per_pass=200).numpy()
    assert_driver_equivalent(ref, pool, max_flips=2)


def test_measured_spectra_gradient_matches_reference():
    fields = synth_fields(T=4, L=4, res=12, seed=6)
    d = measured_ground_dict({"fields": fields}, spp=2)
    d["camera"]["film"].update(width=8, height=8)
    key = "bsdfs.measured.spectra"
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
