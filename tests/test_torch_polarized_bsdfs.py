"""The port's Mueller calculus, the Mueller entries of its BSDFs, its
polarized BSDF dispatch and its polarized phase functions against the JAX
package's, on the same numpy inputs made from a seed:

- (a) every function of core/mueller.py on seeded angles, cosines, IORs
  and directions: within rtol 1e-6, and atol 1e-6 of the array's largest
  entry (the products of O(1) matrices cancel: one entry of
  rotated_element's random 4x4 products sits 3.9e-6 relative from the
  reference's, 1.8e-7 absolute);
- (b) each kind's ``eval_mueller``, ``sample_mueller_weight`` or element
  ``mueller`` (conductor, dielectric, roughconductor, roughdielectric,
  pplastic, measured_polarized, polarizer, retarder, circular), and the
  dispatch ``bsdf_eval_mueller`` / ``bsdf_sample_mueller`` over a scene
  of every kind (null and diffuse among them: the identity and the
  depolarizer), on 1,024 seeded interactions with random shading frames
  and surface tangents: within rtol 1e-5 (atol 1e-6) but for 1 % of the
  rows, which must agree within 5e-3 (tests/test_torch_measured.py's
  ``budget``: torch's atan2, acos, sin and cos differ from XLA's by 1-4
  ulp, which a microfacet's D amplifies at grazing half vectors);
- (c) ``phase_mueller`` and ``phase_sample_mueller`` over a Rayleigh
  atmosphere and an hg / isotropic / blend mix, on 1,024 seeded direction
  pairs and draws, within (b)'s budget;
- (d) the pplastic tests of tests/test_bsdfs.py:190-262 and the
  measured_polarized tests of tests/test_measured.py:285-410 on the port,
  with their tolerances; where the reference runs a chi2 test (slice 7b
  ports utils/chi2.py), ``sample``'s outputs on 1,024 shared draws are
  held to the reference's within (b)'s budget instead.

The reference runs eagerly on small arrays, so the file takes ~20 s."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu import bsdfs as jbsdfs
from eradiate_kernel_tpu import phase as jphase
from eradiate_kernel_tpu.core import mueller as jmu
from eradiate_kernel_tpu.core.frame import Frame as JFrame
from eradiate_kernel_tpu.core.types import Variant as JVariant
from eradiate_kernel_tpu.render.records import SurfaceInteraction as JSI
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch import bsdfs, phase
from eradiate_kernel_tpu_torch.core import mueller as mu
from eradiate_kernel_tpu_torch.core.frame import Frame
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.render import fresnel as fr
from eradiate_kernel_tpu_torch.render.records import SurfaceInteraction
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere
from test_measured import synth_pbsdf
from test_torch_measured import budget
from test_torch_nee_modes import one_torch_thread  # noqa: F401 (fixture)

N = 1024
T = torch.as_tensor
J = jnp.asarray


def close(a, b, rtol=1e-6, atol=1e-7, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=what)


def unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


# ---- (a) core/mueller.py ------------------------------------------------------

def _mueller_case(name, rng):
    """(port result, reference result) of core/mueller.py's ``name`` on
    seeded inputs."""
    n = 256
    th = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    cos = rng.uniform(0.0, 1.0, n).astype(np.float32)
    val = rng.uniform(0.0, 2.0, n).astype(np.float32)
    m = rng.normal(size=(n, 4, 4)).astype(np.float32)
    d = unit(rng, n)
    b0 = np.cross(d, unit(rng, n))
    b0 /= np.linalg.norm(b0, axis=-1, keepdims=True)
    b1 = np.cross(d, unit(rng, n))
    b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
    if name == "depolarizer":
        return mu.depolarizer(T(val)), jmu.depolarizer(J(val))
    if name == "absorber":
        return mu.absorber(T(val)), jmu.absorber(J(val))
    if name == "linear_polarizer":
        return mu.linear_polarizer(T(val)), jmu.linear_polarizer(J(val))
    if name == "linear_retarder":
        return mu.linear_retarder(T(th)), jmu.linear_retarder(J(th))
    if name == "circular_polarizers":
        return (torch.stack([mu.right_circular_polarizer(),
                             mu.left_circular_polarizer()]),
                jnp.stack([jmu.right_circular_polarizer(),
                           jmu.left_circular_polarizer()]))
    if name == "rotator":
        return mu.rotator(T(th)), jmu.rotator(J(th))
    if name == "rotated_element":
        return (mu.rotated_element(T(th), T(m)),
                jmu.rotated_element(J(th), J(m)))
    if name == "specular_reflection dielectric":
        eta = rng.uniform(0.5, 2.5, n).astype(np.float32)
        return (mu.specular_reflection(T(cos), T(eta)),
                jmu.specular_reflection(J(cos), J(eta)))
    if name == "specular_reflection conductor":
        # a keepdim cosine against per-channel complex IORs
        er = rng.uniform(0.1, 3.0, (n, 3)).astype(np.float32)
        ei = rng.uniform(0.0, 5.0, (n, 3)).astype(np.float32)
        return (mu.specular_reflection(T(cos[:, None]), T(er), T(ei)),
                jmu.specular_reflection(J(cos[:, None]), J(er), J(ei)))
    if name == "specular_transmission":
        eta = rng.uniform(0.5, 2.5, n).astype(np.float32)
        return (mu.specular_transmission(T(cos), T(eta)),
                jmu.specular_transmission(J(cos), J(eta)))
    if name == "rayleigh_scatter":
        c = rng.uniform(-1.0, 1.0, n).astype(np.float32)
        return mu.rayleigh_scatter(T(c)), jmu.rayleigh_scatter(J(c))
    if name == "stokes_basis":
        return mu.stokes_basis(T(d)), jmu.stokes_basis(J(d))
    if name == "rotate_stokes_basis":
        return (mu.rotate_stokes_basis(T(d), T(b0), T(b1)),
                jmu.rotate_stokes_basis(J(d), J(b0), J(b1)))
    if name == "rotate_mueller_basis":
        d2 = unit(rng, n)
        c0 = np.cross(d2, unit(rng, n))
        c0 /= np.linalg.norm(c0, axis=-1, keepdims=True)
        args = (m, d, b0, b1, d2, c0, np.array(jmu.stokes_basis(J(d2))))
        return (mu.rotate_mueller_basis(*map(T, args)),
                jmu.rotate_mueller_basis(*map(J, args)))
    if name == "rotate_mueller_basis_collinear":
        args = (m, d, b0, b1)
        return (mu.rotate_mueller_basis_collinear(*map(T, args)),
                jmu.rotate_mueller_basis_collinear(*map(J, args)))
    if name == "to_world_mueller":
        nrm = unit(rng, n)
        fin, fout = unit(rng, n), unit(rng, n)
        mc = rng.normal(size=(n, 3, 4, 4)).astype(np.float32)
        out = []
        for mm in (m, mc):  # without and with a channel axis
            out.append((mu.to_world_mueller(Frame.from_normal(T(nrm)), T(mm),
                                            T(fin), T(fout)),
                        jmu.to_world_mueller(JFrame.from_normal(J(nrm)),
                                             J(mm), J(fin), J(fout))))
        return (torch.cat([out[0][0][:, None], out[1][0]], 1),
                jnp.concatenate([out[0][1][:, None], out[1][1]], 1))
    raise KeyError(name)


MUELLER_FUNCTIONS = [
    "depolarizer", "absorber", "linear_polarizer", "linear_retarder",
    "circular_polarizers", "rotator", "rotated_element",
    "specular_reflection dielectric", "specular_reflection conductor",
    "specular_transmission", "rayleigh_scatter", "stokes_basis",
    "rotate_stokes_basis", "rotate_mueller_basis",
    "rotate_mueller_basis_collinear", "to_world_mueller"]


@pytest.mark.parametrize("name", MUELLER_FUNCTIONS)
def test_mueller_function_matches_reference(name):
    got, want = _mueller_case(name, np.random.default_rng(
        MUELLER_FUNCTIONS.index(name)))
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    close(got, want, atol=1e-6 * float(np.abs(np.asarray(want)).max()),
          what=name)


def test_mueller_defaults_and_identities():
    """The reference's defaults (depolarizer(), linear_polarizer()) and
    the closed forms the calculus rests on: a rotator by theta and -theta
    is the identity, a half-wave retarder at 45 degrees swaps S1's sign,
    and a transmission and a reflection at normal incidence add to 1."""
    close(mu.depolarizer(), jmu.depolarizer())
    close(mu.linear_polarizer(), jmu.linear_polarizer())
    th = T(np.float32([0.3, -1.2]))
    close(mu.rotator(th) @ mu.rotator(-th), torch.eye(4).expand(2, 4, 4))
    hwp = mu.rotated_element(T(np.float32(np.pi / 4)),
                             mu.linear_retarder(T(np.float32(np.pi))))
    close(hwp @ T(np.float32([1, 1, 0, 0])), [1, -1, 0, 0])
    one = T(np.float32([1.0]))
    r = mu.specular_reflection(one, T(np.float32([1.5])))[0, 0, 0]
    t = mu.specular_transmission(one, T(np.float32([1.5])))[0, 0, 0]
    close(r + t, 1.0)


# ---- (b) the BSDFs' Mueller entries and the dispatch --------------------------

KINDS = {
    "conductor": {"type": "conductor", "material": "au"},
    "dielectric": {"type": "dielectric", "int_ior": 1.5},
    "roughconductor": {"type": "roughconductor", "material": "cu",
                       "alpha_u": 0.2, "alpha_v": 0.4},
    "roughdielectric": {"type": "roughdielectric", "alpha": 0.3,
                        "distribution": "beckmann", "int_ior": 1.5},
    "pplastic": {"type": "twosided", "bsdf": {
        "type": "pplastic", "alpha": 0.25,
        "diffuse_reflectance": [0.3, 0.4, 0.5]}},
    "measured_polarized": {"type": "measured_polarized",
                           "fields": synth_pbsdf(), "alpha_sample": 0.35},
    "polarizer": {"type": "polarizer", "theta": 30.0,
                  "transmittance": [0.9, 0.8, 0.7]},
    "retarder": {"type": "retarder", "theta": 15.0, "delta": 90.0},
    "circular": {"type": "circular", "left_handed": True},
    "null": {"type": "null"},
    "diffuse": {"type": "diffuse", "reflectance": 0.5},
}


def kinds_dict():
    """One rectangle of each kind under a sun."""
    d = {"type": "scene",
         "sensor": {"type": "perspective", "film": {"width": 2,
                                                    "height": 2}},
         "sun": {"type": "directional", "direction": [0, 0, -1]}}
    for i, (kind, bsdf) in enumerate(KINDS.items()):
        d[f"s_{kind}"] = {"type": "rectangle", "bsdf": bsdf, "to_world": {
            "type": "translate", "value": [0.0, 0.0, float(i)]}}
    return d


@pytest.fixture(scope="module")
def kind_scenes():
    d = kinds_dict()
    return jload_dict(d), load_dict(d, device="cpu")


def interactions(n, seed, wavelengths=None):
    """(port, reference) interactions on random shading frames with random
    surface tangents dp_du and incident directions in both hemispheres
    (a fifth of them straight along the normal)."""
    rng = np.random.default_rng(seed)
    nrm = unit(rng, n)
    wi = unit(rng, n)
    wi[: n // 5] = [0.0, 0.0, 1.0]
    dp_du = np.cross(nrm, unit(rng, n)).astype(np.float32)
    uv = rng.random((n, 2), dtype=np.float32)
    wl = np.zeros((n, 0), np.float32) if wavelengths is None else wavelengths
    z3 = np.zeros((n, 3), np.float32)
    common = dict(t=np.ones(n, np.float32), p=z3, n=nrm, uv=uv,
                  prim_uv=np.zeros((n, 2), np.float32), dp_du=dp_du,
                  dp_dv=z3, wi=wi, time=np.zeros(n, np.float32),
                  prim_index=np.zeros(n, np.int32),
                  shape_index=np.zeros(n, np.int32), wavelengths=wl)
    si = SurfaceInteraction(sh_frame=Frame.from_normal(T(nrm)),
                            **{k: T(v) for k, v in common.items()})
    jsi = JSI(sh_frame=JFrame.from_normal(J(nrm)),
              **{k: J(v) for k, v in common.items()})
    return si, jsi


def draws(n, seed):
    rng = np.random.default_rng(seed)
    return (unit(rng, n), rng.random(n, dtype=np.float32),
            rng.random((n, 2), dtype=np.float32))


def _slots(scene, kind):
    k = scene.config.bsdf_kinds.index(kind)
    idx = np.flatnonzero(scene.bsdf_kind.numpy() == k)
    return int(idx[0]), int(scene.bsdf_slot[idx[0]])


@pytest.mark.parametrize("kind", [k for k in KINDS
                                  if k not in ("null", "diffuse")])
def test_kind_mueller_matches_reference(kind_scenes, kind):
    jscene, scene = kind_scenes
    mod, jmod = bsdfs.REGISTRY[kind], jbsdfs.REGISTRY[kind]
    idx, slot = _slots(scene, kind)
    si, jsi = interactions(N, 1)
    wo, s1, s2 = draws(N, 2)
    act = torch.ones(N, dtype=torch.bool)
    jact = jnp.ones(N, bool)
    sl = torch.full((N,), slot, dtype=torch.int32)
    jsl = jnp.full((N,), slot, jnp.int32)
    params, jparams = scene.bsdfs[kind], jscene.bsdfs[kind]
    if kind in bsdfs.POLARIZED_ELEMENT_KINDS:
        got = mod.mueller(scene, params, sl, si, act)
        want = jmod.mueller(jscene, jparams, jsl, jsi, jact)
        got = torch.broadcast_to(got, (N, 4, 4))
    elif hasattr(mod, "eval_mueller"):
        got = mod.eval_mueller(scene, params, sl, si, T(wo), act)
        want = jmod.eval_mueller(jscene, jparams, jsl, jsi, J(wo), jact)
    else:  # the delta kinds: their weight at their own samples
        bs, w = mod.sample(scene, params, sl, si, T(s1), T(s2), act)
        jbs, jw = jmod.sample(jscene, jparams, jsl, jsi, J(s1), J(s2), jact)
        budget(bs.wo, jbs.wo, "wo")
        got = mod.sample_mueller_weight(scene, params, sl, si, bs, w, act)
        want = jmod.sample_mueller_weight(jscene, jparams, jsl, jsi, jbs,
                                          jw, jact)
    assert got.shape == want.shape, (got.shape, want.shape)
    budget(got, want, kind)
    assert (got.abs().amax((-1, -2)) > 0).float().mean() > 0.2
    if got.ndim == 4:  # polarizing kinds make some polarization
        assert got[..., 1:, 0].abs().max() > 1e-3


def test_dispatch_matches_reference(kind_scenes):
    """bsdf_eval_mueller and bsdf_sample_mueller over every kind's lanes;
    the world-basis matrices' M00 is the scalar eval and weight."""
    jscene, scene = kind_scenes
    n_bsdfs = scene.bsdf_kind.shape[0]
    idx = np.arange(N, dtype=np.int32) % n_bsdfs
    si, jsi = interactions(N, 3)
    wo, s1, s2 = draws(N, 4)
    act = torch.ones(N, dtype=torch.bool)
    jact = jnp.ones(N, bool)
    m, pdf = bsdfs.bsdf_eval_mueller(scene, T(idx), si, T(wo), act)
    jm, jpdf = jbsdfs.bsdf_eval_mueller(jscene, J(idx), jsi, J(wo), jact)
    budget(m, jm, "eval_mueller")
    budget(pdf, jpdf, "pdf")
    v, _ = bsdfs.bsdf_eval_pdf(scene, T(idx), si, T(wo), act)
    # M00 is the unpolarized eval: the basis rotations leave it alone and
    # the Fresnel matrices' M00 is the s/p average (pplastic's diffuse
    # lobe within 1.5e-5 relative, 3.4e-7 absolute, here)
    close(m[..., 0, 0], v, rtol=1e-4, atol=1e-6)

    bs, wm = bsdfs.bsdf_sample_mueller(scene, T(idx), si, T(s1), T(s2), act)
    jbs, jwm = jbsdfs.bsdf_sample_mueller(jscene, J(idx), jsi, J(s1),
                                          J(s2), jact)
    budget(bs.wo, jbs.wo, "sample wo")
    budget(bs.pdf, jbs.pdf, "sample pdf")
    budget(wm, jwm, "sample weight")
    np.testing.assert_array_equal(bs.sampled_type.numpy(),
                                  np.asarray(jbs.sampled_type))
    # null: the identity times the weight; diffuse: a depolarizer
    for kind, check in (("null", lambda w: w[..., 1:, 1:].diagonal(0, -2, -1)
                         == w[..., :1, :1].squeeze(-1)),
                        ("diffuse", lambda w: w[..., 1:, :] == 0)):
        lanes = idx == _slots(scene, kind)[0]
        assert check(wm[torch.as_tensor(lanes)]).all(), kind


# ---- (c) the polarized phase functions ----------------------------------------

def phase_scenes():
    """The Rayleigh atmosphere, and a medium mix of hg, isotropic and a
    blend of the two with a Rayleigh medium (every kind in one scene)."""
    d = atmosphere(4, 4, 2, 4)
    mix = {"type": "scene",
           "sensor": {"type": "perspective", "film": {"width": 2,
                                                      "height": 2}}}
    phases = [{"type": "hg", "g": 0.6}, {"type": "isotropic"},
              {"type": "blendphase", "weight": 0.3,
               "phase0": {"type": "hg", "g": -0.4},
               "phase1": {"type": "rayleigh"}}, {"type": "rayleigh"}]
    for i, ph in enumerate(phases):
        mix[f"m{i}"] = {"type": "homogeneous", "sigma_t": 1.0,
                        "albedo": 0.5, "phase": ph}
    return {"atmosphere": d, "mix": mix}


@pytest.mark.parametrize("case", ["atmosphere", "mix"])
def test_phase_mueller_matches_reference(case):
    d = phase_scenes()[case]
    jscene, scene = jload_dict(d), load_dict(d, device="cpu")
    n = N
    rng = np.random.default_rng(5)
    wi, wo = unit(rng, n), unit(rng, n)
    wo[:16] = -wi[:16]  # collinear: the degenerate scattering plane
    s1 = rng.random(n, dtype=np.float32)
    s2 = rng.random((n, 2), dtype=np.float32)
    idx = (np.arange(n) % scene.phase_kind.shape[0]).astype(np.int32)
    m = phase.phase_mueller(scene, T(idx), T(wi), T(wo))
    jm = jphase.phase_mueller(jscene, J(idx), J(wi), J(wo))
    budget(m, jm, "phase_mueller")
    close(m[..., 0, 0], phase.phase_eval(scene, T(idx), T(wi), T(wo)),
          rtol=1e-6)
    wo_s, pdf, w = phase.phase_sample_mueller(scene, T(idx), T(wi), T(s1),
                                              T(s2))
    jwo, jpdf, jw = jphase.phase_sample_mueller(jscene, J(idx), J(wi),
                                                J(s1), J(s2))
    budget(wo_s, jwo, "phase sample wo")
    budget(pdf, jpdf, "phase sample pdf")
    budget(w, jw, "phase sample weight")
    # Rayleigh polarizes: S1 of unpolarized light away from 0 and 180 deg
    assert w[..., 1, 0].abs().max() > 0.05


# ---- (d) pplastic and measured_polarized --------------------------------------

def surface_si(wi, wavelengths=None):
    """Interactions on the z-up frame with dp_du = +x (the reference
    tests' own)."""
    wi = np.asarray(wi, np.float32)
    wi = wi / np.linalg.norm(wi, axis=-1, keepdims=True)
    n = len(wi)
    ez = np.tile(np.float32([0, 0, 1]), (n, 1))
    wl = np.zeros((n, 0), np.float32) if wavelengths is None else \
        np.asarray(wavelengths, np.float32)
    return dataclasses.replace(interactions(n, 0)[0], n=T(ez),
                               sh_frame=Frame.from_normal(T(ez)),
                               dp_du=T(np.roll(ez, 1, -1)), wi=T(wi),
                               uv=torch.full((n, 2), 0.5), wavelengths=T(wl))


def one_bsdf(bsdf, variant="rgb"):
    return load_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "film": {"width": 2, "height": 2}},
        "rect": {"type": "rectangle", "bsdf": bsdf}}, Variant(variant),
        device="cpu")


def test_pplastic_eval_components():
    """tests/test_bsdfs.py:226: a diffuse-only pplastic is
    (1 - F_i)(1 - F_o) rho / pi cos_o (pplastic.cpp:319-329)."""
    scene = one_bsdf({"type": "pplastic", "alpha": 0.2,
                      "diffuse_reflectance": 0.6,
                      "specular_reflectance": 0.0})
    si = surface_si([[0.0, 0.6, 0.8]])
    wo = T(np.float32([[0.5, 0.0, np.sqrt(0.75)]]))
    val, _pdf = bsdfs.bsdf_eval_pdf(scene, torch.zeros(1, dtype=torch.int32),
                                    si, wo, torch.ones(1, dtype=torch.bool))
    eta = 1.49 / 1.000277
    f_i = float(fr.fresnel(si.wi[..., 2], eta)[0][0])
    f_o = float(fr.fresnel(wo[..., 2], eta)[0][0])
    expect = (1 - f_i) * (1 - f_o) * 0.6 / np.pi * float(wo[0, 2])
    close(val[0], np.full(3, expect), rtol=1e-4)


def test_pplastic_mueller_m00_matches_unpolarized():
    """tests/test_bsdfs.py:247: M00 of the pBRDF is the unpolarized eval."""
    scene = one_bsdf({"type": "pplastic", "alpha": 0.25,
                      "diffuse_reflectance": 0.3})
    si = surface_si([[0.2, -0.3, 0.93], [0.0, 0.0, 1.0]])
    wo = np.float32([[-0.4, 0.1, 0.91], [0.1, 0.2, 0.97]])
    wo = T(wo / np.linalg.norm(wo, axis=-1, keepdims=True))
    act = torch.ones(2, dtype=torch.bool)
    idx = torch.zeros(2, dtype=torch.int32)
    val, _ = bsdfs.bsdf_eval_pdf(scene, idx, si, wo, act)
    m = bsdfs.pplastic.eval_mueller(scene, scene.bsdfs["pplastic"], idx, si,
                                    wo, act)
    close(m[..., 0, 0], val, rtol=2e-3, atol=1e-6)


def _sample_vs_reference(bsdf, variant, wi, n=N, seed=6):
    """``sample`` (through the dispatch) and eval_pdf at its directions,
    port against reference, on shared draws at the incident direction
    ``wi``: the tests/test_bsdfs.py chi2 cases' inputs."""
    d = {"type": "scene",
         "sensor": {"type": "perspective", "film": {"width": 2,
                                                    "height": 2}},
         "rect": {"type": "rectangle", "bsdf": bsdf}}
    jscene = jload_dict(d, JVariant(variant))
    scene = load_dict(d, Variant(variant), device="cpu")
    rng = np.random.default_rng(seed)
    wl = (rng.uniform(360, 830, (n, 4)).astype(np.float32)
          if variant == "spectral" else None)
    si, jsi = interactions(n, seed, wl)
    w = np.tile(np.float32(wi) / np.linalg.norm(wi), (n, 1))
    ez = np.tile(np.float32([0, 0, 1]), (n, 1))
    si = dataclasses.replace(si, wi=T(w), sh_frame=Frame.from_normal(T(ez)))
    jsi = jsi.replace(wi=J(w), sh_frame=JFrame.from_normal(J(ez)))
    _, s1, s2 = draws(n, seed + 1)
    idx = torch.zeros(n, dtype=torch.int32)
    act = torch.ones(n, dtype=torch.bool)
    jact = jnp.ones(n, bool)
    bs, wt = bsdfs.bsdf_sample(scene, idx, si, T(s1), T(s2), act)
    jbs, jwt = jbsdfs.bsdf_sample(jscene, J(idx.numpy()), jsi, J(s1), J(s2),
                                  jact)
    budget(bs.wo, jbs.wo, "sample wo")
    budget(bs.pdf, jbs.pdf, "sample pdf")
    budget(wt, jwt, "sample weight")
    np.testing.assert_array_equal(bs.sampled_type.numpy(),
                                  np.asarray(jbs.sampled_type))
    assert (bs.pdf.numpy() > 0).mean() > 0.5
    # sample and eval_pdf agree: weight = value / pdf where pdf > 0
    v, p = bsdfs.bsdf_eval_pdf(scene, idx, si, bs.wo, act)
    ok = bs.pdf > 0
    close(p[ok], bs.pdf[ok], rtol=1e-5)
    close(wt[ok], (v / p[:, None])[ok], rtol=1e-4, atol=1e-6)
    m = bsdfs.bsdf_sample_mueller(scene, idx, si, T(s1), T(s2), act)[1]
    jm = jbsdfs.bsdf_sample_mueller(jscene, J(idx.numpy()), jsi, J(s1),
                                    J(s2), jact)[1]
    budget(m, jm, "sample_mueller weight")


@pytest.mark.parametrize("case", [
    ({"type": "pplastic", "alpha": 0.3, "diffuse_reflectance": 0.4},
     (0.3, -0.2, 0.9)),
    ({"type": "pplastic", "alpha": 0.12, "distribution": "ggx",
      "diffuse_reflectance": 0.05}, (0.3, -0.2, 0.9)),
], ids=["beckmann", "ggx smoothish"])
def test_pplastic_sample_matches_reference(case):
    """tests/test_bsdfs.py:193 and :198 (chi2 there)."""
    _sample_vs_reference(case[0], "rgb", case[1])


def mpol_scene(fields, **kw):
    return one_bsdf({"type": "measured_polarized", "fields": fields, **kw},
                    "spectral")


def test_measured_polarized_sample_matches_reference():
    """tests/test_measured.py:313 (chi2 there), in spectral at seeded
    wavelengths."""
    _sample_vs_reference({"type": "measured_polarized",
                          "fields": synth_pbsdf(), "alpha_sample": 0.35},
                         "spectral", (0.3, -0.1, 0.95))


def test_measured_polarized_eval_closed_form():
    """tests/test_measured.py:344: eval = M00(theta_h, lambda) cos_o of the
    separable synthetic data (measured_polarized.cpp:312)."""
    scene = mpol_scene(synth_pbsdf())
    si = surface_si(np.tile([0.0, 0.0, 1.0], (2, 1)), np.full((2, 4), 550.0))
    wo = np.float32([[0.0, 0.0, 1.0], [0.3, 0.0, 0.954]])
    wo = wo / np.linalg.norm(wo, axis=-1, keepdims=True)
    val, pdf = bsdfs.bsdf_eval_pdf(scene, torch.zeros(2, dtype=torch.int32),
                                   si, T(wo), torch.ones(2, dtype=torch.bool))
    th = 0.5 * np.arccos(np.clip((si.wi.numpy() * wo).sum(-1), -1, 1))
    expect = (0.2 + 0.5 * np.cos(th)) * (550.0 / 650.0) * wo[:, 2]
    close(val[:, 0], expect, rtol=2e-2)
    assert (pdf > 0).all()


def test_measured_polarized_mueller_m00_matches_eval():
    """tests/test_measured.py:363."""
    scene = mpol_scene(synth_pbsdf())
    si = surface_si(np.tile([0.2, -0.3, 0.93], (3, 1)), np.full((3, 4),
                                                                  550.0))
    rng = np.random.RandomState(4)
    wo = rng.uniform(-0.5, 0.5, (3, 3)).astype(np.float32)
    wo[:, 2] = rng.uniform(0.6, 1.0, 3)
    wo = T(wo / np.linalg.norm(wo, axis=-1, keepdims=True))
    act = torch.ones(3, dtype=torch.bool)
    idx = torch.zeros(3, dtype=torch.int32)
    val, _ = bsdfs.bsdf_eval_pdf(scene, idx, si, wo, act)
    m = bsdfs.measured_polarized.eval_mueller(
        scene, scene.bsdfs["measured_polarized"], idx, si, wo, act)
    close(m[..., 0, 0], val, rtol=1e-3, atol=1e-6)
    assert torch.isfinite(m).all()


def test_measured_polarized_nan_scrub():
    """tests/test_measured.py:382: NaN-encoded entries zero the whole
    matrix (measured_polarized.cpp:274-276); the port and the reference
    agree on it (the two directions alternate over N lanes)."""
    fields = synth_pbsdf(nan_slice=True)
    scene = mpol_scene(fields)
    jscene = jload_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "film": {"width": 2, "height": 2}},
        "rect": {"type": "rectangle", "bsdf": {
            "type": "measured_polarized", "fields": fields}}},
        JVariant("spectral"))
    si = surface_si(np.tile([0.0, 0.0, 1.0], (N, 1)), np.full((N, 4), 550.0))
    wo = np.tile(np.float32([[0.85, 0.0, 0.527], [0.05, 0.0, 0.9987]]),
                 (N // 2, 1))
    wo = wo / np.linalg.norm(wo, axis=-1, keepdims=True)
    act = torch.ones(N, dtype=torch.bool)
    idx = torch.zeros(N, dtype=torch.int32)
    val, _ = bsdfs.bsdf_eval_pdf(scene, idx, si, T(wo), act)
    m = bsdfs.measured_polarized.eval_mueller(
        scene, scene.bsdfs["measured_polarized"], idx, si, T(wo), act)
    assert torch.isfinite(val).all() and torch.isfinite(m).all()
    assert val[1, 0] > 0  # the near-normal lane is far from the NaN slice
    jsi = JSI(**{f.name: J(getattr(si, f.name).numpy())
                 for f in dataclasses.fields(si) if f.name != "sh_frame"},
              sh_frame=JFrame.from_normal(J(si.n.numpy())))
    jm = jbsdfs.measured_polarized.eval_mueller(
        jscene, jscene.bsdfs["measured_polarized"], J(idx.numpy()), jsi,
        J(wo), jnp.ones(N, bool))
    close(m, jm, rtol=1e-5, atol=1e-7)


def test_measured_polarized_fixed_wavelength():
    """tests/test_measured.py:406: wavelength=550 pins every channel to the
    550 nm band (measured_polarized.cpp:262-272)."""
    scene = mpol_scene(synth_pbsdf(), wavelength=550.0)
    si = surface_si([[0.1, 0.0, 0.995]], [[450.0, 500.0, 600.0, 650.0]])
    wo = np.float32([[0.0, 0.1, 0.995]])
    wo = T(wo / np.linalg.norm(wo, axis=-1, keepdims=True))
    val, _ = bsdfs.bsdf_eval_pdf(scene, torch.zeros(1, dtype=torch.int32),
                                 si, wo, torch.ones(1, dtype=torch.bool))
    close(val[0], val[0, 0].expand(4), rtol=1e-5)
    m = bsdfs.measured_polarized.eval_mueller(
        scene, scene.bsdfs["measured_polarized"],
        torch.zeros(1, dtype=torch.int32), si, wo,
        torch.ones(1, dtype=torch.bool))
    close(m[0], m[0, :1].expand(4, 4, 4), rtol=1e-5)
