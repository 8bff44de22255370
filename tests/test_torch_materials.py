"""Slice 5c-1's material functions in the port against the JAX package on
the same numpy inputs made from a seed, 4,096 lanes each, at rtol 1e-5
and atol 1e-6: the Fresnel terms and specular directions, every
microfacet function for both distributions (isotropic and anisotropic),
and each of the 11 BSDFs' sample (wo, pdf, eta, sampled_type, weight)
and eval_pdf (value, pdf), the wrappers through the nested dispatch, and
the eval_null_transmission dispatch. The reference runs eagerly (no
jit).

Two budgets, stated per call of assert_lanes:
- rounding: torch's and XLA's sin, cos, erf, exp and pow differ by 1-4
  ulp on the CPU, and some lanes amplify that past 1e-5: a microfacet
  density at alpha 0.02 moves by 1 / alpha^2 times its normal's error,
  and Beckmann's Newton inversion of the visible-slope CDF near grazing
  incidence by more. At most ROUNDING_BUDGET = 41 lanes (1 %) may miss
  rtol 1e-5 / atol 1e-6 if they hold rtol 5e-3 / atol 1e-5.
- flips: a lane within float32 rounding of a decision edge (the lobe
  choice s1 <= F, the TIR edge, a sidedness test at 0) may take the
  other branch in one package. At most FLIP_BUDGET = 4 lanes (0.1 %)
  may miss the looser tolerance too; they stay finite."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu import bsdfs as jbsdfs
from eradiate_kernel_tpu.core.frame import Frame as JFrame
from eradiate_kernel_tpu.core.types import Variant as JVariant
from eradiate_kernel_tpu.render import fresnel as jfr
from eradiate_kernel_tpu.render import microfacet as jmf
from eradiate_kernel_tpu.render.records import SurfaceInteraction as JSI
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch import bsdfs, integrators
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.render import fresnel as fr
from eradiate_kernel_tpu_torch.render import microfacet as mf
from eradiate_kernel_tpu_torch.render.records import invalid_si
from eradiate_kernel_tpu_torch.scene import load_dict
from test_torch_sensors import one_torch_thread  # noqa: F401

N = 4096
RTOL, ATOL = 1e-5, 1e-6
LOOSE_RTOL, LOOSE_ATOL = 5e-3, 1e-5
ROUNDING_BUDGET = 41
FLIP_BUDGET = 4


def unit(rng, n, upper=None):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    if upper is True:
        v[:, 2] = np.abs(v[:, 2])
    return v.astype(np.float32)


def close_lanes(a, b, rtol=RTOL, atol=ATOL):
    """Per lane: all values of a and b (N, ...) agree."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    ok = np.abs(a - b) <= atol + rtol * np.abs(b)
    ok |= (a == b)  # infinities
    return ok.all(axis=1)


def assert_lanes(pairs, what, rounding=ROUNDING_BUDGET, flips=FLIP_BUDGET):
    """``pairs``: [(port, reference), ...] over the same lanes, held to the
    module's budgets: at most ``rounding`` lanes beyond RTOL / ATOL and
    within the loose tolerance, at most ``flips`` beyond it; all finite."""
    tight = np.ones(N, bool)
    loose = np.ones(N, bool)
    for a, b in pairs:
        tight &= close_lanes(a, b)
        loose &= close_lanes(a, b, LOOSE_RTOL, LOOSE_ATOL)
    n_flips = int((~loose).sum())
    n_rounding = int((loose & ~tight).sum())
    assert n_flips <= flips and n_rounding <= rounding, (
        f"{what}: {n_rounding} lanes beyond rtol {RTOL} (budget "
        f"{rounding}), {n_flips} beyond rtol {LOOSE_RTOL} (budget {flips}); "
        f"first {np.flatnonzero(~tight)[:5]}")
    for a, _b in pairs:
        assert np.isfinite(np.asarray(a, np.float64)).all(), what


def t(x):
    return torch.as_tensor(np.array(x))


def j(x):
    return jnp.asarray(np.asarray(x))


# --- Fresnel ----------------------------------------------------------------

def test_fresnel_matches_reference():
    rng = np.random.default_rng(0)
    cos_i = rng.uniform(-1, 1, N).astype(np.float32)
    cos_i[:8] = [0.0, 1.0, -1.0, 0.2, -0.2, 1e-7, -0.9, 0.5]
    eta = rng.uniform(0.4, 2.6, N).astype(np.float32)
    eta[8:12] = 1.0
    got = fr.fresnel(t(cos_i), t(eta))
    ref = jfr.fresnel(j(cos_i), j(eta))
    assert_lanes(list(zip([g.numpy() for g in got], ref)), "fresnel")

    eta_r = rng.uniform(0.05, 3.0, (N, 3)).astype(np.float32)
    eta_i = rng.uniform(0.0, 6.0, (N, 3)).astype(np.float32)
    assert_lanes([(fr.fresnel_conductor(t(cos_i), t(eta_r), t(eta_i)),
                   jfr.fresnel_conductor(j(cos_i), j(eta_r), j(eta_i)))],
                 "fresnel_conductor")
    for e in (1.0 / 1.49, 1.0 / 1.5046, 1.33, 0.5, 2.4):
        assert np.float32(fr.fresnel_diffuse_reflectance(e)) == \
            np.float32(jfr.fresnel_diffuse_reflectance(e))


def test_specular_directions_match_reference():
    rng = np.random.default_rng(1)
    wi, m = unit(rng, N), unit(rng, N, upper=True)
    eta = rng.uniform(0.5, 2.0, N).astype(np.float32)
    _r, cos_t, _eit, eta_ti = jfr.fresnel(j(np.sum(wi * m, -1)), j(eta))
    _r0, cos_t0, _e0, eta_ti0 = jfr.fresnel(j(wi[:, 2]), j(eta))
    assert_lanes([(fr.reflect(t(wi)), jfr.reflect(j(wi))),
                  (fr.reflect_m(t(wi), t(m)), jfr.reflect_m(j(wi), j(m))),
                  (fr.refract(t(wi), t(cos_t0), t(eta_ti0)),
                   jfr.refract(j(wi), cos_t0, eta_ti0)),
                  (fr.refract_m(t(wi), t(m), t(cos_t), t(eta_ti)),
                   jfr.refract_m(j(wi), j(m), cos_t, eta_ti))],
                 "reflect / refract")
    assert fr.IOR_DATABASE == jfr.IOR_DATABASE
    assert fr.CONDUCTOR_PRESETS == jfr.CONDUCTOR_PRESETS
    assert fr.lookup_ior("BK7") == jfr.lookup_ior("BK7")


# --- microfacet --------------------------------------------------------------

@pytest.mark.parametrize("name", ["ggx", "beckmann"])
@pytest.mark.parametrize("alpha", [(0.3, 0.3), (0.1, 0.4), (0.02, 0.02)])
def test_microfacet_matches_reference(name, alpha):
    rng = np.random.default_rng(2)
    ty = mf.distr_type(name)
    assert ty == jmf.distr_type(name)
    au = np.full(N, alpha[0], np.float32)
    av = np.full(N, alpha[1], np.float32)
    wi, wo = unit(rng, N), unit(rng, N)
    m = unit(rng, N)
    s2 = rng.random((N, 2), dtype=np.float32)
    got_m, got_pdf = mf.sample(ty, t(wi), t(au), t(av), t(s2))
    ref_m, ref_pdf = jmf.sample(ty, j(wi), j(au), j(av), j(s2))
    assert_lanes([(mf.eval_d(ty, t(m), t(au), t(av)),
                   jmf.eval_d(ty, j(m), j(au), j(av)))], "eval_d")
    assert_lanes([(mf.smith_g1(ty, t(wi), t(m), t(au), t(av)),
                   jmf.smith_g1(ty, j(wi), j(m), j(au), j(av)))], "smith_g1")
    assert_lanes([(mf.g_smith(ty, t(wi), t(wo), t(m), t(au), t(av)),
                   jmf.g_smith(ty, j(wi), j(wo), j(m), j(au), j(av)))],
                 "g_smith")
    assert_lanes([(got_m, ref_m), (got_pdf, ref_pdf)], f"sample {name}")
    assert_lanes([(mf.pdf(ty, t(wi), t(m), t(au), t(av)),
                   jmf.pdf(ty, j(wi), j(m), j(au), j(av)))], "pdf")


# --- the BSDFs ---------------------------------------------------------------

def _checker(c0, c1):
    return {"type": "checkerboard", "color0": c0, "color1": c1}


DIFFUSE = {"type": "diffuse", "reflectance": [0.6, 0.5, 0.4]}
BSDF_CASES = {
    "conductor": {"type": "conductor", "material": "Cu"},
    "conductor eta k": {"type": "conductor", "eta": [0.2, 0.9, 1.1],
                        "k": [3.9, 2.4, 2.1],
                        "specular_reflectance": _checker(0.9, 0.5)},
    "roughconductor ggx": {"type": "roughconductor", "alpha": 0.3,
                           "material": "Au"},
    "roughconductor beckmann aniso": {
        "type": "roughconductor", "distribution": "beckmann",
        "alpha_u": 0.1, "alpha_v": 0.4},
    "dielectric": {"type": "dielectric", "int_ior": "bk7",
                   "specular_transmittance": [0.9, 0.8, 0.7]},
    "thindielectric": {"type": "thindielectric", "int_ior": 1.6},
    "roughdielectric ggx": {"type": "roughdielectric", "alpha": 0.3},
    "roughdielectric beckmann": {"type": "roughdielectric", "alpha": 0.2,
                                 "distribution": "beckmann",
                                 "int_ior": "water"},
    "plastic": {"type": "plastic",
                "diffuse_reflectance": _checker([0.8, 0.3, 0.1], 0.4)},
    "plastic nonlinear": {"type": "plastic", "nonlinear": True,
                          "diffuse_reflectance": [0.9, 0.5, 0.2]},
    "roughplastic ggx": {"type": "roughplastic", "alpha": 0.3,
                         "diffuse_reflectance": 0.5},
    "roughplastic beckmann": {"type": "roughplastic", "alpha": 0.1,
                              "distribution": "beckmann"},
    "blendbsdf": {"type": "blendbsdf", "weight": _checker(0.2, 0.8),
                  "a": DIFFUSE, "b": {"type": "roughconductor",
                                      "alpha": 0.2}},
    "mask": {"type": "mask", "opacity": 0.6,
             "b": {"type": "roughplastic", "alpha": 0.2}},
    "normalmap": {"type": "normalmap",
                  "normalmap": {"type": "bitmap",
                                "data": np.random.default_rng(5).uniform(
                                    0.3, 0.7, (8, 8, 3)).astype(np.float32)},
                  "b": {"type": "roughdielectric", "alpha": 0.2}},
    "bumpmap": {"type": "bumpmap", "scale": 0.2,
                "bumpmap": {"type": "bitmap", "data": np.random.default_rng(
                    6).random((8, 8)).astype(np.float32)},
                "b": DIFFUSE},
    "twosided plastic": {"type": "twosided",
                         "b": {"type": "plastic"}},
}


def _scenes(bsdf, variant="rgb"):
    d = {"type": "scene",
         "sensor": {"type": "perspective",
                    "film": {"width": 2, "height": 2}},
         "rect": {"type": "rectangle", "bsdf": bsdf}}
    return (jload_dict(d, JVariant(variant)),
            load_dict(d, Variant(variant), device="cpu"))


def _interactions(wi, uv):
    n = len(wi)
    z3 = np.zeros((n, 3), np.float32)
    z3[:, 2] = 1.0
    ref = JSI(t=jnp.ones(n), p=jnp.zeros((n, 3)), n=j(z3),
              sh_frame=JFrame.from_normal(j(z3)), uv=j(uv),
              prim_uv=jnp.zeros((n, 2)),
              dp_du=jnp.zeros((n, 3)).at[:, 0].set(1.0),
              dp_dv=jnp.zeros((n, 3)).at[:, 1].set(1.0), wi=j(wi),
              wavelengths=jnp.zeros((n, 0)), time=jnp.zeros(n),
              prim_index=jnp.zeros(n, jnp.int32),
              shape_index=jnp.zeros(n, jnp.int32))
    port = dataclasses.replace(
        invalid_si(n, 0, device="cpu"), t=torch.ones(n), uv=t(uv), wi=t(wi),
        shape_index=torch.zeros(n, dtype=torch.int32))
    return ref, port


@pytest.mark.parametrize("case", list(BSDF_CASES))
def test_bsdf_sample_and_eval_match_reference(case):
    jscene, scene = _scenes(BSDF_CASES[case])
    rng = np.random.default_rng(list(BSDF_CASES).index(case))
    wi, wo = unit(rng, N), unit(rng, N)
    uv = rng.random((N, 2), dtype=np.float32)
    s1 = rng.random(N, dtype=np.float32)
    s2 = rng.random((N, 2), dtype=np.float32)
    active = rng.random(N) < 0.9
    jsi, si = _interactions(wi, uv)
    jidx = jscene.shape_bsdf[jnp.zeros(N, jnp.int32)]
    idx = scene.shape_bsdf[torch.zeros(N, dtype=torch.long)]

    bs, w = bsdfs.bsdf_sample(scene, idx, si, t(s1), t(s2), t(active))
    jbs, jw = jbsdfs.bsdf_sample(jscene, jidx, jsi, j(s1), j(s2), j(active))
    assert_lanes([(bs.wo, jbs.wo), (bs.pdf, jbs.pdf), (bs.eta, jbs.eta),
                  (bs.sampled_type, np.asarray(jbs.sampled_type, np.int64)),
                  (w, jw)], f"{case} sample")
    assert float(bs.pdf.max()) > 0

    v, p = bsdfs.bsdf_eval_pdf(scene, idx, si, t(wo), t(active))
    jv, jp = jbsdfs.bsdf_eval_pdf(jscene, jidx, jsi, j(wo), j(active))
    assert_lanes([(v, jv), (p, jp)], f"{case} eval_pdf")

    nt = bsdfs.eval_null_transmission(scene, idx, si, t(active))
    jnt = jbsdfs.eval_null_transmission(jscene, jidx, jsi, j(active))
    assert_lanes([(nt, jnt)], f"{case} eval_null_transmission")


def test_bsdf_mono_variant_matches_reference():
    """The gold preset's eta and k bake to their luminance in mono, and a
    blend of a checkerboard plastic and a rough dielectric in mono."""
    for bsdf in ({"type": "roughconductor", "material": "Au",
                  "alpha": 0.2},
                 BSDF_CASES["blendbsdf"]):
        jscene, scene = _scenes(bsdf, "mono")
        rng = np.random.default_rng(9)
        wi, wo = unit(rng, N), unit(rng, N)
        uv = rng.random((N, 2), dtype=np.float32)
        s1 = rng.random(N, dtype=np.float32)
        s2 = rng.random((N, 2), dtype=np.float32)
        active = np.ones(N, bool)
        jsi, si = _interactions(wi, uv)
        jidx = jscene.shape_bsdf[jnp.zeros(N, jnp.int32)]
        idx = scene.shape_bsdf[torch.zeros(N, dtype=torch.long)]
        bs, w = bsdfs.bsdf_sample(scene, idx, si, t(s1), t(s2), t(active))
        jbs, jw = jbsdfs.bsdf_sample(jscene, jidx, jsi, j(s1), j(s2),
                                     j(active))
        assert w.shape == (N, 1)
        assert_lanes([(bs.wo, jbs.wo), (bs.pdf, jbs.pdf), (w, jw)],
                     "mono sample")
        v, p = bsdfs.bsdf_eval_pdf(scene, idx, si, t(wo), t(active))
        jv, jp = jbsdfs.bsdf_eval_pdf(jscene, jidx, jsi, j(wo), j(active))
        assert_lanes([(v, jv), (p, jp)], "mono eval_pdf")


# --- the furnace gates of tests/test_bsdfs.py, through the port --------------

def furnace_scene(bsdf, spp=96, depth=48, w=8):
    return load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": depth, "rr_depth": 1000},
        "sensor": {"type": "perspective",
                   "to_world": {"type": "look_at", "origin": [0, 0, -4],
                                "target": [0, 0, 0], "up": [0, 1, 0]},
                   "film": {"type": "hdrfilm", "width": w, "height": w,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "sphere": {"type": "sphere", "radius": 1.0, "bsdf": bsdf},
        "env": {"type": "constant", "radiance": 1.0},
    }, device="cpu")


FURNACE_GATES = {  # bsdf -> the reference test's tolerance around 1
    "conductor mirror": ({"type": "conductor"}, 0.01),
    "dielectric": ({"type": "dielectric"}, 0.01),
    "thindielectric": ({"type": "thindielectric"}, 0.01),
    "roughdielectric alpha 0.02": ({"type": "roughdielectric",
                                    "alpha": 0.02}, 0.02),
    "blend of diffuse and conductor": (
        {"type": "blendbsdf", "weight": 0.5,
         "a": {"type": "diffuse", "reflectance": 1.0},
         "b": {"type": "conductor"}}, 0.02),
    "flat normalmap": ({"type": "normalmap", "normalmap": [0.5, 0.5, 1.0],
                        "b": {"type": "diffuse", "reflectance": 1.0}}, 0.02),
}


@pytest.mark.parametrize("case", list(FURNACE_GATES))
def test_furnace_gates(case):
    bsdf, tol = FURNACE_GATES[case]
    img = integrators.render(furnace_scene(bsdf), seed=7).numpy()
    assert np.isfinite(img).all()
    assert img[3:5, 3:5].mean() == pytest.approx(1.0, abs=tol)


def test_mask_rectangle_passthrough():
    """A rectangle under an opacity-0.5 mask over a white twosided diffuse
    in a white furnace: the pass-through and the reflection both see 1."""
    scene = load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 16, "rr_depth": 1000},
        "sensor": {"type": "perspective",
                   "to_world": {"type": "look_at", "origin": [0, 0, -4],
                                "target": [0, 0, 0], "up": [0, 1, 0]},
                   "film": {"type": "hdrfilm", "width": 8, "height": 8,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 96}},
        "rect": {"type": "rectangle",
                 "bsdf": {"type": "mask", "opacity": 0.5,
                          "b": {"type": "twosided",
                                "a": {"type": "diffuse",
                                      "reflectance": 1.0}}}},
        "env": {"type": "constant", "radiance": 1.0},
    }, device="cpu")
    img = integrators.render(scene, seed=3).numpy()
    assert img[3:5, 3:5].mean() == pytest.approx(1.0, abs=0.03)


def test_conductor_material_presets():
    """The gold preset reflects more red than blue."""
    img = integrators.render(furnace_scene(
        {"type": "conductor", "material": "au"}, spp=64, depth=8),
        seed=1).numpy()
    c = img[3:5, 3:5].mean(axis=(0, 1))
    assert c[0] > c[2] * 1.5, c
