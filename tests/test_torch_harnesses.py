"""The port's statistical harnesses (utils/special.py, utils/chi2.py,
utils/ztest.py) against the JAX package's:

- special: gamma_q, chi2_p_value and erf_inv against the reference's on
  a grid of (a, x), degrees of freedom and y, at rtol 1e-12;
- chi2: ChiSquareTest's histogram bit-equal to the reference's for the
  same seed (raw draws over a line and a square, and the hg phase
  function through PhaseFunctionAdapter), and its Simpson pdf table at
  rtol 1e-6; every test of tests/test_sampling_chi2.py on the port (shape
  area sampling, an area emitter's and an envmap's direction sampling);
  BSDFAdapter over four BSDFs at tests/test_bsdfs.py's settings, its
  histograms the reference's; the spectrum adapter; a wrong pdf fails;
- ztest: z_test on shared arrays equal to the reference's (the decision,
  the pass fraction and the p-values within 1e-6: the reference's erf is
  float32), and the three z-test cases of tests/test_regression.py on
  the port: the Cornell box against itself and against a changed albedo,
  and the atmosphere against itself (their EXRs written and read by
  utils/bitmap.py; the atmosphere on the lane pool of 16,384 lanes,
  about 5x faster on the CPU than the scan driver's one pass).
"""

import numpy as np
import pytest
import torch

from eradiate_kernel_tpu.utils import chi2 as rchi2
from eradiate_kernel_tpu.utils import special as rspecial
from eradiate_kernel_tpu.utils import ztest as rztest
from eradiate_kernel_tpu_torch import emitters
from eradiate_kernel_tpu_torch.core.frame import Frame
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.render import shape_sampling
from eradiate_kernel_tpu_torch.render.geometry import ray_intersect
from eradiate_kernel_tpu_torch.render.records import SurfaceInteraction
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import chi2, special, ztest
from eradiate_kernel_tpu_torch.utils.chi2 import (ChiSquareTest, LineDomain,
                                                  PlanarDomain,
                                                  SphericalDomain)
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere, cornell_box
from test_torch_sensors import one_torch_thread  # noqa: F401

N = 150_000


# ---- special --------------------------------------------------------------------

def test_special_matches_reference():
    for a in (0.5, 1.0, 2.5, 10.0, 60.5, 400.0):
        for x in (0.0, 1e-3, 0.4, 1.0, 3.0, 11.0, 60.0, 420.0):
            np.testing.assert_allclose(special.gamma_q(a, x),
                                       rspecial.gamma_q(a, x), rtol=1e-12)
    for dof in (0, 1, 2, 7, 50, 1000):
        for stat in (0.0, 0.5, 5.0, 40.0, 1200.0):
            np.testing.assert_allclose(special.chi2_p_value(stat, dof),
                                       rspecial.chi2_p_value(stat, dof),
                                       rtol=1e-12)
    y = np.linspace(-0.999999, 0.999999, 2001)
    np.testing.assert_allclose(special.erf_inv(y), rspecial.erf_inv(y),
                               rtol=1e-12)
    with pytest.raises(ValueError):
        special.gamma_q(-1.0, 1.0)


# ---- chi2: the harness against the reference's ------------------------------------

def raw_pair(kind):
    """(port sample_func, reference sample_func, domain args, pdf) of the
    sampler's own draws: bit-equal in both packages."""
    if kind == "line":
        def port(s):
            return s.next_1d()[1][:, None]

        def ref(s):
            return np.asarray(s.next_1d()[1])[:, None]

        return port, ref, LineDomain(), rchi2.LineDomain(), \
            lambda p: np.ones(p.shape[0])

    def port(s):
        return 2.0 * s.next_2d()[1] - 1.0

    def ref(s):
        return 2.0 * np.asarray(s.next_2d()[1]) - 1.0

    return port, ref, PlanarDomain(), rchi2.PlanarDomain(), \
        lambda p: np.full(p.shape[0], 0.25)


@pytest.mark.parametrize("kind", ["line", "square"])
def test_chi2_tables_match_reference(kind):
    port, ref, dom, rdom, pdf = raw_pair(kind)
    t = ChiSquareTest(dom, port, lambda p: pdf(p), sample_count=20_000,
                      res=16, ires=5, seed=3, device="cpu")
    r = rchi2.ChiSquareTest(rdom, ref, lambda p: pdf(p), sample_count=20_000,
                            res=16, ires=5, seed=3)
    np.testing.assert_array_equal(t.tabulate_histogram(),
                                  r.tabulate_histogram())
    np.testing.assert_allclose(t.tabulate_pdf(), r.tabulate_pdf(),
                               rtol=1e-6)
    assert t.run() == r.run()
    np.testing.assert_allclose(t.p_value, r.p_value, rtol=1e-12)


def test_chi2_phase_adapter_matches_reference():
    """The hg phase function through PhaseFunctionAdapter: the histogram
    of the port's draws is the reference's and the pdf table agrees at
    rtol 1e-6; both accept."""
    port = chi2.PhaseFunctionAdapter({"type": "hg", "g": 0.5},
                                     device="cpu")
    ref = rchi2.PhaseFunctionAdapter({"type": "hg", "g": 0.5})
    t = ChiSquareTest(SphericalDomain(), *port, sample_count=50_000, res=16,
                      ires=5, device="cpu")
    r = rchi2.ChiSquareTest(rchi2.SphericalDomain(), *ref,
                            sample_count=50_000, res=16, ires=5)
    np.testing.assert_array_equal(t.tabulate_histogram(),
                                  r.tabulate_histogram())
    np.testing.assert_allclose(t.tabulate_pdf(), r.tabulate_pdf(),
                               rtol=1e-6)
    assert t.run() and r.run(), t.messages + r.messages


@pytest.mark.parametrize("bsdf", [{"type": "diffuse"},
                                  {"type": "roughconductor", "alpha": 0.3},
                                  {"type": "pplastic", "alpha": 0.2},
                                  {"type": "rpv", "rho_0": 0.3, "k": 0.7,
                                   "g": -0.2}],
                         ids=lambda b: b["type"])
def test_chi2_bsdf_adapter(bsdf):
    """BSDFAdapter at tests/test_bsdfs.py's settings (the upper
    hemisphere, res 64, ires 9, 150,000 samples): the port's histogram is
    the reference's and both accept."""
    t = ChiSquareTest(SphericalDomain((0.0, 1.0)),
                      *chi2.BSDFAdapter(bsdf, device="cpu"),
                      sample_count=N, res=64, ires=9, device="cpu")
    r = rchi2.ChiSquareTest(rchi2.SphericalDomain((0.0, 1.0)),
                            *rchi2.BSDFAdapter(bsdf), sample_count=N,
                            res=64, ires=9)
    assert t.run(0.01), t.messages
    assert r.run(0.01), r.messages
    np.testing.assert_array_equal(t.histogram, r.histogram)
    np.testing.assert_allclose(t.pdf, r.pdf, rtol=1e-6, atol=1e-6)


def test_chi2_spectrum_adapter():
    """A linear wavelength density on [360, 830] nm by its inverse cdf."""
    lo, hi = 360.0, 830.0

    def sample_fn(s):
        lam = lo + (hi - lo) * torch.sqrt(s)
        return lam, torch.ones_like(lam)

    def pdf_fn(lam):
        return 2.0 * (lam - lo) / (hi - lo) ** 2

    t = ChiSquareTest(LineDomain((lo, hi)),
                      *chi2.SpectrumAdapter(sample_fn, pdf_fn),
                      sample_count=N, res=40, ires=5, device="cpu")
    assert t.run(0.01), t.messages


def test_chi2_rejects_a_wrong_pdf():
    """The harness fails a pdf that is not the routine's density."""
    t = ChiSquareTest(LineDomain(), lambda s: s.next_1d()[1][:, None] ** 2,
                      lambda p: torch.ones(p.shape[0]), sample_count=N,
                      res=40, ires=5, device="cpu")
    assert not t.run(0.01)
    assert "rejected" in "\n".join(t.messages)


# ---- tests/test_sampling_chi2.py on the port ------------------------------------

def plane_scene(entry):
    return load_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "film": {"width": 2, "height": 2}},
        **entry}, device="cpu")


def test_sphere_position_sampling_uniform():
    scene = plane_scene({"s": {"type": "sphere", "center": [1.0, 2.0, 3.0],
                               "radius": 2.0, "bsdf": {"type": "diffuse"}}})

    def sample_func(sampler):
        n = sampler.k0.shape[0]
        sampler, s1 = sampler.next_1d()
        sampler, s2 = sampler.next_2d()
        ps = shape_sampling.sample_position(
            scene, torch.zeros(n, dtype=torch.int64), s1, s2)
        return (ps.p - torch.tensor([1.0, 2.0, 3.0])) / 2.0

    t = ChiSquareTest(SphericalDomain(), sample_func,
                      lambda p: torch.full((p.shape[0],), 1 / (4 * np.pi)),
                      sample_count=N, res=32, ires=9, device="cpu")
    assert t.run(0.01), "\n".join(t.messages)


def test_rect_position_sampling_uniform():
    scene = plane_scene({"r": {"type": "rectangle",
                               "bsdf": {"type": "diffuse"}}})

    def sample_func(sampler):
        n = sampler.k0.shape[0]
        sampler, s1 = sampler.next_1d()
        sampler, s2 = sampler.next_2d()
        ps = shape_sampling.sample_position(
            scene, torch.zeros(n, dtype=torch.int64), s1, s2)
        return ps.p[:, :2]

    t = ChiSquareTest(PlanarDomain(np.array([[-1, 1], [-1, 1]])),
                      sample_func, lambda p: torch.full((p.shape[0],), 0.25),
                      sample_count=N, res=24, ires=9, device="cpu")
    assert t.run(0.01), "\n".join(t.messages)


def _ref_si(n, p):
    up = torch.zeros(n, 3)
    up[:, 2] = 1.0
    return SurfaceInteraction(
        t=torch.ones(n), p=torch.tensor(p, dtype=torch.float32).expand(n, 3),
        n=up, sh_frame=Frame.from_normal(up), uv=torch.zeros(n, 2),
        prim_uv=torch.zeros(n, 2), dp_du=up, dp_dv=up, wi=up,
        time=torch.zeros(n), prim_index=torch.zeros(n, dtype=torch.int32),
        shape_index=torch.zeros(n, dtype=torch.int32))


def emitter_sample_func(scene, ref_p):
    def sample_func(sampler):
        n = sampler.k0.shape[0]
        sampler, sp = sampler.next_1d()
        sampler, s1 = sampler.next_1d()
        sampler, s2 = sampler.next_2d()
        ds, _w = emitters.sample_emitter_direction(
            scene, _ref_si(n, ref_p), sp, s1, s2,
            torch.ones(n, dtype=torch.bool), test_visibility=False)
        return ds.d, (ds.pdf > 0).to(torch.float32)

    return sample_func


def test_area_emitter_direction_chi2():
    scene = plane_scene({"light": {
        "type": "rectangle",
        "to_world": [{"type": "rotate", "axis": [1, 0, 0], "angle": 180.0},
                     {"type": "translate", "value": [0, 0, 2]}],
        "emitter": {"type": "area", "radiance": 1.0},
        "bsdf": {"type": "diffuse"}}})
    ref_p = [0.2, -0.3, 0.0]

    def pdf_func(pts):
        n = pts.shape[0]
        o = torch.tensor(ref_p).expand(n, 3)
        ray = Ray.make(o, pts)
        si = ray_intersect(scene.geo, ray)
        return emitters.pdf_emitter_direction(
            scene, o, si, ~si.is_valid, torch.ones(n, dtype=torch.bool),
            d=ray.d)

    t = ChiSquareTest(SphericalDomain(cos_bounds=(0.5, 1.0)),
                      emitter_sample_func(scene, ref_p), pdf_func,
                      sample_count=N, res=32, ires=9, device="cpu")
    assert t.run(0.01), "\n".join(t.messages)


def test_envmap_direction_chi2():
    rng = np.random.default_rng(3)
    env = (0.1 + rng.random((16, 32, 3)) ** 3).astype(np.float32)
    scene = plane_scene({"sky": {"type": "envmap", "data": env}})

    def pdf_func(pts):
        n = pts.shape[0]
        return emitters.envmap_pdf_direction(
            scene, scene.emitters["envmap"], torch.zeros(n, dtype=torch.int64),
            pts, torch.ones(n, dtype=torch.bool))

    t = ChiSquareTest(SphericalDomain(cos_bounds=(-0.97, 0.97)),
                      emitter_sample_func(scene, [0, 0, 0]), pdf_func,
                      sample_count=N, res=16, ires=33, device="cpu")
    assert t.run(0.01), "\n".join(t.messages)


# ---- ztest ----------------------------------------------------------------------

def test_z_test_matches_reference():
    rng = np.random.default_rng(5)
    ref_mean = rng.random((24, 24, 3))
    ref_var = rng.random((24, 24, 3)) * 1e-3
    var = rng.random((24, 24, 3)) * 1e-3
    for shift in (0.0, 0.02, 0.2):
        mean = ref_mean + shift * rng.standard_normal((24, 24, 3))
        mean[0, :4] = ref_mean[0, :4]  # degenerate pixels compare directly
        ref_var[0, :4] = var[0, :4] = 0.0
        got = ztest.z_test(mean, var, ref_mean, ref_var)
        want = rztest.z_test(mean, var, ref_mean, ref_var)
        assert got[0] == want[0] and got[1] == want[1]
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    assert ztest.sidak_alpha(0.01, 100) == rztest.sidak_alpha(0.01, 100)


def test_ztest_self_consistency(tmp_path):
    """Same scene, independent seeds: the z-test passes."""
    d = cornell_box(width=24, height=24, spp=32, max_depth=3)
    ok, frac, _ = ztest.check_scene(d, str(tmp_path), "cbox", spp=64,
                                    ref_spp=256, device="cpu")
    assert ok, f"only {frac:.4f} of pixels passed"


def test_ztest_detects_regression(tmp_path):
    """A scene with a changed albedo fails against the stored reference."""
    d = cornell_box(width=24, height=24, spp=32, max_depth=3)
    ztest.check_scene(d, str(tmp_path), "cbox2", spp=64, ref_spp=256,
                      device="cpu")
    bad = cornell_box(width=24, height=24, spp=32, max_depth=3)
    bad["white_bsdf"]["reflectance"]["value"] = [0.6, 0.698, 0.666]
    ok, frac, _ = ztest.check_scene(bad, str(tmp_path), "cbox2", spp=64,
                                    device="cpu")
    assert not ok, f"{frac:.4f} of pixels passed a perturbed scene"


def test_ztest_atmosphere(tmp_path):
    """The flagship volpath atmosphere against itself, at
    tests/test_regression.py's budgets (160 and 640 spp: at 48 spp its
    horizon pixels' heavy tails fail the test by chance)."""
    d = atmosphere(width=16, height=16, spp=16, max_depth=8)
    ok, frac, _ = ztest.check_scene(d, str(tmp_path), "atmo", spp=160,
                                    ref_spp=640, device="cpu", regen=True,
                                    samples_per_pass=16384)
    assert ok, f"only {frac:.4f} of pixels passed"


def test_render_with_variance_matches_reference():
    """Mean and variance of the mean of a small Cornell box: the moment
    film of the port against the reference's, same seed."""
    d = cornell_box(width=8, height=8, spp=16, max_depth=3)
    got = ztest.render_with_variance(d, spp=16, seed=2, device="cpu")
    from eradiate_kernel_tpu.utils import scenes as jscenes

    want = rztest.render_with_variance(
        jscenes.cornell_box(width=8, height=8, spp=16, max_depth=3), spp=16,
        seed=2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-8)
    np.testing.assert_array_equal(got[2], want[2])
