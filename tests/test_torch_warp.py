"""The port's sampling warps, math and frame helpers against the JAX
package's, on the same numpy inputs made from a seed, and the reference's
own warp tests on the port:

- (a) every warp of core/warp.py that slice 7d added, its pdf and its
  inverse, on a 64x64 grid of sample centres, the square's corner and
  edges, and 4,096 seeded random samples (the pdfs at the reference's
  warped points, the disk's also beyond its edge). Each value is within
  8 float32 ulps of the reference's, |got - want| <= 8 eps (1 + |want| +
  cond), where cond is the output's condition number against a 1-ulp
  change of an intermediate: |cos| / sin for the x and y components of a
  direction on the sphere (near the pole, sin = sqrt(1 - cos^2) turns
  the ulp of cos into 3e-4), 0 elsewhere. torch's log, exp, sin and cos
  differ from XLA's by 1-2 ulp;
- (b) every helper of core/math.py and core/frame.py that slice 7d
  added, on seeded inputs, within the same 8 ulps (legendre_p's
  recurrence within 64 ulps of the largest |P_n| on [-1, 1], which is
  1; exact for the integer and boolean helpers);
- (c) the chi2 cases of tests/test_warp.py:24-97, run through the port's
  utils/chi2.py on the port's warps at the same significance;
- (d) tests/test_core.py::test_solve_quadratic's cases on the port.

The reference runs eagerly on small arrays: the file takes ~10 s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu.core import frame as jframe
from eradiate_kernel_tpu.core import math as jm
from eradiate_kernel_tpu.core import warp as jw
from eradiate_kernel_tpu_torch.core import frame, warp
from eradiate_kernel_tpu_torch.core import math as m
from eradiate_kernel_tpu_torch.utils.chi2 import (ChiSquareTest,
                                                  PlanarDomain,
                                                  SphericalDomain,
                                                  WarpAdapter)
from test_torch_nee_modes import one_torch_thread  # noqa: F401 (fixture)

EPS = float(np.finfo(np.float32).eps)
T = torch.as_tensor
J = jnp.asarray


def samples(seed=0):
    """(8,192, 2) float32 samples: the 64x64 grid's centres, the corner
    (0, 0), the centre and the edges, then seeded random ones."""
    g = (np.arange(64) + 0.5) / 64
    grid = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    s = np.concatenate([grid, np.random.default_rng(seed).random(
        (4096, 2))]).astype(np.float32)
    s[:4] = [[0.0, 0.0], [0.5, 0.5], [0.0, 0.5], [0.5, 0.0]]
    return s


def close(got, want, ulps=8, cond=0.0, what=""):
    """|got - want| <= ulps eps (1 + |want| + cond), element-wise; the
    reference's infinities exactly."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = np.isfinite(want)
    # the same infinities (rcp of +-0) where the reference has them
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    tol = ulps * EPS * (1.0 + np.abs(want) + cond)
    bad = ~(np.abs(got - want) <= tol) & fin
    assert not bad.any(), (what, int(bad.sum()), float(
        np.abs(got - want).max()))


def sphere_cond(d):
    """The x, y, z condition numbers of directions d on the sphere."""
    d = np.asarray(d, np.float64)
    st = np.maximum(np.sqrt(np.maximum(1.0 - d[:, 2] ** 2, 0.0)), 1e-7)
    c = np.abs(d[:, 2]) / st
    return np.stack([c, c, np.zeros_like(c)], -1)


# ---- (a) the warps ----------------------------------------------------------

def _warp_case(name):
    """(got, want, cond) of warp ``name`` on samples()."""
    s = samples()
    if name in ("square_to_uniform_disk", "square_to_tent",
                "square_to_std_normal"):
        return getattr(warp, name)(T(s)), getattr(jw, name)(J(s)), 0.0
    if name == "interval_to_tent":
        return warp.interval_to_tent(T(s[:, 0])), jw.interval_to_tent(
            J(s[:, 0])), 0.0
    if name == "interval_to_nonuniform_tent":
        a, b, c = -1.0, 0.3, 2.0
        return (warp.interval_to_nonuniform_tent(a, b, c, T(s[:, 0])),
                jw.interval_to_nonuniform_tent(a, b, c, J(s[:, 0])), 0.0)
    kind, _, par = name.partition(" ")
    par = float(par or 0)
    if kind in ("square_to_beckmann", "square_to_von_mises_fisher"):
        want = getattr(jw, kind)(J(s), par)
        return getattr(warp, kind)(T(s), par), want, sphere_cond(want)
    # the pdfs (and the inverse) at the reference's warped points
    pts = {
        "square_to_uniform_disk_pdf": lambda: 1.2 * np.asarray(
            jw.square_to_uniform_disk(J(s))),
        "uniform_disk_to_square_concentric": lambda: np.asarray(
            jw.square_to_uniform_disk_concentric(J(s))),
        "square_to_uniform_triangle_pdf": lambda: 1.2 * s - 0.1,
        "square_to_uniform_hemisphere_pdf": lambda: np.asarray(
            jw.square_to_uniform_sphere(J(s))),
        "square_to_tent_pdf": lambda: 1.1 * np.asarray(
            jw.square_to_tent(J(s))),
        "square_to_std_normal_pdf": lambda: np.asarray(
            jw.square_to_std_normal(J(s))),
        "square_to_beckmann_pdf": lambda: np.asarray(
            jw.square_to_beckmann(J(s), par)),
        "square_to_von_mises_fisher_pdf": lambda: np.asarray(
            jw.square_to_von_mises_fisher(J(s), par)),
    }[kind]().astype(np.float32)
    args = (par,) if kind in ("square_to_beckmann_pdf",
                              "square_to_von_mises_fisher_pdf") else ()
    return (getattr(warp, kind)(T(pts), *args),
            getattr(jw, kind)(J(pts), *args), 0.0)


WARPS = ["square_to_uniform_disk", "square_to_uniform_disk_pdf",
         "uniform_disk_to_square_concentric",
         "square_to_uniform_triangle_pdf",
         "square_to_uniform_hemisphere_pdf", "square_to_tent",
         "square_to_tent_pdf", "interval_to_tent",
         "interval_to_nonuniform_tent", "square_to_std_normal",
         "square_to_std_normal_pdf"] + [
    f"{k} {p}" for k in ("square_to_beckmann", "square_to_beckmann_pdf")
    for p in (0.1, 0.5, 1.0)] + [
    f"{k} {p}" for k in ("square_to_von_mises_fisher",
                         "square_to_von_mises_fisher_pdf")
    for p in (0.5, 10.0, 100.0)]


@pytest.mark.parametrize("name", WARPS)
def test_warp_matches_reference(name):
    got, want, cond = _warp_case(name)
    assert torch.isfinite(got).all()
    close(got, want, cond=cond, what=name)


def test_bilinear_pdf_matches_reference_and_the_warp():
    rng = np.random.default_rng(3)
    v = rng.uniform(0.1, 2.0, (4, 8192)).astype(np.float32)
    s = samples(3)
    got = warp.square_to_bilinear_pdf(*map(T, v), T(s))
    close(got, jw.square_to_bilinear_pdf(*map(J, v), J(s)), what="pdf")
    # the pdf at square_to_bilinear's point is the value it returns
    pos, val = warp.square_to_bilinear(*map(T, v), T(s))
    close(warp.square_to_bilinear_pdf(*map(T, v), pos), val, ulps=16)


def test_warp_constants_and_tensor_parameters():
    """INV_TWO_PI is the reference's; alpha and kappa may be per-lane
    tensors (the same values as Python numbers)."""
    assert warp.INV_TWO_PI == jw.INV_TWO_PI
    s = T(samples()[:512])
    a = torch.full((512,), 0.5)
    close(warp.square_to_beckmann(s, a), warp.square_to_beckmann(s, 0.5),
          cond=sphere_cond(warp.square_to_beckmann(s, 0.5)))
    d = warp.square_to_von_mises_fisher(s, 10.0)
    close(warp.square_to_von_mises_fisher_pdf(d, torch.full((512,), 10.0)),
          warp.square_to_von_mises_fisher_pdf(d, 10.0))


# ---- (b) math and frame helpers ---------------------------------------------

def _math_case(name, rng):
    n = 4096
    x = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    t = rng.random(n).astype(np.float32)
    d = a / np.linalg.norm(a, axis=-1, keepdims=True)
    if name in ("safe_acos", "safe_asin", "rcp", "sign"):
        x[:4] = [0.0, -0.0, 1.0, -1.0]
        return getattr(m, name)(T(x)), getattr(jm, name)(J(x))
    if name in ("norm", "squared_norm"):
        return (torch.cat([getattr(m, name)(T(a)), getattr(m, name)(
                    T(a), keepdims=True)[:, 0]]),
                jnp.concatenate([getattr(jm, name)(J(a)), getattr(jm, name)(
                    J(a), keepdims=True)[:, 0]]))
    if name == "lerp":
        return m.lerp(T(a), T(b), T(t[:, None])), jm.lerp(J(a), J(b),
                                                         J(t[:, None]))
    if name == "safe_div":
        y = x.copy()
        y[:64] = 0.0
        return m.safe_div(T(t), T(y)), jm.safe_div(J(t), J(y))
    if name == "fmadd":
        return m.fmadd(T(a), T(b), T(t[:, None])), jm.fmadd(
            J(a), J(b), J(t[:, None]))
    if name == "select":
        mask = t > 0.5
        return (m.select(T(mask), T(a), T(b)),
                jm.select(J(mask), J(a), J(b)))
    if name == "sph_to_dir":
        th, ph = t * np.float32(np.pi), x * np.float32(2)
        return m.sph_to_dir(T(th), T(ph)), jm.sph_to_dir(J(th), J(ph))
    if name == "dir_to_sph":
        return (torch.stack(m.dir_to_sph(T(d)), -1),
                jnp.stack(jm.dir_to_sph(J(d)), -1))
    if name in ("cos_theta_2", "tan_theta_2", "sin_phi", "cos_phi",
                "same_hemisphere"):
        d[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]
        args = (d, b) if name == "same_hemisphere" else (d,)
        return (getattr(frame, name)(*map(T, args)),
                getattr(jframe, name)(*map(J, args)))
    raise KeyError(name)


MATH = ["safe_acos", "safe_asin", "norm", "squared_norm", "lerp", "rcp",
        "safe_div", "fmadd", "sign", "select", "sph_to_dir", "dir_to_sph",
        "cos_theta_2", "tan_theta_2", "sin_phi", "cos_phi",
        "same_hemisphere"]


@pytest.mark.parametrize("name", MATH)
def test_math_and_frame_helpers_match_reference(name):
    got, want = _math_case(name, np.random.default_rng(MATH.index(name)))
    if name == "same_hemisphere":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        close(got, want, what=name)


def test_epsilon_search_morton_and_legendre_match_reference():
    rng = np.random.default_rng(11)
    assert m.EPSILON == float(jm.EPSILON)
    values = np.sort(rng.uniform(0, 10, 33)).astype(np.float32)
    x = np.concatenate([rng.uniform(-1, 11, 4096), values]).astype(
        np.float32)
    np.testing.assert_array_equal(
        m.linear_search(T(values), T(x)).numpy(),
        np.asarray(jm.linear_search(J(values), J(x))))
    u = rng.integers(0, 1 << 16, 4096).astype(np.uint32)
    v = rng.integers(0, 1 << 16, 4096).astype(np.uint32)
    u[:2], v[:2] = [0, 0xFFFF], [0xFFFF, 0xFFFF]
    np.testing.assert_array_equal(
        m.morton_encode2(T(u.astype(np.int64)), T(v.astype(np.int64)))
        .numpy(), np.asarray(jm.morton_encode2(J(u), J(v))).astype(np.int64))
    c = np.concatenate([[-1.0, 0.0, 1.0], rng.uniform(-1, 1, 4096)]).astype(
        np.float32)
    for n in range(9):
        close(m.legendre_p(n, T(c)), jm.legendre_p(n, J(c)), ulps=64,
              what=f"P_{n}")


# ---- (c) the reference's chi2 warp cases on the port ------------------------

CHI2 = {
    "uniform_disk": (PlanarDomain(), warp.square_to_uniform_disk,
                     warp.square_to_uniform_disk_pdf, 31),
    "uniform_disk_concentric": (
        PlanarDomain(), warp.square_to_uniform_disk_concentric,
        warp.square_to_uniform_disk_pdf, 31),
    "uniform_triangle": (PlanarDomain(np.array([[0, 1], [0, 1]])),
                         warp.square_to_uniform_triangle,
                         warp.square_to_uniform_triangle_pdf, 101),
    "uniform_sphere": (SphericalDomain(), warp.square_to_uniform_sphere,
                       warp.square_to_uniform_sphere_pdf, 31),
    "uniform_hemisphere": (SphericalDomain(cos_bounds=(0.0, 1.0)),
                           warp.square_to_uniform_hemisphere,
                           warp.square_to_uniform_hemisphere_pdf, 31),
    "cosine_hemisphere": (SphericalDomain(),
                          warp.square_to_cosine_hemisphere,
                          warp.square_to_cosine_hemisphere_pdf, 31),
    "tent": (PlanarDomain(), warp.square_to_tent, warp.square_to_tent_pdf,
             31),
    "std_normal": (PlanarDomain(np.array([[-4, 4], [-4, 4]])),
                   warp.square_to_std_normal, warp.square_to_std_normal_pdf,
                   31),
}
for _c in (0.95, 0.5, -0.3):
    CHI2[f"uniform_cone {_c}"] = (
        SphericalDomain(cos_bounds=(_c, 1.0)),
        lambda s, c=_c: warp.square_to_uniform_cone(s, c),
        lambda d, c=_c: warp.square_to_uniform_cone_pdf(d, c), (16, 48))
for _a in (0.1, 0.5, 1.0):
    CHI2[f"beckmann {_a}"] = (
        SphericalDomain(cos_bounds=(max(-1.0, np.cos(np.arctan(5.0 * _a))
                                        - 0.02), 1.0)),
        lambda s, a=_a: warp.square_to_beckmann(s, a),
        lambda d, a=_a: warp.square_to_beckmann_pdf(d, a), (16, 64))
for _k in (0.5, 10.0, 100.0):
    CHI2[f"von_mises_fisher {_k}"] = (
        SphericalDomain(cos_bounds=(max(-1.0, 1.0 - 12.0 / _k), 1.0)),
        lambda s, k=_k: warp.square_to_von_mises_fisher(s, k),
        lambda d, k=_k: warp.square_to_von_mises_fisher_pdf(d, k), (16, 64))


@pytest.mark.parametrize("case", list(CHI2))
def test_warp_chi2(case):
    """tests/test_warp.py:16-97 on the port: 200,000 samples, ires 9,
    significance 0.01."""
    domain, warp_fn, pdf_fn, res = CHI2[case]
    sample_func, pdf_func = WarpAdapter(warp_fn, pdf_fn)
    test = ChiSquareTest(domain, sample_func, pdf_func, sample_count=200_000,
                         res=res, ires=9, device="cpu")
    assert test.run(significance_level=0.01), "\n".join(test.messages)


# ---- (d) solve_quadratic ----------------------------------------------------

def test_solve_quadratic():
    """tests/test_core.py::test_solve_quadratic on the port."""
    valid, x0, x1 = m.solve_quadratic(T([1.0, 1.0, 0.0, 1.0]),
                                      T([0.0, -3.0, 2.0, 0.0]),
                                      T([-4.0, 2.0, -4.0, 4.0]))
    assert valid.tolist() == [True, True, True, False]
    assert np.allclose(x0.numpy()[:3], [-2.0, 1.0, 2.0], atol=1e-6)
    assert np.allclose(x1.numpy()[:3], [2.0, 2.0, 2.0], atol=1e-6)


def test_solve_quadratic_matches_reference():
    """Seeded coefficients, a tenth of them linear (a = 0) and some with
    b = 0 too: valid exactly, the roots within 8 ulps where valid."""
    rng = np.random.default_rng(7)
    a, b, c = rng.normal(size=(3, 4096)).astype(np.float32)
    a[:400] = 0.0
    b[:40] = 0.0
    got = m.solve_quadratic(T(a), T(b), T(c))
    want = jm.solve_quadratic(J(a), J(b), J(c))
    ok = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), ok)
    for g, w in zip(got[1:], want[1:]):
        close(g.numpy()[ok], np.asarray(w)[ok], what="roots")
