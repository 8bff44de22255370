"""The port's numerics modules (core/qmc.py, core/distr.py, core/spline.py,
core/quad.py; slice 5c-2) against the JAX package's on the same numpy
inputs made from a seed, and tests/test_quad_spline_qmc.py's contract run
on the port. No render path reads them.

Tolerances: the quadrature tables are float64 numpy in both packages and
must be bit-equal. The radical inverses' digits are exact integers; their
float32 sums may differ by XLA's contracted multiply-adds: rtol 1e-6.
Distributions and splines are the same float32 expressions: rtol 1e-5
(atol 1e-6); an inverse-CDF sample may pick the neighbouring interval on
an ulp at a CDF edge on at most 0.5 % of the lanes. The splines' inversion
and sampling stop after a fixed 16 steps of bracketed Newton, short of
float32 convergence on some lanes, where an ulp switches a step between
Newton and bisection: x within atol 1e-4 (of a range of 2), the density
there within 1e-3 (its slope is below 10), and the port's residual
f(x) - y no larger than the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu.core import distr as jdistr
from eradiate_kernel_tpu.core import qmc as jqmc
from eradiate_kernel_tpu.core import quad as jquad
from eradiate_kernel_tpu.core import spline as jspline
from eradiate_kernel_tpu_torch.core import distr, qmc, quad, spline

N = 4096
RTOL, ATOL = 1e-5, 1e-6
NEWTON_ATOL = 1e-4


def close(a, b, what, rtol=RTOL, atol=ATOL, allowed=0.0):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    assert (~ok).mean() <= allowed, (what, (~ok).mean(),
                                     np.abs(a - b).max())


@pytest.mark.parametrize("rule,n", [("gauss_legendre", 8),
                                    ("gauss_lobatto", 6),
                                    ("composite_simpson", 33),
                                    ("composite_simpson_38", 31)])
def test_quadrature_rules_bit_equal(rule, n):
    x, w = getattr(quad, rule)(n)
    jx, jw = getattr(jquad, rule)(n)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert float(w.sum()) == pytest.approx(2.0, rel=1e-6)


def test_radical_inverse_matches_reference():
    rng = np.random.default_rng(0)
    idx = np.concatenate([np.arange(64), rng.integers(0, 2 ** 32, 4000,
                                                      dtype=np.uint64)])
    for base_index in (0, 1, 5, 100):
        close(qmc.radical_inverse(base_index, torch.as_tensor(
            idx.astype(np.int64))),
              jqmc.radical_inverse(base_index, jnp.asarray(idx, jnp.uint32)),
              f"radical_inverse {base_index}", rtol=1e-6)
        for seed in (1, 7, 0xDEADBEEF):
            close(qmc.radical_inverse_scrambled(
                base_index, torch.as_tensor(idx.astype(np.int64)), seed),
                  jqmc.radical_inverse_scrambled(
                      base_index, jnp.asarray(idx, jnp.uint32), seed),
                  f"scrambled {base_index} {seed}", rtol=1e-6)
    assert qmc.radical_inverse(0, torch.arange(8)).tolist() == [
        0.0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875]


def test_distributions_match_reference():
    rng = np.random.default_rng(1)
    pmf = rng.random(37).astype(np.float32)
    pmf[[3, 4, 20]] = 0.0
    xi = rng.random(N, dtype=np.float32)
    d, jd = distr.DiscreteDistribution.from_pmf(pmf), \
        jdistr.DiscreteDistribution.from_pmf(pmf)
    idx, p = d.sample_pmf(torch.as_tensor(xi))
    jidx, jp = jd.sample_pmf(jnp.asarray(xi))
    same = idx.numpy() == np.asarray(jidx)
    assert same.mean() > 0.995
    close(p.numpy()[same], np.asarray(jp)[same], "pmf")
    ridx, rxi = d.sample_reuse(torch.as_tensor(xi))
    jridx, jrxi = jd.sample_reuse(jnp.asarray(xi))
    same = ridx.numpy() == np.asarray(jridx)
    close(rxi.numpy()[same], np.asarray(jrxi)[same], "reuse", atol=1e-5)

    vals = rng.random(25) + 0.1
    nodes = np.sort(rng.uniform(-1.0, 3.0, 25))
    for d, jd in (
            (distr.ContinuousDistribution.from_pdf(vals, -1.0, 3.0),
             jdistr.ContinuousDistribution.from_pdf(vals, -1.0, 3.0)),
            (distr.IrregularContinuousDistribution.from_pdf(nodes, vals),
             jdistr.IrregularContinuousDistribution.from_pdf(nodes, vals))):
        x, p = d.sample_pdf(torch.as_tensor(xi))
        jx, jp = jd.sample_pdf(jnp.asarray(xi))
        close(x, jx, "sample", allowed=0.005)
        close(p, jp, "pdf", allowed=0.005)
        q = rng.uniform(-1.5, 3.5, N).astype(np.float32)
        close(d.eval_pdf_normalized(torch.as_tensor(q)),
              jd.eval_pdf_normalized(jnp.asarray(q)), "eval_pdf")


def test_splines_match_reference():
    rng = np.random.default_rng(2)
    values = np.cumsum(rng.random(17) + 0.05).astype(np.float32)
    xs = rng.uniform(-0.5, 2.5, N).astype(np.float32)
    close(spline.eval_1d(0.0, 2.0, torch.as_tensor(values),
                         torch.as_tensor(xs)),
          jspline.eval_1d(0.0, 2.0, jnp.asarray(values), jnp.asarray(xs)),
          "eval_1d")
    nodes = np.sort(rng.uniform(0.0, 2.0, 17)).astype(np.float32)
    close(spline.eval_1d_nonuniform(torch.as_tensor(nodes),
                                    torch.as_tensor(values),
                                    torch.as_tensor(xs)),
          jspline.eval_1d_nonuniform(jnp.asarray(nodes), jnp.asarray(values),
                                     jnp.asarray(xs)), "eval_1d_nonuniform")
    dens = (rng.random(17) + 0.2).astype(np.float32)
    cdf = spline.integrate_1d(0.0, 2.0, torch.as_tensor(dens))
    jcdf = jspline.integrate_1d(0.0, 2.0, jnp.asarray(dens))
    close(cdf, jcdf, "integrate_1d")
    ys = rng.uniform(values[0], values[-1], N).astype(np.float32)
    xi = spline.invert_1d(0.0, 2.0, torch.as_tensor(values),
                          torch.as_tensor(ys))
    jxi = jspline.invert_1d(0.0, 2.0, jnp.asarray(values), jnp.asarray(ys))
    close(xi, jxi, "invert_1d", atol=NEWTON_ATOL)
    resid = np.abs(spline.eval_1d(0.0, 2.0, torch.as_tensor(values),
                                  xi).numpy() - ys)
    jresid = np.abs(np.asarray(jspline.eval_1d(0.0, 2.0, jnp.asarray(values),
                                               jxi)) - ys)
    assert resid.max() <= jresid.max() + 1e-5
    u = rng.random(N, dtype=np.float32)
    x, p = spline.sample_1d(0.0, 2.0, torch.as_tensor(dens), cdf,
                            torch.as_tensor(u))
    jx, jp = jspline.sample_1d(0.0, 2.0, jnp.asarray(dens), jcdf,
                               jnp.asarray(u))
    close(x, jx, "sample_1d x", atol=NEWTON_ATOL)
    close(p, jp, "sample_1d pdf", atol=10 * NEWTON_ATOL)


def test_contract_of_the_reference_tests():
    """tests/test_quad_spline_qmc.py's properties, on the port."""
    x, w = quad.gauss_legendre(8)
    for k in range(16):
        assert float((w * x.double() ** k).sum()) == pytest.approx(
            (1 - (-1) ** (k + 1)) / (k + 1), abs=1e-5)
    xs = torch.linspace(-1.0, 3.0, 9)
    out = spline.eval_1d(-1.0, 3.0, 2.0 * xs ** 2 - xs + 1.0,
                         torch.linspace(-1.0, 3.0, 101))
    ref = 2.0 * torch.linspace(-1.0, 3.0, 101) ** 2 \
        - torch.linspace(-1.0, 3.0, 101) + 1.0
    assert torch.allclose(out, ref, atol=1e-4)
    vals = torch.linspace(0.5, 2.0, 33)
    cdf = spline.integrate_1d(0.0, 2.0, vals)
    ys = torch.linspace(float(cdf[0]) + 1e-3, float(cdf[-1]) - 1e-3, 50)
    back = spline.eval_1d(0.0, 2.0, cdf, spline.invert_1d(0.0, 2.0, cdf, ys))
    assert torch.allclose(back, ys, atol=1e-4)
    a = qmc.radical_inverse_scrambled(0, torch.arange(256), 1)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert len(torch.unique(torch.floor(a * 256))) == 256  # stratified
