"""1D distributions (core/distr.py counterpart; Mitsuba's distr_1d.h).

The CDFs are built once (numpy where the reference uses it); ``sample``
and the pdfs run over a wavefront of lanes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiscreteDistribution:
    """A discrete pmf over {0 .. n-1}."""

    pmf: torch.Tensor    # (n,)
    cdf: torch.Tensor    # (n,) inclusive cumsum, unnormalized
    total: torch.Tensor  # ()

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_pmf(pmf, device="cpu"):
        pmf = torch.as_tensor(np.asarray(pmf, np.float32), device=device)
        cdf = torch.cumsum(pmf, 0)
        return DiscreteDistribution(pmf=pmf, cdf=cdf, total=cdf[-1])

    @property
    def n(self):
        return self.pmf.shape[0]

    def eval_pmf_normalized(self, index):
        return self.pmf[index] / self.total

    def sample(self, xi):
        """xi in [0, 1) -> an index."""
        idx = torch.searchsorted(self.cdf, (xi * self.total).contiguous(),
                                 right=True)
        return torch.clamp(idx, 0, self.n - 1)

    def sample_pmf(self, xi):
        idx = self.sample(xi)
        return idx, self.pmf[idx] / self.total

    def sample_reuse(self, xi):
        """An index and xi rescaled for reuse."""
        idx = self.sample(xi)
        cdf_lo = torch.where(idx > 0, self.cdf[torch.clamp(idx - 1, min=0)],
                             0.0)
        rescaled = ((xi * self.total - cdf_lo)
                    / torch.clamp(self.pmf[idx], min=1e-30))
        return idx, torch.clamp(rescaled, 0.0, 1.0 - 1e-7)


def _solve_segment(u_loc, v0, a, lin):
    """t of v0 t + a t^2 = u_loc (linear where ``lin``)."""
    t_lin = u_loc / torch.clamp(v0, min=1e-30)
    disc = torch.clamp(v0 * v0 + 4.0 * a * u_loc, min=0.0)
    t_quad = 2.0 * u_loc / torch.clamp(v0 + torch.sqrt(disc), min=1e-30)
    return torch.where(lin, t_lin, t_quad)


def _segment(cdf, u, n):
    """The segment of ``u`` in the node CDF and u's offset within it."""
    seg = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True),
                      0, n - 2)
    cdf_lo = torch.where(seg > 0, cdf[torch.clamp(seg - 1, min=0)], 0.0)
    return seg, u - cdf_lo


@dataclasses.dataclass(frozen=True)
class ContinuousDistribution:
    """A piecewise-linear pdf on a regular grid over
    [range_min, range_max]."""

    pdf_vals: torch.Tensor  # (n,) unnormalized node values
    cdf: torch.Tensor       # (n-1,) integral up to node i+1
    integral: torch.Tensor  # ()
    range_min: float
    range_max: float

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_pdf(values, range_min, range_max, device="cpu"):
        v = np.asarray(values, np.float64)
        dx = (range_max - range_min) / (v.shape[0] - 1)
        cdf = np.cumsum(0.5 * (v[1:] + v[:-1]) * dx)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=device)
        return ContinuousDistribution(
            pdf_vals=f32(v), cdf=f32(cdf), integral=f32(cdf[-1]),
            range_min=float(range_min), range_max=float(range_max))

    @property
    def n(self):
        return self.pdf_vals.shape[0]

    def _dx(self):
        return (self.range_max - self.range_min) / (self.n - 1)

    def eval_pdf(self, x):
        """The unnormalized linear interpolation of the node values."""
        t = (x - self.range_min) / self._dx()
        i = torch.clamp(torch.floor(t).to(torch.int64), 0, self.n - 2)
        f = t - i
        val = self.pdf_vals[i] * (1 - f) + self.pdf_vals[i + 1] * f
        inside = (x >= self.range_min) & (x <= self.range_max)
        return torch.where(inside, val, 0.0)

    def eval_pdf_normalized(self, x):
        return self.eval_pdf(x) / self.integral

    def sample(self, xi):
        """An inverse-CDF sample x."""
        seg, u_loc = _segment(self.cdf, xi * self.integral, self.n)
        dx = self._dx()
        v0 = self.pdf_vals[seg]
        slope = (self.pdf_vals[seg + 1] - v0) / dx
        lin = torch.abs(slope) < 1e-12 * torch.clamp(v0, min=1.0)
        t = _solve_segment(u_loc, v0, 0.5 * slope, lin)
        return self.range_min + seg * dx + torch.clamp(t, 0.0, dx)

    def sample_pdf(self, xi):
        x = self.sample(xi)
        return x, self.eval_pdf_normalized(x)


@dataclasses.dataclass(frozen=True)
class IrregularContinuousDistribution:
    """A piecewise-linear pdf on an irregular node grid."""

    nodes: torch.Tensor     # (n,)
    pdf_vals: torch.Tensor  # (n,)
    cdf: torch.Tensor       # (n-1,)
    integral: torch.Tensor  # ()

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_pdf(nodes, values, device="cpu"):
        x = np.asarray(nodes, np.float64)
        v = np.asarray(values, np.float64)
        cdf = np.cumsum(0.5 * (v[1:] + v[:-1]) * np.diff(x))
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=device)
        return IrregularContinuousDistribution(
            nodes=f32(x), pdf_vals=f32(v), cdf=f32(cdf),
            integral=f32(cdf[-1]))

    @property
    def n(self):
        return self.nodes.shape[0]

    def eval_pdf(self, x):
        i = torch.clamp(torch.searchsorted(self.nodes, x.contiguous(),
                                           right=True) - 1, 0, self.n - 2)
        x0, x1 = self.nodes[i], self.nodes[i + 1]
        f = (x - x0) / torch.clamp(x1 - x0, min=1e-30)
        val = self.pdf_vals[i] * (1 - f) + self.pdf_vals[i + 1] * f
        inside = (x >= self.nodes[0]) & (x <= self.nodes[-1])
        return torch.where(inside, val, 0.0)

    def eval_pdf_normalized(self, x):
        return self.eval_pdf(x) / self.integral

    def sample(self, xi):
        seg, u_loc = _segment(self.cdf, xi * self.integral, self.n)
        x0 = self.nodes[seg]
        dx = self.nodes[seg + 1] - x0
        v0 = self.pdf_vals[seg]
        slope = (self.pdf_vals[seg + 1] - v0) / torch.clamp(dx, min=1e-30)
        lin = torch.abs(slope) * dx < 1e-9 * torch.clamp(v0, min=1e-9)
        t = _solve_segment(u_loc, v0, 0.5 * slope, lin)
        return x0 + torch.minimum(torch.clamp(t, min=0.0), dx)

    def sample_pdf(self, xi):
        x = self.sample(xi)
        return x, self.eval_pdf_normalized(x)
