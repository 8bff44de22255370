"""Chi^2 goodness-of-fit harness for sampling routines (utils/chi2.py
counterpart; mitsuba.python.chi2): histogram the outputs of a ``sample``
routine over a grid of its domain and compare them with the numerically
integrated ``pdf`` by Pearson's chi^2 test (cells pooled below a minimum
expected count, the degrees of freedom adjusted as in Numerical Recipes).

The sample and pdf passes run on the harness's device (the card unless
the caller names another); the histogram, the pdf table and the p-value
are computed on the host in float64 numpy, as in the reference. The
draws come from ``core.rng.Sampler``, so for the same seed and the same
routine the histogram is the reference's.

The adapters at the bottom wrap BSDFs, phase functions, spectra and raw
warps into the (sample_func, pdf_func) pair the test consumes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.rng import Sampler
from ..core.types import resolve_device
from .special import chi2_p_value


def _host(x):
    """A tensor or array as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class LineDomain:
    """A 1D interval."""

    def __init__(self, bounds=(0.0, 1.0)):
        self.bounds = (float(bounds[0]), float(bounds[1]))

    @property
    def dimension(self):
        return 1

    def aspect(self):
        return None

    def map_forward(self, p):
        return p[..., :1]

    def map_backward(self, p):
        return p

    def bounds_array(self):
        return np.array([self.bounds])


class PlanarDomain:
    """A 2D rectangle, [[x0, x1], [y0, y1]] (default [-1, 1]^2)."""

    def __init__(self, bounds=None):
        if bounds is None:
            bounds = np.array([[-1.0, 1.0], [-1.0, 1.0]])
        self.bounds = np.asarray(bounds, np.float64)

    @property
    def dimension(self):
        return 2

    def aspect(self):
        e = self.bounds[:, 1] - self.bounds[:, 0]
        return e[0] / e[1]

    def map_forward(self, p):
        return p

    def map_backward(self, p):
        return p

    def bounds_array(self):
        return self.bounds


class SphericalDomain:
    """Directions on S^2 as (phi, cos_theta), an area-preserving map.
    ``cos_bounds`` restricts the domain to a spherical zone, for sharply
    peaked distributions whose full-sphere cells would straddle the
    support."""

    def __init__(self, cos_bounds=(-1.0, 1.0)):
        self.cos_bounds = (float(cos_bounds[0]), float(cos_bounds[1]))

    @property
    def dimension(self):
        return 2

    def aspect(self):
        return 2.0

    def map_forward(self, p):
        """(phi, cos_theta) -> direction"""
        phi, ct = p[..., 0], p[..., 1]
        st = np.sqrt(np.maximum(0.0, 1.0 - ct * ct))
        return np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=-1)

    def map_backward(self, d):
        """direction -> (phi, cos_theta)"""
        return np.stack([np.arctan2(d[..., 1], d[..., 0]),
                         np.clip(d[..., 2], -1.0, 1.0)], axis=-1)

    def bounds_array(self):
        return np.array([[-np.pi, np.pi], list(self.cos_bounds)])


class ChiSquareTest:
    """``sample_func(sampler) -> points`` (or (points, weights); a point
    of weight 0 is left out) draws from the routine under test;
    ``pdf_func(points) -> density`` is its density with respect to the
    domain's natural measure (solid angle for SphericalDomain), called
    with float32 points on ``device``. Either may return tensors or
    arrays."""

    def __init__(self, domain, sample_func, pdf_func, sample_dim=2,
                 sample_count=1_000_000, res=101, ires=8, seed=0,
                 device=None):
        self.domain = domain
        self.sample_func = sample_func
        self.pdf_func = pdf_func
        self.sample_dim = sample_dim
        self.sample_count = int(sample_count)
        if isinstance(res, (tuple, list)):
            self.res = np.array([res[0], res[1]])
        elif domain.aspect() is None:
            self.res = np.array([res, 1])
        else:
            self.res = np.array([res, max(1, int(res / domain.aspect()))])
        self.ires = ires
        self.seed = seed
        self.device = resolve_device(device)
        self.messages = []
        self.fail = False

    # -- the histogram of the samples -------------------------------------------
    def tabulate_histogram(self):
        sampler = Sampler.seed(self.seed, torch.arange(
            self.sample_count, dtype=torch.int64, device=self.device))
        out = self.sample_func(sampler)
        if isinstance(out, tuple):
            pts, weights = out
        else:
            pts, weights = out, None
        pts = _host(pts)
        p = self.domain.map_backward(pts)
        b = self.domain.bounds_array()
        eps = 1e-6 * (b[:, 1] - b[:, 0])
        valid = np.ones(p.shape[0], bool)
        if weights is not None:
            weights = _host(weights)
            valid &= weights > 0
        for d in range(self.domain.dimension):
            valid &= np.isfinite(p[:, d])
        p = p[valid]
        w = None if weights is None else weights[valid]
        self.histogram_n_valid = int(valid.sum())
        if self.domain.dimension == 1:
            hist, _ = np.histogram(p[:, 0], bins=self.res[0],
                                   range=(b[0, 0] - eps[0], b[0, 1] + eps[0]),
                                   weights=w)
            hist = hist[None, :]
        else:
            hist, _, _ = np.histogram2d(
                p[:, 1], p[:, 0], bins=[self.res[1], self.res[0]],
                range=[(b[1, 0] - eps[1], b[1, 1] + eps[1]),
                       (b[0, 0] - eps[0], b[0, 1] + eps[0])], weights=w)
        self.histogram = hist.astype(np.float64)
        return self.histogram

    # -- the integrated pdf --------------------------------------------------------
    def _pdf_at(self, pts):
        return _host(self.pdf_func(torch.as_tensor(
            np.asarray(pts, np.float32), device=self.device)))

    def tabulate_pdf(self):
        b = self.domain.bounds_array()
        nx, ny = int(self.res[0]), int(self.res[1])
        ir = self.ires
        # composite Simpson: an odd number of nodes a cell
        k = ir if ir % 2 == 1 else ir + 1

        def cell_nodes(lo, hi, n_cells):
            edges = np.linspace(lo, hi, n_cells + 1)
            return np.array([np.linspace(edges[i], edges[i + 1], k)
                             for i in range(n_cells)])  # (n_cells, k)

        xs = cell_nodes(b[0, 0], b[0, 1], nx)
        if self.domain.dimension == 1:
            vals = self._pdf_at(xs.reshape(-1, 1)).reshape(nx, k)
            wsimp = _simpson_weights(k) * (xs[0, -1] - xs[0, 0])
            pdf = (vals * wsimp).sum(-1)[None, :]
        else:
            ys = cell_nodes(b[1, 0], b[1, 1], ny)
            # the full grid of points: (ny, nx, k, k, dim)
            gx = np.broadcast_to(xs[None, :, None, :], (ny, nx, k, k))
            gy = np.broadcast_to(ys[:, None, :, None], (ny, nx, k, k))
            grid = np.stack([gx, gy], axis=-1).reshape(-1, 2)
            vals = self._pdf_at(self.domain.map_forward(grid)).reshape(
                ny, nx, k, k)
            wx = _simpson_weights(k) * (xs[0, -1] - xs[0, 0])
            wy = _simpson_weights(k) * (ys[0, -1] - ys[0, 0])
            pdf = np.einsum("yxij,i,j->yx", vals, wy, wx)
        self.pdf = pdf * self.sample_count
        return self.pdf

    # -- the test --------------------------------------------------------------------
    def run(self, significance_level=0.01, test_count=1, min_expected=5.0):
        """Pearson's chi^2 with cell pooling; the significance Sidak
        corrected when this is one of ``test_count`` runs."""
        self.tabulate_histogram()
        self.tabulate_pdf()
        obs = self.histogram.ravel()
        exp = self.pdf.ravel()

        if abs(exp.sum() - obs.sum()) > max(exp.sum(), obs.sum()) * 0.05 + 100:
            self._log(f"sum mismatch: expected {exp.sum():.1f}, "
                      f"observed {obs.sum():.1f}")

        order = np.argsort(exp)
        obs, exp = obs[order], exp[order]
        # pool the cells of low expected count
        pooled_obs = pooled_exp = 0.0
        chi2 = 0.0
        dof = 0
        for o, e in zip(obs, exp):
            if e == 0:
                if o > self.sample_count * 1e-5:
                    self._log(f"expected 0 but observed {o}")
                    self.fail = True
                continue
            if e < min_expected or 0 < pooled_exp < min_expected:
                pooled_obs += o
                pooled_exp += e
                if pooled_exp >= min_expected:
                    chi2 += (pooled_obs - pooled_exp) ** 2 / pooled_exp
                    dof += 1
                    pooled_obs = pooled_exp = 0.0
            else:
                chi2 += (o - e) ** 2 / e
                dof += 1
        dof -= 1
        if dof <= 0:
            self._log("degrees of freedom <= 0")
            self.fail = True
            return not self.fail

        self.p_value = chi2_p_value(chi2, dof)
        alpha = 1.0 - (1.0 - significance_level) ** (1.0 / test_count)
        if self.p_value < alpha:
            self._log(
                f"rejected the null hypothesis (p-value = {self.p_value:.5g}, "
                f"significance = {alpha:.5g}, chi2 = {chi2:.4g}, dof = {dof})")
            self.fail = True
        return not self.fail

    def _log(self, msg):
        self.messages.append(msg)


def _simpson_weights(k):
    """Composite Simpson weights over k (odd) equally spaced nodes on
    [0, 1]."""
    if k % 2 != 1:
        raise ValueError("Simpson's rule needs an odd node count")
    w = np.ones(k)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    return w / (3.0 * (k - 1))


# --- adapters ---------------------------------------------------------------------

def WarpAdapter(warp_fn, pdf_fn, sample_dim=2):
    """A square_to_X warp and its pdf."""

    def sample_func(sampler):
        sampler, s = sampler.next_2d()
        return warp_fn(s)

    return sample_func, pdf_fn


def _probe_scene(entry, variant, device):
    """A 2x2-film scene around one rectangle ``entry``."""
    from ..core.types import Variant
    from ..scene import load_dict

    return load_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "film": {"width": 2, "height": 2}},
        "rect": {"type": "rectangle", **entry},
    }, variant or Variant("rgb"), device=device)


def BSDFAdapter(bsdf_dict, wi=(0.3, -0.2, 0.9), variant=None, device=None):
    """(sample_func, pdf_func) of a BSDF kind in its local shading frame
    (the world frame of the canonical rectangle), at a fixed ``wi``. Delta
    lobes are left out of the histogram by their sampled_type flags: the
    test compares the smooth component."""
    from .. import bsdfs
    from ..bsdfs import common as bc
    from ..core.frame import Frame
    from ..render.records import SurfaceInteraction

    scene = _probe_scene({"bsdf": bsdf_dict}, variant, device)
    dev = scene.bsphere_center.device
    wi = np.asarray(wi, np.float64)
    wi = torch.as_tensor((wi / np.linalg.norm(wi)).astype(np.float32),
                         device=dev)
    spectral = scene.config.variant.is_spectral

    def make_si(n):
        z = torch.zeros(n, device=dev)
        up = torch.zeros(n, 3, device=dev)
        up[:, 2] = 1.0
        dp_du = torch.zeros(n, 3, device=dev)
        dp_du[:, 0] = 1.0
        dp_dv = torch.zeros(n, 3, device=dev)
        dp_dv[:, 1] = 1.0
        return SurfaceInteraction(
            t=torch.ones(n, device=dev), p=torch.zeros(n, 3, device=dev),
            n=up, sh_frame=Frame.from_normal(up),
            uv=torch.full((n, 2), 0.5, device=dev),
            prim_uv=torch.zeros(n, 2, device=dev), dp_du=dp_du, dp_dv=dp_dv,
            wi=wi.expand(n, 3), time=z,
            prim_index=torch.zeros(n, dtype=torch.int32, device=dev),
            shape_index=torch.zeros(n, dtype=torch.int32, device=dev),
            wavelengths=(torch.full((n, 4), 550.0, device=dev) if spectral
                         else torch.zeros(n, 0, device=dev)))

    def bsdf_idx(n):
        return scene.shape_bsdf[torch.zeros(n, dtype=torch.int64,
                                            device=dev)]

    def sample_func(sampler):
        n = sampler.k0.shape[0]
        sampler, s1 = sampler.next_1d()
        sampler, s2 = sampler.next_2d()
        active = torch.ones(n, dtype=torch.bool, device=dev)
        bs, w = bsdfs.bsdf_sample(scene, bsdf_idx(n), make_si(n), s1, s2,
                                  active)
        smooth = (bs.sampled_type & bc.Delta) == 0
        ok = (bs.pdf > 0) & smooth & torch.any(w > 0, dim=-1)
        return bs.wo, ok.to(torch.float32)

    def pdf_func(pts):
        n = pts.shape[0]
        active = torch.ones(n, dtype=torch.bool, device=dev)
        _, pdf = bsdfs.bsdf_eval_pdf(scene, bsdf_idx(n), make_si(n), pts,
                                     active)
        return pdf

    return sample_func, pdf_func


def PhaseFunctionAdapter(phase_dict, wi=(0.0, 0.0, 1.0), variant=None,
                         device=None):
    """(sample_func, pdf_func) of a phase-function kind for rays along
    ``wi``."""
    from ..phase import phase_eval, phase_sample

    scene = _probe_scene({"interior": {"type": "homogeneous", "sigma_t": 1.0,
                                       "phase": phase_dict}}, variant, device)
    dev = scene.bsphere_center.device
    ray_d = np.asarray(wi, np.float64)
    ray_d = torch.as_tensor((ray_d / np.linalg.norm(ray_d)).astype(
        np.float32), device=dev)

    def sample_func(sampler):
        n = sampler.k0.shape[0]
        sampler, s1 = sampler.next_1d()
        sampler, s2 = sampler.next_2d()
        wo, _pdf = phase_sample(scene, torch.zeros(n, dtype=torch.int64,
                                                   device=dev),
                                ray_d.expand(n, 3), s1, s2)
        return wo

    def pdf_func(pts):
        n = pts.shape[0]
        return phase_eval(scene, torch.zeros(n, dtype=torch.int64,
                                             device=dev),
                          -ray_d.expand(n, 3), pts)

    return sample_func, pdf_func


def SpectrumAdapter(sample_fn, pdf_fn):
    """A 1D wavelength sampler ``sample_fn(s) -> (wavelengths, weight)``
    and its pdf."""

    def sample_func(sampler):
        sampler, s = sampler.next_1d()
        lam, _w = sample_fn(s)
        return _host(lam)[..., None]

    def pdf_func(pts):
        return pdf_fn(pts[..., 0])

    return sample_func, pdf_func
