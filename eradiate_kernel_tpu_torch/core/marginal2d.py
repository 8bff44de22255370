"""Marginal sample warping of 2D distributions with linear interpolation
and an optional dependence on conditioning parameters
(core/marginal2d.py counterpart; Mitsuba's distr_2d.h Marginal2D with
Continuous=true, the measured BSDF's warps).

The CDF tables are built once on the host with numpy (``build_continuous``,
every parameter slice at once); ``eval``, ``sample`` and ``invert`` run over
a wavefront of lanes. Conditioning parameters interpolate multilinearly
over up to 2^D corner slices of the parameter grid, and the CDF inversions
are the reference's fixed-step binary search (``_bisect``): the interval it
picks on a tie, or on a row with zero-width intervals, decides the sample,
so the port takes the same steps rather than ``torch.searchsorted``.

Every table passed in has its true shape (the caller slices away any
padding of the stacked registry first).
"""

from __future__ import annotations

import numpy as np
import torch

from .math import safe_sqrt

_EPS = 1e-7
_ONE_MINUS_EPS = 1.0 - 1e-6


def build_continuous(data: np.ndarray, normalize: bool = True) -> dict:
    """Conditional and marginal CDF tables of a (*param_res, h, w) grid:
    float32 numpy arrays data (*P, h, w), cond_cdf (*P, h, w-1) and
    marg_cdf (*P, h-1). With ``normalize`` each slice is rescaled so its
    bilinear interpolant integrates to 1 over [0,1]^2."""
    data = np.asarray(data, np.float64)
    h, w = data.shape[-2:]
    if h < 2 or w < 2:
        raise ValueError("Marginal2D needs at least a 2x2 grid")
    scale_x = 0.5 / (w - 1)
    scale_y = 0.5 / (h - 1)
    cond = np.cumsum(scale_x * (data[..., :-1] + data[..., 1:]), axis=-1)
    csum = cond[..., -1]
    marg = np.cumsum(scale_y * (csum[..., :-1] + csum[..., 1:]), axis=-1)
    if normalize:
        norm = 1.0 / np.maximum(marg[..., -1], 1e-30)
        data = data * norm[..., None, None]
        cond = cond * norm[..., None, None]
        marg = marg * norm[..., None]
    return {"data": data.astype(np.float32),
            "cond_cdf": cond.astype(np.float32),
            "marg_cdf": marg.astype(np.float32)}


def _masked(active, x):
    """x where ``active`` (a bool or a lane mask), else 0."""
    return torch.where(torch.as_tensor(active, device=x.device), x, 0.0)


def _lerp(a, b, t):
    return a * (1.0 - t) + b * t


def _interp_corners(param_values, params):
    """The multilinear interpolation over the parameter grid: ([flat slice
    indices], [weights]), up to 2^D entries of the lanes' shape."""
    offsets = [None]  # None stands for a scalar 0
    weights = [1.0]
    for v, p in zip(param_values, params):
        n = v.shape[0]
        if n == 1:
            continue
        p = torch.minimum(torch.maximum(p, v[0]), v[-1])
        i = torch.clamp(torch.searchsorted(v, p.contiguous(), right=True) - 1,
                        0, n - 2)
        lo = v[i]
        hi = v[i + 1]
        w1 = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-20), 0.0, 1.0)
        new_o, new_w = [], []
        for o, wgt in zip(offsets, weights):
            base = i if o is None else o * n + i
            new_o += [base, base + 1]
            new_w += [wgt * (1.0 - w1), wgt * w1]
        offsets, weights = new_o, new_w
    return offsets, weights


def _make_fetch(table, n_slice, offsets, weights):
    """fetch(idx): the parameter-interpolated lookup of ``table`` at the
    in-slice flat index ``idx``."""
    flat = table.reshape(-1)

    def fetch(idx):
        out = None
        for o, w in zip(offsets, weights):
            j = idx if o is None else o * n_slice + idx
            val = w * flat[j]
            out = val if out is None else out + val
        return out

    return fetch


def _bisect(fetch, n, value):
    """The first index i in [0, n-1] with fetch(i) >= value: a fixed
    ceil(log2 n) + 1 steps of binary search."""
    lo = torch.zeros(value.shape, dtype=torch.int64, device=value.device)
    hi = torch.full_like(lo, n - 1)
    for _ in range(max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)):
        mid = (lo + hi) >> 1
        pred = fetch(mid) < value
        lo = torch.where(pred, torch.clamp(mid + 1, max=n - 1), lo)
        hi = torch.where(pred, hi, mid)
    return lo


def _sample_segment(s, inv_width, v0, v1):
    """Invert the CDF of one linear segment."""
    non_const = torch.abs(v0 - v1) > 1e-4 * (v0 + v1)
    divisor = torch.where(non_const, v0 - v1, v0 + v1)
    s = s * (2.0 * inv_width)
    s = torch.where(non_const, v0 - safe_sqrt(v0 * v0 + s * (v1 - v0)), s)
    ok = divisor != 0.0
    return torch.where(ok, s / torch.where(ok, divisor, 1.0), s)


def _invert_segment(s, width, v0, v1):
    """The CDF of one linear segment."""
    return s * _lerp(v0, v1, 0.5 * s) * width


def _corner_values(data, pos):
    """The bilinear patch of pos (x the column axis, y the row axis) and
    the offset within it: (px, py, fx, fy)."""
    h, w = data.shape[-2:]
    x = torch.clamp(pos[..., 0], 0.0, 1.0) * (w - 1)
    y = torch.clamp(pos[..., 1], 0.0, 1.0) * (h - 1)
    px = torch.clamp(x.to(torch.int64), 0, w - 2)
    py = torch.clamp(y.to(torch.int64), 0, h - 2)
    return px, py, x - px, y - py


def _fetches(tables, param_values, params):
    data = tables["data"]
    h, w = data.shape[-2:]
    offs, wts = _interp_corners(param_values, params)
    fetch = {"data": _make_fetch(data, h * w, offs, wts)}
    if "cond_cdf" in tables:
        fetch["cond"] = _make_fetch(tables["cond_cdf"], h * (w - 1), offs,
                                    wts)
        fetch["marg"] = _make_fetch(tables["marg_cdf"], h - 1, offs, wts)
    return h, w, fetch


def eval(tables, pos, param_values=(), params=(), active=True):
    """The density at pos in [0,1]^2 (for tables built without normalize,
    the raw bilinear interpolant)."""
    h, w, fetch = _fetches(tables, param_values, params)
    fd = fetch["data"]
    px, py, fx, fy = _corner_values(tables["data"], pos)
    idx = py * w + px
    out = _lerp(_lerp(fd(idx), fd(idx + 1), fx),
                _lerp(fd(idx + w), fd(idx + w + 1), fx), fy)
    return _masked(active, out)


def sample(tables, sample2, param_values=(), params=(), active=True,
           normalized=True):
    """Warp (..., 2) uniforms by the continuous marginal scheme: ((..., 2)
    position, density)."""
    h, w, fetch = _fetches(tables, param_values, params)
    fd, fc, fm = fetch["data"], fetch["cond"], fetch["marg"]
    n_marg = h - 1
    sx = torch.clamp(sample2[..., 0], _EPS, _ONE_MINUS_EPS)
    sy = torch.clamp(sample2[..., 1], _EPS, _ONE_MINUS_EPS)
    if not normalized:
        sy = sy * fm(torch.full(sx.shape, n_marg - 1, dtype=torch.int64,
                                device=sx.device))

    # the row, from the marginal CDF
    row = torch.clamp(_bisect(fm, n_marg, sy), max=h - 2)
    sy = sy - torch.where(row > 0, fm(torch.clamp(row - 1, min=0)), 0.0)
    off_cond = row * (w - 1)
    r0 = fc(off_cond + (w - 2))
    r1 = fc(off_cond + (w - 1) + (w - 2))
    sy = _sample_segment(sy, float(h - 1), r0, r1)

    # the column, from the row's interpolated conditional CDF
    sx = sx * _lerp(r0, r1, sy)

    def fetch_cond(i):
        return _lerp(fc(off_cond + i), fc(off_cond + (w - 1) + i), sy)

    col = torch.clamp(_bisect(fetch_cond, w - 1, sx), max=w - 2)
    sx = sx - torch.where(col > 0, fetch_cond(torch.clamp(col - 1, min=0)),
                          0.0)
    idx = row * w + col
    c0 = _lerp(fd(idx), fd(idx + w), sy)
    c1 = _lerp(fd(idx + 1), fd(idx + w + 1), sy)
    sx = _sample_segment(sx, float(w - 1), c0, c1)
    pos = torch.stack([(col + sx) / (w - 1), (row + sy) / (h - 1)], dim=-1)
    return pos, _masked(active, _lerp(c0, c1, sx))


def invert(tables, pos, param_values=(), params=(), active=True,
           normalized=True):
    """The inverse of ``sample``: pos in [0,1]^2 back to the uniform
    variate, with the density at pos."""
    h, w, fetch = _fetches(tables, param_values, params)
    fd, fc, fm = fetch["data"], fetch["cond"], fetch["marg"]
    n_marg = h - 1
    px, py, fx, fy = _corner_values(tables["data"], pos)
    idx = py * w + px
    c0 = _lerp(fd(idx), fd(idx + w), fy)
    c1 = _lerp(fd(idx + 1), fd(idx + w + 1), fy)
    pdf = _lerp(c0, c1, fx)
    sx = _invert_segment(fx, 1.0 / (w - 1), c0, c1)
    off_cond = py * (w - 1)

    def fetch_cond(i):
        return _lerp(fc(off_cond + i), fc(off_cond + (w - 1) + i), fy)

    sx = sx + torch.where(px > 0, fetch_cond(torch.clamp(px - 1, min=0)),
                          0.0)
    r0 = fc(off_cond + (w - 2))
    r1 = fc(off_cond + (w - 1) + (w - 2))
    total = _lerp(r0, r1, fy)
    ok = total > 0
    sx = torch.where(ok, sx / torch.where(ok, total, 1.0), sx)
    sy = _invert_segment(fy, 1.0 / (h - 1), r0, r1)
    sy = sy + torch.where(py > 0, fm(torch.clamp(py - 1, min=0)), 0.0)
    if not normalized:
        tot_m = fm(torch.full_like(px, n_marg - 1))
        okm = tot_m > 0
        sy = torch.where(okm, sy / torch.where(okm, tot_m, 1.0), sy)
    return torch.stack([sx, sy], dim=-1), _masked(active, pdf)

