"""Hierarchical2D: mip-based warping of bilinear interpolants
(core/hierarchical2d.py counterpart; Mitsuba's distr_2d.h Hierarchical2D).

A coarse-to-fine descent over mip levels maps [0,1]^2 uniforms to samples
distributed as a bilinearly interpolated 2D density, with an exact pdf (the
interpolant itself, so an envmap's value/pdf ratio stays bounded even for a
one-texel sun) and an exact inverse.

The tables are built on the host with numpy at scene build: level 0 is the
(S, H, W) vertex grid normalized so its interpolant integrates to 1 over
[0,1]^2; mip k holds the zero-padded, even-sized patch sums, mip0 the
per-patch averages. ``h2d_sample``, ``h2d_pdf`` and ``h2d_invert`` run over
a wavefront of lanes, one unrolled step per mip level.
"""

from __future__ import annotations

import numpy as np
import torch

from . import warp


def build_hierarchical2d(data: np.ndarray) -> dict:
    """Tables of a (S, H, W) or (H, W) vertex grid ((H-1) x (W-1)
    patches): 'lv0' (S, H, W) and 'mip0' .. 'mip<K-1>' (finest to
    coarsest, the coarsest at most 2x2), float32 numpy arrays."""
    data = np.asarray(data, np.float64)
    if data.ndim == 2:
        data = data[None]
    S, H, W = data.shape
    if H < 2 or W < 2:
        raise ValueError("Hierarchical2D needs at least 2x2 vertices")
    ph, pw = H - 1, W - 1
    patch = 0.25 * (data[:, :-1, :-1] + data[:, :-1, 1:]
                    + data[:, 1:, :-1] + data[:, 1:, 1:])
    total = patch.reshape(S, -1).sum(-1)
    scale = (ph * pw) / np.maximum(total, 1e-30)
    out = {"lv0": (data * scale[:, None, None]).astype(np.float32)}

    def pad_even(a):
        return np.pad(a, ((0, 0), (0, a.shape[1] % 2), (0, a.shape[2] % 2)))

    cur = pad_even(patch * scale[:, None, None])
    mips = [cur]
    while max(cur.shape[1], cur.shape[2]) > 2:
        cur = pad_even(cur[:, 0::2, 0::2] + cur[:, 0::2, 1::2]
                       + cur[:, 1::2, 0::2] + cur[:, 1::2, 1::2])
        mips.append(cur)
    for k, m in enumerate(mips):
        out[f"mip{k}"] = m.astype(np.float32)
    return out


def _mip_keys(params, prefix):
    """The mip tables' keys under ``prefix``, finest first."""
    keys = [k for k in params if k.startswith(prefix + "mip")]
    return sorted(keys, key=lambda k: int(k[len(prefix) + 3:]))


def _fetch(tab, slot, y, x):
    """tab[slot, y, x] per lane, indices clamped (out-of-range fetches occur
    only on zero-probability paths through padded levels)."""
    S, h, w = tab.shape
    y = torch.clamp(y, 0, h - 1)
    x = torch.clamp(x, 0, w - 1)
    if S == 1:
        return tab[0, y, x]
    return tab[slot.expand(y.shape), y, x]


def _corners(tab, slot, y, x):
    return (_fetch(tab, slot, y, x), _fetch(tab, slot, y, x + 1),
            _fetch(tab, slot, y + 1, x), _fetch(tab, slot, y + 1, x + 1))


def h2d_sample(params, slot, sample, prefix=""):
    """Warp (N, 2) uniforms: (position in [0,1]^2, pdf on the unit
    square). ``params`` holds lv0 and mip* under ``prefix``; ``slot`` (N,)
    is each lane's row."""
    lv0 = params[prefix + "lv0"]
    ph, pw = lv0.shape[-2] - 1, lv0.shape[-1] - 1
    sx = torch.clamp(sample[..., 0], 0.0, 1.0)
    sy = torch.clamp(sample[..., 1], 0.0, 1.0)
    ox = torch.zeros(sx.shape, dtype=torch.int64, device=sx.device)
    oy = torch.zeros_like(ox)
    for key in reversed(_mip_keys(params, prefix)):  # coarsest -> finest
        ox = ox * 2
        oy = oy * 2
        v00, v10, v01, v11 = _corners(params[key], slot, oy, ox)
        r0 = v00 + v10
        r1 = v01 + v11
        sy = sy * (r0 + r1)
        m = sy > r0
        oy = oy + m.to(torch.int64)
        sy = torch.where(m, sy - r0, sy) / torch.clamp(
            torch.where(m, r1, r0), min=1e-20)
        c0 = torch.where(m, v01, v00)
        c1 = torch.where(m, v11, v10)
        sx = sx * (c0 + c1)
        m = sx > c0
        ox = ox + m.to(torch.int64)
        sx = torch.where(m, sx - c0, sx) / torch.clamp(
            torch.where(m, c1, c0), min=1e-20)
        sx = torch.clamp(sx, 0.0, 1.0)
        sy = torch.clamp(sy, 0.0, 1.0)
    ox = torch.clamp(ox, 0, pw - 1)
    oy = torch.clamp(oy, 0, ph - 1)
    pos, pdf = warp.square_to_bilinear(*_corners(lv0, slot, oy, ox),
                                       torch.stack([sx, sy], -1))
    return torch.stack([(ox + pos[..., 0]) / pw, (oy + pos[..., 1]) / ph],
                       -1), pdf


def _patch(lv0, pos):
    """(xi, yi, fx, fy): the patch of pos and the offset within it."""
    ph, pw = lv0.shape[-2] - 1, lv0.shape[-1] - 1
    x = torch.clamp(pos[..., 0], 0.0, 1.0) * pw
    y = torch.clamp(pos[..., 1], 0.0, 1.0) * ph
    xi = torch.clamp(x.to(torch.int64), 0, pw - 1)
    yi = torch.clamp(y.to(torch.int64), 0, ph - 1)
    return xi, yi, x - xi, y - yi


def h2d_pdf(params, slot, pos, prefix=""):
    """The bilinear density at pos in [0,1]^2."""
    lv0 = params[prefix + "lv0"]
    xi, yi, fx, fy = _patch(lv0, pos)
    v00, v10, v01, v11 = _corners(lv0, slot, yi, xi)
    return ((v00 * (1 - fx) + v10 * fx) * (1 - fy)
            + (v01 * (1 - fx) + v11 * fx) * fy)


def h2d_invert(params, slot, pos, prefix=""):
    """The uniform sample that h2d_sample warps to pos: (sample, pdf)."""
    lv0 = params[prefix + "lv0"]
    ox, oy, fx, fy = _patch(lv0, pos)
    s, pdf = warp.bilinear_to_square(*_corners(lv0, slot, oy, ox),
                                     torch.stack([fx, fy], -1))
    sx = s[..., 0]
    sy = s[..., 1]
    for key in _mip_keys(params, prefix):  # finest -> coarsest
        v00, v10, v01, v11 = _corners(params[key], slot, oy & ~1, ox & ~1)
        xm = (ox & 1) != 0
        ym = (oy & 1) != 0
        r0 = v00 + v10
        r1 = v01 + v11
        c0 = torch.where(ym, v01, v00)
        c1 = torch.where(ym, v11, v10)
        sy = sy * torch.where(ym, r1, r0)
        sy = torch.where(ym, sy + r0, sy) / torch.clamp(r0 + r1, min=1e-20)
        sx = sx * torch.where(xm, c1, c0)
        sx = torch.where(xm, sx + c0, sx) / torch.clamp(c0 + c1, min=1e-20)
        sx = torch.clamp(sx, 0.0, 1.0)
        sy = torch.clamp(sy, 0.0, 1.0)
        ox = ox >> 1
        oy = oy >> 1
    return torch.stack([sx, sy], -1), pdf
