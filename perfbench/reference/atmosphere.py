"""Plain reference of the atmosphere scenes (scenes/atmosphere.py).

An analog walk with exact free flights and exact sun transmittance:
sigma_t(z) is the linear interpolant of the grid's nodes (node i at
z = i / (D - 1), the gridvolume's trilinear lookup of a grid that is
constant across x and y), so the optical depth C(z) = int_0^z sigma_t is
piecewise quadratic and is inverted in closed form. The camera ray enters
the slab box; each step samples a collision against the box's exit:

- a collision in the medium scatters (depth + 1; a scatter that reaches
  max_depth ends the path without contributing), multiplies the weight by
  the albedo, adds the sun's contribution (Rayleigh phase x irradiance x
  transmittance to the box's exit towards the sun) and samples a new
  direction uniformly on the sphere, weighted by phase / (1 / 4 pi);
- an exit through the bottom face meets the RPV ground (``ground_z`` below
  it, across a gap of vacuum): the sun's contribution if depth + 1 <
  max_depth, then a cosine-sampled bounce weighted by pi x BRDF (depth +
  1, the path ends at max_depth);
- an exit through the top or the sides escapes (nothing lies outside).

These are the volpath estimator's terms in expectation (mitsuba's volpath
depth rules); the estimators themselves differ."""

import math

import numpy as np
import torch

from . import common


class Profile:
    """sigma_t(z) on [0, 1] and its integral C(z), from the grid's column."""

    def __init__(self, sigma_t, device, dtype):
        col = np.asarray(sigma_t, np.float64)[:, 0, 0]
        D = len(col)
        h = 1.0 / (D - 1)
        C = np.concatenate([[0.0], np.cumsum((col[:-1] + col[1:]) / 2 * h)])
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)
        self.D, self.h = D, h
        self.s, self.C = t(col), t(C)

    def _seg(self, z):
        x = torch.clamp(z, 0, 1) * (self.D - 1)
        i = torch.clamp(torch.floor(x).long(), 0, self.D - 2)
        return i, x - i.to(x.dtype)

    def sigma(self, z):
        i, f = self._seg(z)
        return self.s[i] + (self.s[i + 1] - self.s[i]) * f

    def cum(self, z):
        i, f = self._seg(z)
        a = self.s[i]
        b = self.s[i + 1] - a
        return self.C[i] + self.h * (a * f + b * f * f / 2)

    def inverse(self, c):
        """z with C(z) = c, for c in [0, C(1)]."""
        c = torch.clamp(c, min=0)
        i = torch.clamp(torch.searchsorted(self.C, c.contiguous(),
                                           right=True) - 1, 0, self.D - 2)
        a = self.h * self.s[i]
        b = self.h * (self.s[i + 1] - self.s[i]) / 2
        r = torch.clamp(c - self.C[i], min=0)
        f = 2 * r / (a + torch.sqrt(torch.clamp(a * a + 4 * b * r, min=0)))
        return (i.to(c.dtype) + torch.clamp(f, 0, 1)) * self.h

    def flight(self, p, w, t_exit, rand):
        """(collides before t_exit, distance)."""
        tau = -torch.log(1 - rand(p.shape[0]))
        wz = w[:, 2]
        flat = torch.abs(wz) < 1e-6
        c0 = self.cum(p[:, 2])
        z_exit = p[:, 2] + t_exit * wz
        wz_safe = torch.where(flat, 1.0, wz)
        tau_exit = torch.where(flat, self.sigma(p[:, 2]) * t_exit,
                               (self.cum(z_exit) - c0) / wz_safe)
        collide = tau < tau_exit
        z_c = self.inverse(c0 + tau * wz)
        t_c = torch.where(flat, tau / self.sigma(p[:, 2]),
                          (z_c - p[:, 2]) / wz_safe)
        return collide, torch.clamp(torch.minimum(t_c, t_exit), min=0)

    def transmittance(self, p, l, t_exit, rand):
        z_out = p[:, 2] + t_exit * l[2]
        return torch.exp(-(self.cum(z_out) - self.cum(p[:, 2])) / l[2])


def _box_exit(p, w, lo, hi):
    """Distance along w from p (inside the box) to its boundary, and
    whether that boundary is the bottom face."""
    big = torch.full_like(p[..., 0], 1e30)
    ts = []
    for a in range(3):
        wa = w[..., a]
        t_hi = (hi[a] - p[..., a]) / torch.where(wa > 0, wa, 1.0)
        t_lo = (lo[a] - p[..., a]) / torch.where(wa < 0, wa, -1.0)
        ts.append(torch.where(wa > 0, t_hi, torch.where(wa < 0, t_lo, big)))
    t = torch.clamp(torch.minimum(torch.minimum(ts[0], ts[1]), ts[2]), min=0)
    bottom = (w[..., 2] < 0) & (ts[2] <= torch.minimum(ts[0], ts[1]))
    return t, bottom


def render(cfg, inp, width, height, spp, seed, device, dtype=torch.float32,
           chunk=1 << 21):
    """(sums (H, W), counts (H, W)): per pixel the sum of ``spp`` radiance
    samples (in float64 behind a float32 walk) and their number."""
    sc = cfg["scene"]
    half, cx = sc["half_width"], sc["center_xy"]
    lo = (cx - half, cx - half, 0.0)
    hi = (cx + half, cx + half, 1.0)
    medium = Profile(inp["sigma_t"], device, dtype)
    sun = np.asarray(sc["sun_direction"], np.float64)
    to_sun = torch.tensor(-sun / np.linalg.norm(sun), dtype=dtype,
                          device=device)
    E, albedo, max_depth = sc["irradiance"], sc["albedo"], sc["max_depth"]
    gz = sc.get("ground_z", 0.0)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    acc = common.accumulate_dtype(dtype)
    total = torch.zeros(height * width, dtype=acc, device=device)
    rand = common.Stream(seed, device, dtype)

    def tr_sun(p, mask):
        """The sun's transmittance from p, on the lanes of ``mask``."""
        out = torch.zeros(p.shape[0], dtype=dtype, device=device)
        sel = torch.nonzero(mask).squeeze(1)
        q = p[sel]
        t, _ = _box_exit(q, to_sun.expand_as(q), lo, hi)
        out[sel] = medium.transmittance(q, to_sun, t, rand)
        return out

    n_total = height * width * spp
    for start in range(0, n_total, chunk):
        n = min(chunk, n_total - start)
        sample = start + torch.arange(n, device=device)
        pixel = sample // spp
        o, w = common.camera_rays(sc, width, height, pixel, rand(n), rand(n),
                                  dtype)
        # enter the slab box through its top face
        t_in = (hi[2] - o[:, 2]) / w[:, 2]
        p = o + t_in[:, None] * w
        alive = ((w[:, 2] < 0) & (p[:, 0] >= lo[0]) & (p[:, 0] <= hi[0])
                 & (p[:, 1] >= lo[1]) & (p[:, 1] <= hi[1]))
        beta = torch.ones(n, dtype=dtype, device=device)
        L = torch.zeros(n, dtype=acc, device=device)
        depth = torch.zeros(n, dtype=torch.int64, device=device)
        idx = torch.nonzero(alive).squeeze(1)
        p, w, beta, depth = p[idx], w[idx], beta[idx], depth[idx]
        while idx.numel():
            m = idx.numel()
            t_exit, bottom = _box_exit(p, w, lo, hi)
            collide, t_c = medium.flight(p, w, t_exit, rand)
            t = torch.where(collide, t_c, t_exit)
            p = p + t[:, None] * w
            depth = depth + 1
            # medium scatter
            scat = collide & (depth < max_depth)
            beta = torch.where(scat, beta * albedo, beta)
            cos_s = (w * to_sun).sum(-1)
            phase = 3 / (16 * math.pi) * (1 + cos_s * cos_s)
            L_add = torch.where(scat, beta * phase * E * tr_sun(p, scat), 0)
            d_new = common.uniform_sphere(rand(m), rand(m))
            mu = (w * d_new).sum(-1)
            w_scat = 4 * math.pi * 3 / (16 * math.pi) * (1 + mu * mu)
            # ground: below the box's bottom face by ground_z (vacuum)
            ground = ~collide & bottom
            gap = (gz - p[:, 2]) / torch.where(ground, w[:, 2], -1.0)
            p = torch.where(ground[:, None], p + gap[:, None] * w, p)
            g_nee = ground & (depth < max_depth)
            n_up = up.expand_as(w)
            f_sun = common.rpv(sc, n_up, -w, to_sun.expand_as(w))
            L_add = L_add + torch.where(
                g_nee, beta * f_sun * to_sun[2] * E * tr_sun(p, g_nee), 0)
            d_bounce = common.cosine_hemisphere(n_up, rand(m), rand(m))
            f_b = common.rpv(sc, n_up, -w, d_bounce)
            L.index_add_(0, idx, L_add.to(acc))
            beta = torch.where(scat, beta * w_scat,
                               torch.where(ground, beta * math.pi * f_b,
                                           beta))
            w = torch.where(scat[:, None], d_new,
                            torch.where(ground[:, None], d_bounce, w))
            keep = (scat | ground) & (depth < max_depth) & (beta > 0)
            idx, p, w, beta, depth = (idx[keep], p[keep], w[keep],
                                      beta[keep], depth[keep])
        total.index_add_(0, pixel, L)
    count = torch.full((height, width), spp, dtype=torch.int64,
                       device=device)
    return total.reshape(height, width), count
