"""Plain reference of the RPV terrain (scenes/terrain.py).

Rays are intersected with the heightfield by a 2D walk over its grid cells
(Amanatides & Woo): each cell holds the mesh's two triangles
(i, j), (i+1, j), (i, j+1) and (i+1, j), (i+1, j+1), (i, j+1), tested
two-sided (Moller & Trumbore); the first cell along the ray with a hit
holds the closest hit. The path tracer follows mitsuba's path integrator
in expectation: the surface is one-sided (a hit seen from below ends the
path), every vertex of depth d with d + 1 < max_depth adds the sun's
contribution (BRDF x cosine x irradiance when a shadow ray reaches the
sky) and continues with a cosine-sampled bounce weighted by pi x BRDF.
Shading uses the triangles' face normals."""

import numpy as np
import torch

from . import common

EPS = 1e-4   # offset of spawned rays along the face normal


class Heightfield:
    def __init__(self, inp, device, dtype):
        V = np.asarray(inp["vertices"])
        n = int(round(np.sqrt(len(V))))
        t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
        self.n = n
        self.X = t(V[:, 0].reshape(n, n)[:, 0])      # x_i
        self.Y = t(V[:, 1].reshape(n, n)[0, :])      # y_j
        self.Z = t(V[:, 2].reshape(n, n))            # Z[i, j]
        self.lo = [float(V[:, a].min()) for a in range(3)]
        self.hi = [float(V[:, a].max()) for a in range(3)]
        self.cell = 2.0 / (n - 1)

    def _vertex(self, i, j):
        return torch.stack([self.X[i], self.Y[j], self.Z[i, j]], -1)

    def _tri(self, o, d, v0, v1, v2, tmin, tmax):
        e1, e2 = v1 - v0, v2 - v0
        pv = torch.cross(d, e2, dim=-1)
        det = common.dot(e1, pv)
        ok = torch.abs(det) > 1e-20
        inv = 1 / torch.where(ok, det, 1.0)
        tv = o - v0
        u = common.dot(tv, pv) * inv
        qv = torch.cross(tv, e1, dim=-1)
        v = common.dot(d, qv) * inv
        t = common.dot(e2, qv) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= tmin) & \
            (t <= tmax)
        return torch.where(hit, t, torch.inf), torch.cross(e1, e2, dim=-1)

    def intersect(self, o, d, tmax=None):
        """Closest hit of rays (o, d) on [0, tmax]: (t (inf on a miss),
        unnormalised face normal)."""
        N = o.shape[0]
        dev, dt = o.device, o.dtype
        out_t = torch.full((N,), torch.inf, dtype=dt, device=dev)
        out_n = torch.zeros(N, 3, dtype=dt, device=dev)
        tmax = (torch.full((N,), torch.inf, dtype=dt, device=dev)
                if tmax is None else tmax)
        # clip to the bounding box
        t0 = torch.zeros(N, dtype=dt, device=dev)
        t1 = tmax.clone()
        for a in range(3):
            inv = 1 / torch.where(d[:, a] == 0, 1e-30, d[:, a])
            ta = (self.lo[a] - o[:, a]) * inv
            tb = (self.hi[a] - o[:, a]) * inv
            t0 = torch.maximum(t0, torch.minimum(ta, tb))
            t1 = torch.minimum(t1, torch.maximum(ta, tb))
        idx = torch.nonzero(t0 <= t1).squeeze(1)
        o, d, t0, t1 = o[idx], d[idx], t0[idx], t1[idx]
        tlim = tmax[idx]
        h, n = self.cell, self.n
        p = o + t0[:, None] * d
        i = torch.clamp(torch.floor((p[:, 0] + 1) / h).long(), 0, n - 2)
        j = torch.clamp(torch.floor((p[:, 1] + 1) / h).long(), 0, n - 2)
        step_i = torch.where(d[:, 0] > 0, 1, -1)
        step_j = torch.where(d[:, 1] > 0, 1, -1)
        inv_x = 1 / torch.where(d[:, 0] == 0, 1e-30, d[:, 0])
        inv_y = 1 / torch.where(d[:, 1] == 0, 1e-30, d[:, 1])
        # distance to the next cell boundary in x and y, and per cell
        nx = self.X[torch.clamp(i + (step_i > 0).long(), 0, n - 1)]
        ny = self.Y[torch.clamp(j + (step_j > 0).long(), 0, n - 1)]
        tx = torch.where(d[:, 0] == 0, torch.inf, (nx - o[:, 0]) * inv_x)
        ty = torch.where(d[:, 1] == 0, torch.inf, (ny - o[:, 1]) * inv_y)
        dx = torch.abs(h * inv_x)
        dy = torch.abs(h * inv_y)
        for _ in range(2 * n + 4):
            if idx.numel() == 0:
                break
            a = self._vertex(i, j)
            b = self._vertex(i + 1, j)
            c = self._vertex(i, j + 1)
            e = self._vertex(i + 1, j + 1)
            ta, na = self._tri(o, d, a, b, c, 0.0, tlim)
            tb, nb = self._tri(o, d, b, e, c, 0.0, tlim)
            first = ta <= tb
            t_hit = torch.minimum(ta, tb)
            hit = torch.isfinite(t_hit)
            out_t[idx[hit]] = t_hit[hit]
            out_n[idx[hit]] = torch.where(first[:, None], na, nb)[hit]
            go_x = tx < ty
            t_next = torch.minimum(tx, ty)
            i = torch.where(go_x, i + step_i, i)
            j = torch.where(go_x, j, j + step_j)
            tx = torch.where(go_x, tx + dx, tx)
            ty = torch.where(go_x, ty, ty + dy)
            keep = (~hit & (i >= 0) & (i <= n - 2) & (j >= 0) & (j <= n - 2)
                    & (t_next <= t1))
            idx, o, d, t1, tlim = idx[keep], o[keep], d[keep], t1[keep], \
                tlim[keep]
            i, j, tx, ty, dx, dy = i[keep], j[keep], tx[keep], ty[keep], \
                dx[keep], dy[keep]
            step_i, step_j = step_i[keep], step_j[keep]
        return out_t, out_n


def render(cfg, inp, width, height, spp, seed, device, dtype=torch.float32,
           chunk=1 << 20):
    """(sums (H, W), counts (H, W)): per pixel the sum of ``spp`` radiance
    samples (in float64 behind a float32 walk) and their number."""
    sc = cfg["scene"]
    hf = Heightfield(inp, device, dtype)
    sun = np.asarray(sc["sun_direction"], np.float64)
    to_sun = torch.tensor(-sun / np.linalg.norm(sun), dtype=dtype,
                          device=device)
    E, max_depth = sc["irradiance"], sc["max_depth"]
    acc = common.accumulate_dtype(dtype)
    total = torch.zeros(height * width, dtype=acc, device=device)
    rand = common.Stream(seed, device, dtype)
    n_total = height * width * spp
    for start in range(0, n_total, chunk):
        n = min(chunk, n_total - start)
        sample = start + torch.arange(n, device=device)
        pixel = sample // spp
        o, d = common.camera_rays(sc, width, height, pixel, rand(n),
                                  rand(n), dtype)
        o = o.contiguous()
        beta = torch.ones(n, dtype=dtype, device=device)
        L = torch.zeros(n, dtype=acc, device=device)
        idx = torch.arange(n, device=device)
        for _depth in range(max_depth - 1):
            if idx.numel() == 0:
                break
            m = idx.numel()
            t, ng = hf.intersect(o, d)
            nrm = common.normalize(torch.where(
                torch.isfinite(t)[:, None], ng, to_sun.expand_as(ng)))
            wi = -d
            alive = torch.isfinite(t) & (common.dot(wi, nrm) > 0)
            p = o + torch.where(alive, t, 0)[:, None] * d
            spawn = p + EPS * nrm
            ls = to_sun.expand_as(p)
            cos_l = common.dot(ls, nrm)
            lit = alive & (cos_l > 0)
            t_sh, _ = hf.intersect(spawn[lit], ls[lit])
            vis = torch.zeros_like(lit)
            vis[lit] = ~torch.isfinite(t_sh)
            f_sun = common.rpv(sc, nrm, wi, ls)
            L_add = torch.where(vis, beta * f_sun * cos_l * E, 0)
            L.index_add_(0, idx, L_add.to(acc))
            wo = common.cosine_hemisphere(nrm, rand(m), rand(m))
            beta = beta * torch.pi * common.rpv(sc, nrm, wi, wo)
            keep = alive & (beta > 0)
            idx, o, d, beta = (idx[keep], spawn[keep].contiguous(),
                               wo[keep].contiguous(), beta[keep])
        total.index_add_(0, pixel, L)
    count = torch.full((height, width), spp, dtype=torch.int64,
                       device=device)
    return total.reshape(height, width), count
