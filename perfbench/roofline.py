"""The least time the card could take for the closest-hit queries, worked
out from the queries' rays and the scene's triangles alone: never from the
port's blocks, masks, sort or visit counters, so that a change to the
kernel or its pre-passes reads the same work.

The triangles are cut into tiles by a frozen copy of the port's tile
builder (ops/accel.py::_build_tiles_numpy as of this benchmark: a stable
sort along a 30-bit Morton curve of the centroids, tiles of 128). A ray
tests the triangles of every tile whose box its segment [mint, maxt]
crosses, FLOPS_PER_TEST FP32 operations each. Bytes: each input byte once
(rays, triangles, tile boxes) and each output byte once (t, uv, prim,
shape). Peaks: NVIDIA H100 SXM data sheet."""

import numpy as np
import torch

FP32_FLOPS = 67e12          # FP32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_TEST = 46         # one ray-triangle test (Moller-Trumbore)
TILE_K = 128
RAY_BYTES = 8 * 4           # o, d, mint, maxt
TRI_BYTES = 9 * 4 + 2 * 4   # v0, e1, e2, prim, shape
BOX_BYTES = 6 * 4
HIT_BYTES = 5 * 4           # t, u, v, prim, shape


def _expand_bits(v):
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def tiles(vertices, faces, tile_size=TILE_K):
    """(lo (T, 3), hi (T, 3), triangles per tile (T,)) of the frozen tile
    partition."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    tri = vertices[faces]
    centroid = tri.mean(axis=1)
    lo = centroid.min(0)
    ext = np.maximum(centroid.max(0) - lo, 1e-20)
    q = np.clip(((centroid - lo) / ext * 1024), 0, 1023).astype(np.uint64)
    code = ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))
    order = np.argsort(code, kind="stable")
    F = len(faces)
    T = -(-F // tile_size)
    perm = np.full(T * tile_size, -1, np.int64)
    perm[:F] = order
    pts = tri[np.maximum(perm, 0)].reshape(T, tile_size, 3, 3)
    real = (perm >= 0).reshape(T, tile_size, 1, 1)
    tile_lo = np.where(real, pts, np.float32(1e30)).min(axis=(1, 2))
    tile_hi = np.where(real, pts, np.float32(-1e30)).max(axis=(1, 2))
    count = (perm >= 0).reshape(T, tile_size).sum(1)
    return tile_lo, tile_hi, count


class Work:
    """Operations and bytes of the queries of one scene, summed."""

    def __init__(self, vertices, faces, device):
        lo, hi, count = tiles(vertices, faces)
        self.lo = torch.tensor(lo, dtype=torch.float32, device=device)
        self.hi = torch.tensor(hi, dtype=torch.float32, device=device)
        self.count = torch.tensor(count, dtype=torch.float64, device=device)
        self.n_tri = int(count.sum())
        self.tests = 0.0
        self.nbytes = 0.0
        self.queries = 0
        self.rays = 0

    def add(self, rays, chunk_elems=1 << 26):
        """One query's (N, 8) rays [o, d, mint, maxt]."""
        N = rays.shape[0]
        T = self.lo.shape[0]
        step = max(1, chunk_elems // T)
        tests = torch.zeros((), dtype=torch.float64, device=rays.device)
        for s in range(0, N, step):
            r = rays[s:s + step].to(torch.float32)
            o, d = r[:, None, 0:3], r[:, None, 3:6]
            mint, maxt = r[:, 6:7], r[:, 7:8]
            inv = 1 / torch.where(d == 0, 1e-30, d)
            ta = (self.lo[None] - o) * inv
            tb = (self.hi[None] - o) * inv
            near = torch.clamp(torch.minimum(ta, tb).amax(-1), min=mint)
            far = torch.clamp(torch.maximum(ta, tb).amin(-1), max=maxt)
            cross = (near <= far) & (maxt > mint)
            tests += (cross.to(torch.float64) * self.count[None]).sum()
        self.tests += float(tests)
        self.nbytes += N * (RAY_BYTES + HIT_BYTES) + self.n_tri * TRI_BYTES \
            + T * BOX_BYTES
        self.queries += 1
        self.rays += N

    def bound(self):
        """(least seconds, 'operations' or 'bytes')."""
        t_ops = self.tests * FLOPS_PER_TEST / FP32_FLOPS
        t_bytes = self.nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")
