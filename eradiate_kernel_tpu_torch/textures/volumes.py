"""3D volume textures (textures/volumes.py counterpart): constvolume and
trilinear gridvolume.

Two trilinear paths, chosen by the grid's voxel count as the reference
chooses them:
  - grids of at most EINSUM_MAX_VOXELS voxels: the factorized one-hot
    contraction of ``_trilinear_einsum``, contracted one axis at a time
    (never a lanes x D*H*W intermediate), in full float32;
  - larger grids: one packed 8-corner row per lane (``packed_corners``,
    built once per scene at load) fetched through the ``grid_gather``
    kernel (ops/gather.py), then the trilinear combine ``_lerp8``.
"""

from __future__ import annotations

import torch

from ..core.transform import Transform
from ..ops import gather

# voxel-count threshold between the einsum path and the packed-row gather
# path (the reference's EINSUM_MAX_VOXELS)
EINSUM_MAX_VOXELS = 4096


def _axis_weights(g, n_axis):
    """(..., n_axis) linear-interpolation weights along one grid axis:
    (1 - f) at i0 and f at i0 + 1."""
    i0 = torch.clamp(g.to(torch.int32), 0, max(n_axis - 2, 0))
    f = (g - i0)[..., None]
    ar = torch.arange(n_axis, device=g.device)
    w = torch.where(ar == i0[..., None], 1.0 - f, 0.0)
    i1 = torch.clamp(i0 + 1, max=n_axis - 1)
    return torch.where(ar == i1[..., None], w + f, w)


def _corner_setup(grid_shape, vslot, pl):
    """Flat indices of the 8 corner voxels (zyx-binary order c000..c111)
    and the three fractional weights. grid_shape: (S, D, H, W)."""
    S, D, H, W = grid_shape
    gx = torch.clamp(pl[..., 0], 0.0, 1.0) * (W - 1)
    gy = torch.clamp(pl[..., 1], 0.0, 1.0) * (H - 1)
    gz = torch.clamp(pl[..., 2], 0.0, 1.0) * (D - 1)
    x0 = torch.clamp(gx.to(torch.int32), 0, max(W - 2, 0))
    y0 = torch.clamp(gy.to(torch.int32), 0, max(H - 2, 0))
    z0 = torch.clamp(gz.to(torch.int32), 0, max(D - 2, 0))
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    fz = (gz - z0)[..., None]
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    z1 = torch.clamp(z0 + 1, max=D - 1)
    base = vslot * (D * H * W)
    idx = [base + (z * H + y) * W + x
           for z in (z0, z1) for y in (y0, y1) for x in (x0, x1)]
    return idx, fx, fy, fz


def _lerp8(c, fx, fy, fz):
    """Trilinear combine of 8 corner values in _corner_setup order."""
    c00 = c[0] * (1 - fx) + c[1] * fx
    c01 = c[2] * (1 - fx) + c[3] * fx
    c10 = c[4] * (1 - fx) + c[5] * fx
    c11 = c[6] * (1 - fx) + c[7] * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def packed_corners(grid):
    """(S, D, H, W, C) -> (S*D*H*W, 8*C): every voxel's trilinear
    neighbourhood in one row (c000..c111 in _corner_setup order, +1
    neighbours edge-clamped like min(i + 1, n - 1))."""
    S, D, H, W, C = grid.shape

    def shift(dz, dy, dx):
        g = grid
        if dz:
            g = torch.cat([g[:, 1:], g[:, -1:]], dim=1)
        if dy:
            g = torch.cat([g[:, :, 1:], g[:, :, -1:]], dim=2)
        if dx:
            g = torch.cat([g[:, :, :, 1:], g[:, :, :, -1:]], dim=3)
        return g

    corners = [shift(z, y, x) for z in (0, 1) for y in (0, 1) for x in (0, 1)]
    return torch.stack(corners, -2).reshape(S * D * H * W, 8 * C).contiguous()


def packed_corners_of(volumes):
    """The packed table of a scene's gridvolume rows when they take the
    gather path, else None (built once per scene, at load)."""
    params = volumes.get("gridvolume")
    if params is None:
        return None
    S, D, H, W, C = params["grid"].shape
    if D * H * W <= EINSUM_MAX_VOXELS:
        return None
    return packed_corners(params["grid"])


def _trilinear_gather(packed, grid_shape, vslot, pl):
    """Packed-neighbourhood gather and lerp: one 8C-wide row per lane (its
    8 corner voxels) through the grid_gather kernel."""
    S, D, H, W, C = grid_shape
    idx, fx, fy, fz = _corner_setup((S, D, H, W), vslot, pl)
    rows = gather.gather_rows(packed, idx[0].reshape(-1))
    rows = rows.reshape(idx[0].shape + (8 * C,))
    return _lerp8([rows[..., k * C:(k + 1) * C] for k in range(8)],
                  fx, fy, fz)


def _trilinear_einsum(grid, vslot, pl):
    """Factorized trilinear interpolation: per-axis weight vectors
    contracted against the grid one axis at a time, the longest (z) first
    so that the largest intermediate is lanes x S*H*W*C, in float32 with
    TF32 off."""
    S, D, H, W, C = grid.shape
    wx = _axis_weights(torch.clamp(pl[..., 0], 0.0, 1.0) * (W - 1), W)
    wy = _axis_weights(torch.clamp(pl[..., 1], 0.0, 1.0) * (H - 1), H)
    wz = _axis_weights(torch.clamp(pl[..., 2], 0.0, 1.0) * (D - 1), D)
    batch = pl.shape[:-1]
    n = wz.reshape(-1, D).shape[0]
    g = grid.permute(1, 0, 2, 3, 4).reshape(D, S * H * W * C)
    t = torch.matmul(wz.reshape(n, D), g).reshape(n, S, H, W, C)
    t = torch.einsum("nh,nshwc->nswc", wy.reshape(n, H), t)
    t = torch.einsum("nw,nswc->nsc", wx.reshape(n, W), t)
    ws = (torch.arange(S, device=pl.device) == vslot.reshape(n, 1)).to(
        grid.dtype)
    return torch.einsum("ns,nsc->nc", ws, t).reshape(batch + (C,))


def _apply_wrap(params, vslot, pl):
    """Per-slot wrap mode: 0 = clamp (outside lookups masked to zero),
    1 = repeat, 2 = mirror. Returns (wrapped local coords, inside mask)."""
    wrap = params["wrap"][vslot][..., None]
    rep = pl - torch.floor(pl)
    half = 0.5 * pl - torch.floor(0.5 * pl)
    mir = 1.0 - torch.abs(2.0 * half - 1.0)
    pl_w = torch.where(wrap == 1, rep, torch.where(wrap == 2, mir, pl))
    inside = torch.all((pl_w >= 0.0) & (pl_w <= 1.0), dim=-1)
    return pl_w, inside


def volume_eval(scene, vol_idx, p):
    """Evaluate volumes per lane at world position p -> (..., nc)."""
    cfg = scene.config
    nc = cfg.variant.n_channels
    vkind = scene.vol_kind[vol_idx]
    vslot = scene.vol_slot[vol_idx]
    out = torch.zeros(vkind.shape + (nc,), device=p.device)
    for k, kind in enumerate(cfg.volume_kinds):
        m = vkind == k
        slot = torch.where(m, vslot, 0)  # other kinds' lanes read row 0
        params = scene.volumes[kind]
        if kind == "constvolume":
            v = params["value"][slot]
            if v.shape[-1] == 1:
                v = v.expand(v.shape[:-1] + (nc,))
            elif v.shape[-1] != nc:
                v = torch.mean(v, -1, keepdim=True).expand(
                    v.shape[:-1] + (nc,))
        elif kind == "gridvolume":
            tw = Transform(m=params["w2l_m"][slot],
                           inv_t=params["w2l_it"][slot])
            pl, inside = _apply_wrap(params, slot,
                                     tw.transform_affine_point(p))
            grid = params["grid"]
            S, D, H, W, C = grid.shape
            if D * H * W > EINSUM_MAX_VOXELS:
                c = _trilinear_gather(scene.vol_packed, grid.shape, slot, pl)
            else:
                c = _trilinear_einsum(grid, slot, pl)
            c = torch.where(inside[..., None], c, 0.0)
            if C == 1:
                v = c.expand(c.shape[:-1] + (nc,))
            elif C == nc:
                v = c
            else:
                v = torch.mean(c, -1, keepdim=True).expand(
                    c.shape[:-1] + (nc,))
        else:
            raise NotImplementedError(
                f"volume {kind!r}: comes with slice 6 of the port")
        out = torch.where(m[..., None], v, out)
    return out

