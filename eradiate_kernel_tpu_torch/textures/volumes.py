"""3D volume textures (textures/volumes.py counterpart): constvolume,
trilinear gridvolume, nearest-filter gridvolume (``gridvolume_nearest``)
and the spectral variant's ``gridvolume_srgb`` (an rgb grid packed at
scene build as [rgb2spec coefficients, scale] a voxel) and
``gridvolume_spectral`` (S channels at S wavelengths).

Two trilinear paths, chosen by the grid's voxel count as the reference
chooses them:
  - grids of at most EINSUM_MAX_VOXELS voxels: the factorized one-hot
    contraction of ``_trilinear_einsum``, contracted one axis at a time
    (never a lanes x D*H*W intermediate), in full float32;
  - larger grids: one packed 8-corner row per lane (``packed_corners``,
    a table derived from the grid, built at load and rebuilt with the
    grid's values by scene.with_tensors) at the index of corner c000
    (``_corner0``), then the trilinear combine ``_lerp8``: the whole
    lookup is one launch of the ``grid_gather`` kernel's trilinear entry
    (ops/gather.py::grid_trilinear) for CUDA tensors, and the eager chain
    ``trilinear_gather_plain`` for CPU tensors.

The packed lookup is differentiable with respect to the grid
(``GridTrilinear``): its backward scatters each lane's cotangent into the
8 grid voxels it read, one launch of the kernel's backward entry
(ops/gather.py::grid_trilinear_bwd) for CUDA tensors and the plain
``trilinear_backward_plain`` for CPU tensors. The table itself carries no
gradient. The lookup positions are trajectory-class (under the detach
discipline no value-class parameter moves them): the CUDA lookup gives
them no gradient and refuses positions that require one.

A nearest-filter grid is read one voxel a lane: the flat voxel index of
``_nearest_index`` and one launch of the ``grid_gather`` kernel's gather
entry (ops/gather.py::gather_rows) on the (S*D*H*W, C) view of the grid
for CUDA tensors, ``gather_rows_plain`` for CPU tensors, at any grid size.
``NearestGather`` gives the grid its gradient: the scatter-add of each
lane's cotangent into the voxel it read (``index_add_``). In spectral a
nearest grid of 4 channels is srgb-packed: the sigmoid at the one voxel.

``gridvolume_srgb`` reads its packed 8-corner table (32 floats a lane)
through ``gather_rows`` (the kernel's gather entry, one launch a lookup),
evaluates the sigmoid at each corner for the lane's wavelengths and lerps
the corner spectra and, apart, the corner scales (grid3d.cpp:300-341;
lerping the coefficients would bend the sigmoid between voxels). Its
gradient lands on the (S, D, H, W, 4) coefficient-and-scale grid through
``PackedRowGather``: the backward adds each lane's 32-float row cotangent
into the 8 voxels the row was packed from (``packed_rows_backward``, one
``index_add_``, the transpose the reference leaves to XLA); the sigmoid
and the lerps are autograd. ``gridvolume_spectral`` looks its S channels
up trilinearly as a gridvolume does (above EINSUM_MAX_VOXELS one launch
of the fused trilinear entry, differentiated by GridTrilinear at C = S)
and lerps them along the wavelength axis (autograd).
"""

from __future__ import annotations

import math

import torch

from ..core.transform import Transform
from ..ops import gather
from ..utils.runtime import scoped_phase

# voxel-count threshold between the einsum path and the packed-row gather
# path (the reference's EINSUM_MAX_VOXELS)
EINSUM_MAX_VOXELS = 4096
# the reference's name for the same threshold, which it keeps unread
PACKED_GATHER_MIN_VOXELS = EINSUM_MAX_VOXELS


def _axis_weights(g, n_axis):
    """(..., n_axis) linear-interpolation weights along one grid axis:
    (1 - f) at i0 and f at i0 + 1."""
    i0 = torch.clamp(g.to(torch.int32), 0, max(n_axis - 2, 0))
    f = (g - i0)[..., None]
    ar = torch.arange(n_axis, device=g.device)
    w = torch.where(ar == i0[..., None], 1.0 - f, 0.0)
    i1 = torch.clamp(i0 + 1, max=n_axis - 1)
    return torch.where(ar == i1[..., None], w + f, w)


def _corner0(grid_shape, vslot, pl):
    """Flat index of corner c000 (the packed row's voxel) and the three
    fractional weights: the reference's _corner_setup for its first corner
    only, the one the packed path reads. grid_shape: (S, D, H, W)."""
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
    idx = vslot * (D * H * W) + (z0 * H + y0) * W + x0
    return idx, fx, fy, fz


def _lerp8(c, fx, fy, fz):
    """Trilinear combine of 8 corner values, c000..c111 (zyx binary)."""
    c00 = c[0] * (1 - fx) + c[1] * fx
    c01 = c[2] * (1 - fx) + c[3] * fx
    c10 = c[4] * (1 - fx) + c[5] * fx
    c11 = c[6] * (1 - fx) + c[7] * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def packed_corners(grid):
    """(S, D, H, W, C) -> (S*D*H*W, 8*C): every voxel's trilinear
    neighbourhood in one row (c000..c111, zyx binary order, +1 neighbours
    edge-clamped like min(i + 1, n - 1))."""
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


def packed_corners_of(volumes, kind="gridvolume"):
    """The packed table of a scene's ``kind`` rows when they take the
    gather path (gridvolume_srgb always does), else None: a table derived
    from the grid, built with autograd off (the grid's gradient comes
    through GridTrilinear)."""
    params = volumes.get(kind)
    if params is None:
        return None
    S, D, H, W, C = params["grid"].shape
    if kind != "gridvolume_srgb" and D * H * W <= EINSUM_MAX_VOXELS:
        return None
    with torch.no_grad():
        return packed_corners(params["grid"])


def spectral_packed_of(volumes):
    """{kind: packed table} of the spectral variant's grids that take the
    gather path."""
    out = {}
    for kind in ("gridvolume_srgb", "gridvolume_spectral"):
        packed = packed_corners_of(volumes, kind)
        if packed is not None:
            out[kind] = packed
    return out


def trilinear_gather_plain(packed, grid_shape, vslot, pl):
    """The packed-neighbourhood lookup as an eager chain: corner c000's
    index, its 8C-wide row (its 8 corner voxels) through the plain row
    gather, then _lerp8. The plain version of ops.gather.grid_trilinear."""
    S, D, H, W, C = grid_shape
    idx, fx, fy, fz = _corner0((S, D, H, W), vslot, pl)
    rows = gather.gather_rows_plain(packed, idx.reshape(-1))
    rows = rows.reshape(idx.shape + (8 * C,))
    return _lerp8([rows[..., k * C:(k + 1) * C] for k in range(8)],
                  fx, fy, fz)


def _corner_voxels(idx, grid_shape):
    """The flat voxel indices (8 of (L,), c000..c111) of the packed rows
    ``idx`` (L,): each row's voxel and its +1 neighbours, edge-clamped as
    packed_corners clamps them (the row index clamped as the gather
    clamps it)."""
    S, D, H, W = grid_shape[:4]
    r = idx.reshape(-1).clamp(0, S * D * H * W - 1).long()
    x, y, z = r % W, (r // W) % H, (r // (W * H)) % D
    base = r - (z * H + y) * W - x
    xs = (x, torch.clamp(x + 1, max=W - 1))
    ys = (y, torch.clamp(y + 1, max=H - 1))
    zs = (z, torch.clamp(z + 1, max=D - 1))
    return [base + (zs[dz] * H + ys[dy]) * W + xs[dx]
            for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]


def packed_rows_backward(ct, grid_shape, idx):
    """The gradient of gather_rows(packed_corners(grid), idx) with respect
    to the grid: ct (L, 8C) -> d_grid of ``grid_shape`` (S, D, H, W, C),
    each lane's corner-k slice added into corner k's voxel by one
    index_add_."""
    C = grid_shape[-1]
    d_grid = ct.new_zeros((math.prod(grid_shape[:4]), C))
    ct = ct.reshape(-1, 8, C)
    d_grid.index_add_(0, torch.cat(_corner_voxels(idx, grid_shape)),
                      ct.transpose(0, 1).reshape(-1, C))
    return d_grid.reshape(grid_shape)


class PackedRowGather(torch.autograd.Function):
    """Rows ``idx`` of a grid's packed 8-corner table, differentiable with
    respect to the grid: the forward is one gather_rows of the table (the
    kernel's gather entry for CUDA tensors), the backward
    packed_rows_backward. The table and the indices get no gradient."""

    @staticmethod
    def forward(ctx, grid, packed, idx):
        ctx.save_for_backward(idx)
        ctx.grid_shape = tuple(grid.shape)
        return gather.gather_rows(packed, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return packed_rows_backward(ct, ctx.grid_shape, idx), None, None


def trilinear_backward_plain(ct, grid_shape, vslot, pl):
    """The packed lookup's gradient with respect to the grid: ct (..., C),
    the cotangent of trilinear_gather_plain's output -> d_grid of
    ``grid_shape`` (S, D, H, W, C). The exact transpose of grid ->
    packed_corners -> clamped row gather -> _lerp8: each lane adds ct times
    the weight _lerp8 gives corner k, ((ct (1 - fz|fz)) (1 - fy|fy))
    (1 - fx|fx), into the voxels of its row's 8 corners (the row's voxel
    and its +1 neighbours, edge-clamped as packed_corners clamps them), by
    one index_add_. The plain version of ops.gather.grid_trilinear_bwd."""
    S, D, H, W, C = grid_shape
    idx, fx, fy, fz = _corner0((S, D, H, W), vslot, pl)
    fx, fy, fz = (f.reshape(-1, 1) for f in (fx, fy, fz))
    g = ct.reshape(-1, C)
    vals = []
    for dz in (0, 1):
        gz = g * (fz if dz else 1 - fz)
        for dy in (0, 1):
            gzy = gz * (fy if dy else 1 - fy)
            for dx in (0, 1):
                vals.append(gzy * (fx if dx else 1 - fx))
    d_grid = torch.zeros(S * D * H * W, C, dtype=ct.dtype, device=ct.device)
    d_grid.index_add_(0, torch.cat(_corner_voxels(idx, grid_shape)),
                      torch.cat(vals))
    return d_grid.reshape(S, D, H, W, C)


def _lookup(packed, grid_shape, vslot, pl):
    """The packed lookup on the tensors' device: one launch of the
    grid_gather kernel's trilinear entry for CUDA tensors, the plain chain
    for CPU tensors (or under gather.use_plain)."""
    if gather.on_plain(packed):
        return trilinear_gather_plain(packed, grid_shape, vslot, pl)
    return gather.grid_trilinear(packed, grid_shape, vslot, pl)


def trilinear_positions_backward(ct, packed, grid_shape, vslot, pl):
    """The packed lookup's gradient with respect to the positions: ct
    (..., C), the cotangent of its output -> (..., 3). The lanes' 8-corner
    rows are read again as the lookup read them (gather.gather_rows: the
    kernel's gather entry for CUDA tensors), and _lerp8's derivative in
    the fractional weights, times the clamp's (the axis's extent - 1
    inside [0, 1], 0 outside), comes from autograd over those rows."""
    S, D, H, W, C = grid_shape
    with torch.enable_grad():
        plg = pl.detach().requires_grad_()
        idx, fx, fy, fz = _corner0((S, D, H, W), vslot, plg)
        rows = gather.gather_rows(packed, idx.reshape(-1).contiguous())
        rows = rows.reshape(idx.shape + (8 * C,))
        out = _lerp8([rows[..., k * C:(k + 1) * C] for k in range(8)],
                     fx, fy, fz)
        (d_pl,) = torch.autograd.grad(out, plg, ct)
    return d_pl


class GridTrilinear(torch.autograd.Function):
    """The packed lookup as an op differentiable with respect to the grid
    and the positions: the forward reads the packed table (``_lookup``);
    the backward gives the grid its gradient (one launch of the kernel's
    backward entry for CUDA tensors, trilinear_backward_plain for CPU
    tensors) and the positions theirs (trilinear_positions_backward). The
    table and the slots get none."""

    @staticmethod
    def forward(ctx, grid, packed, vslot, pl):
        ctx.save_for_backward(packed, vslot, pl)
        ctx.grid_shape = tuple(grid.shape)
        return _lookup(packed, grid.shape, vslot, pl)

    @staticmethod
    def backward(ctx, ct):
        packed, vslot, pl = ctx.saved_tensors
        ct = ct.contiguous()
        d_grid = d_pl = None
        if ctx.needs_input_grad[0]:
            if gather.on_plain(ct):
                d_grid = trilinear_backward_plain(ct, ctx.grid_shape, vslot,
                                                  pl)
            else:
                d_grid = gather.grid_trilinear_bwd(ct, ctx.grid_shape,
                                                   vslot, pl)
        if ctx.needs_input_grad[3]:
            d_pl = trilinear_positions_backward(ct, packed, ctx.grid_shape,
                                                vslot, pl)
        return d_grid, None, None, d_pl


def _trilinear_gather(grid, packed, vslot, pl):
    """Packed-neighbourhood lookup of ``grid`` through its packed table.
    With autograd on, a grid or positions that require a gradient get it
    through GridTrilinear."""
    if torch.is_grad_enabled() and (grid.requires_grad or pl.requires_grad):
        return GridTrilinear.apply(grid, packed, vslot, pl)
    return _lookup(packed, grid.shape, vslot, pl)


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


def _nearest_index(grid_shape, vslot, pl):
    """Flat voxel index of the nearest-filter lookup (grid3d.cpp
    FilterType::Nearest: scale to the resolution with no half-texel shift,
    floor): voxel i of an axis of n covers [i/n, (i+1)/n)."""
    S, D, H, W = grid_shape
    x = torch.clamp((pl[..., 0] * W).to(torch.int32), 0, W - 1)
    y = torch.clamp((pl[..., 1] * H).to(torch.int32), 0, H - 1)
    z = torch.clamp((pl[..., 2] * D).to(torch.int32), 0, D - 1)
    return vslot * (D * H * W) + (z * H + y) * W + x


class NearestGather(torch.autograd.Function):
    """Rows ``idx`` of the (V, C) view of a grid, differentiable with
    respect to the grid: the forward is gather_rows (the kernel's gather
    entry for CUDA tensors), the backward scatter-adds the cotangent into
    the rows it read."""

    @staticmethod
    def forward(ctx, flat, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = flat.shape[0]
        return gather.gather_rows(flat, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return nearest_backward(ct, idx, ctx.n_rows), None


def nearest_backward(ct, idx, n_rows):
    """The gradient of gather_rows(flat, idx) with respect to the (n_rows,
    C) table ``flat``: the cotangents ct (L, C) added into the rows read
    (index_add_, with the gather's clamp)."""
    d_flat = ct.new_zeros((n_rows, ct.shape[-1]))
    return d_flat.index_add_(0, idx.clamp(0, n_rows - 1), ct)


def _nearest_gather(grid, vslot, pl):
    """The nearest-voxel values (..., C) of ``grid`` (S, D, H, W, C): one
    row gather over every lane, flattened."""
    S, D, H, W, C = grid.shape
    idx = _nearest_index((S, D, H, W), vslot, pl)
    flat = grid.reshape(S * D * H * W, C)
    if not flat.is_contiguous():
        flat = flat.contiguous()
    rows = NearestGather.apply(flat, idx.reshape(-1).contiguous())
    return rows.reshape(idx.shape + (C,))


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


def _local(params, slot, p):
    return Transform(m=params["w2l_m"][slot],
                     inv_t=params["w2l_it"][slot]).transform_affine_point(p)


def _trilinear(grid, packed, slot, pl):
    """The trilinear lookup of ``grid``: the einsum path up to
    EINSUM_MAX_VOXELS voxels, else the packed table."""
    S, D, H, W, C = grid.shape
    if D * H * W > EINSUM_MAX_VOXELS:
        return _trilinear_gather(grid, packed, slot, pl)
    return _trilinear_einsum(grid, slot, pl)


def _srgb_corners(grid, packed, slot, pl, wavelengths):
    """The srgb-packed trilinear lookup: the lanes' 8-corner rows (8 x 4
    floats: coeff (3), scale) in one gather_rows, the sigmoid at each
    corner for the lane's wavelengths, then the corner spectra and the
    corner scales lerped apart (grid3d.cpp:300-341). The gather is
    PackedRowGather's, so a grid that requires a gradient gets one."""
    from ..render.texture import srgb_model_eval

    S, D, H, W, C = grid.shape
    idx, fx, fy, fz = _corner0((S, D, H, W), slot, pl)
    flat = idx.reshape(-1).contiguous()
    rows = PackedRowGather.apply(grid, packed, flat).reshape(
        idx.shape + (8 * C,))
    corners = [rows[..., k * C:(k + 1) * C] for k in range(8)]
    spectra = [srgb_model_eval(c[..., :3], wavelengths) for c in corners]
    scales = [c[..., 3:4] for c in corners]
    return _lerp8(spectra, fx, fy, fz) * _lerp8(scales, fx, fy, fz)


def _wavelength_lerp(params, slot, spec, wavelengths):
    """gridvolume_spectral's S channels (..., S) at the hero wavelengths:
    linear in the wavelength over [wl_lo, wl_hi], clamped."""
    S = spec.shape[-1]
    lo = params["wl_lo"][slot][..., None]
    hi = params["wl_hi"][slot][..., None]
    t = torch.clamp((wavelengths - lo) / torch.clamp(hi - lo, min=1e-9),
                    0.0, 1.0) * (S - 1)
    i0 = torch.clamp(t.to(torch.int32), 0, max(S - 2, 0))
    f = t - i0
    v0 = torch.gather(spec, -1, i0.long())
    v1 = torch.gather(spec, -1, torch.clamp(i0 + 1, max=S - 1).long())
    return v0 * (1 - f) + v1 * f


@scoped_phase("ert::volume_eval")
def volume_eval(scene, vol_idx, p, wavelengths=None, active=True):
    """Evaluate volumes per lane at world position p -> (..., nc);
    ``wavelengths`` (..., nw), the spectral variant's hero wavelengths.
    Every lane is read, ``active`` or not, as in the reference."""
    cfg = scene.config
    spectral = cfg.variant.is_spectral
    nc = (cfg.variant.channels(wavelengths) if spectral
          else cfg.variant.n_channels)
    vkind = scene.vol_kind[vol_idx]
    vslot = scene.vol_slot[vol_idx]
    out = torch.zeros(vkind.shape + (nc,), dtype=cfg.variant.dtype,
                      device=p.device)
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
        elif kind in ("gridvolume", "gridvolume_nearest"):
            pl, inside = _apply_wrap(params, slot, _local(params, slot, p))
            grid = params["grid"]
            C = grid.shape[-1]
            if kind == "gridvolume_nearest":
                c = _nearest_gather(grid, slot, pl)
            else:
                c = _trilinear(grid, scene.vol_packed, slot, pl)
            c = torch.where(inside[..., None], c, 0.0)
            if spectral and C == 4:
                # srgb-packed (nearest): the sigmoid at the one voxel
                from ..render.texture import srgb_model_eval
                v = srgb_model_eval(c[..., :3], wavelengths) * c[..., 3:4]
            elif C == 1:
                v = c.expand(c.shape[:-1] + (nc,))
            elif C == nc:
                v = c
            else:
                v = torch.mean(c, -1, keepdim=True).expand(
                    c.shape[:-1] + (nc,))
        elif kind == "gridvolume_srgb":
            pl, inside = _apply_wrap(params, slot, _local(params, slot, p))
            v = _srgb_corners(params["grid"],
                              scene.vol_packed_spectral[kind], slot, pl,
                              wavelengths)
            v = torch.where(inside[..., None], v, 0.0)
        elif kind == "gridvolume_spectral":
            pl = _local(params, slot, p)
            grid = params["grid"]
            spec = _trilinear(grid, scene.vol_packed_spectral.get(kind),
                              slot, pl)
            inside = torch.all((pl >= 0.0) & (pl <= 1.0), dim=-1)
            spec = torch.where(inside[..., None], spec, 0.0)
            if spectral:
                v = _wavelength_lerp(params, slot, spec, wavelengths)
            else:
                # colour modes: the spectral mean
                v = torch.mean(spec, -1, keepdim=True).expand(
                    spec.shape[:-1] + (nc,))
        else:
            raise ValueError(f"unknown volume kind {kind}")
        out = torch.where(m[..., None], v, out)
    return out


def volume_max(scene, vol_idx):
    """The largest value (N,) of each lane's volume (the majorant source,
    grid3d.cpp:88)."""
    vkind = scene.vol_kind[vol_idx]
    vslot = scene.vol_slot[vol_idx]
    out = torch.zeros(vkind.shape, dtype=scene.config.variant.dtype,
                      device=vol_idx.device)
    for k, kind in enumerate(scene.config.volume_kinds):
        m = vkind == k
        slot = torch.where(m, vslot, 0)
        params = scene.volumes[kind]
        v = (torch.amax(params["value"][slot], dim=-1)
             if kind == "constvolume" else params["vmax"][slot])
        out = torch.where(m, v, out)
    return out


def volume_eval_gradient(scene, vol_idx, p, wavelengths=None, active=True):
    """The volume's spatial gradient at the world points p -> (N, nc, 3)
    (Volume::eval_gradient, texture.h:210-263): exact for the trilinear
    interpolant, zero for a constvolume. A lane's value depends on its own
    point only, so each channel's gradient is one backward pass of its
    sum (the packed lookups' through GridTrilinear and PackedRowGather,
    which read the kernel's gather entry for CUDA tensors)."""
    with torch.enable_grad():
        pg = p.detach().requires_grad_()
        out = volume_eval(scene, vol_idx, pg, wavelengths, active)
        cols = []
        for c in range(out.shape[-1]):
            g, = torch.autograd.grad(out[..., c].sum(), pg,
                                     retain_graph=True, allow_unused=True)
            cols.append(torch.zeros_like(pg) if g is None else g)
    return torch.stack(cols, dim=-2)
