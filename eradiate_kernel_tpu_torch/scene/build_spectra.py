"""Media-profile build helpers (the profile part of scene/build_spectra.py):
numpy at scene build, bit-equal to the reference's tables."""

from __future__ import annotations

import numpy as np

AXPROF_BINS = 64  # fixed per-axis majorant profile resolution (media)


def _axis_range_profiles(values, P):
    """(3, P) per-axis slab-max profiles of a (D, H, W) node field: row a
    (x, y, z), bin i covering local [i/P, (i+1)/P], holds the max over the
    nodes whose trilinear support touches the bin."""
    out = np.empty((3, P), np.float32)
    for a_out, a_grid in ((0, 2), (1, 1), (2, 0)):  # out rows: x, y, z
        other = tuple(i for i in range(values.ndim) if i != a_grid)
        node_max = values.max(axis=other)          # (n_nodes,)
        n = len(node_max)
        for i in range(P):
            g0 = int(np.floor(i / P * (n - 1)))
            g1 = int(np.ceil((i + 1) / P * (n - 1)))
            out[a_out, i] = node_max[g0:g1 + 1].max()
    return out


def _axis_majorant_profiles(vol_row, vmax):
    """Conservative per-axis slab-max profiles of a sigma_t volume,
    normalized by vmax: (3, P) f32 in [0, 1] (the medium's traced
    'majorant' row sets the magnitude at query time). Constant volumes get
    flat profiles."""
    P = AXPROF_BINS
    grid = vol_row.get("grid")
    if grid is None or vmax <= 0:
        return np.ones((3, P), np.float32)
    # grid (D, H, W, C): axis 0 = local z, 1 = local y, 2 = local x;
    # f32 safety margin so interpolation rounding can never exceed it
    return _axis_range_profiles(grid, P) * np.float32((1.0 + 1e-4) / vmax)


def _control_and_residual_profiles(vol_kind, vol_row, vmax):
    """Control profile and per-axis residual-bound profiles of the residual
    ratio-tracking NEE estimator: sigma_c(z) is the horizontal mean of the
    grid per z-slice (piecewise linear in local z, closed-form cumulative
    integral ccum), and resprof bounds |grid - sigma_c| per axis. Returns
    (cprof (D,), ccum (D,), resprof (3, P)), resprof in absolute sigma
    units before the medium's scale."""
    P = AXPROF_BINS
    grid = vol_row.get("grid")
    if vol_kind == "constvolume":
        val = float(np.max(vol_row["value"]))
        return (np.asarray([val], np.float32), np.zeros(1, np.float32),
                np.zeros((3, P), np.float32))
    ctrl_ok = (vol_kind == "gridvolume" and grid is not None
               and int(vol_row.get("wrap", 0)) == 0
               and grid.shape[-1] == 1)
    if not ctrl_ok:
        # zero control: residual tracking degenerates to per-segment-
        # majorant ratio tracking (resprof = the unnormalized axis majorant)
        return (np.zeros(1, np.float32), np.zeros(1, np.float32),
                _axis_majorant_profiles(vol_row, vmax) * np.float32(vmax)
                if vmax > 0 else np.zeros((3, P), np.float32))
    g = grid[..., 0].astype(np.float64)          # (D, H, W), axis 0 = z
    cprof = g.mean(axis=(1, 2))                  # horizontal mean per slice
    D = len(cprof)
    if D > 1:
        dz = 1.0 / (D - 1)
        ccum = np.concatenate(
            [[0.0], np.cumsum(0.5 * (cprof[:-1] + cprof[1:]) * dz)])
    else:
        ccum = np.zeros(1)
    resid = np.abs(g - cprof[:, None, None])     # (D, H, W)
    return (cprof.astype(np.float32), ccum.astype(np.float32),
            _axis_range_profiles(resid, P) * np.float32(1.0 + 1e-4))
