"""Scene-build helpers of scene/build_spectra.py: the rgb bake of a
spectrum, a bitmap's or an envmap's image and the media profiles (numpy at
scene build, bit-equal to the reference's tables)."""

from __future__ import annotations

import numpy as np
import torch

from ..core import spectrum as sp
from ..utils import bitmap


def _cie_rgb_of_spectrum(eval_fn, emitter: bool) -> np.ndarray:
    """Bake a spectrum (a callable wavelength -> value) to linear sRGB by
    CIE integration over 471 wavelengths (spectrum.cpp spectrum_to_rgb):
    the CIE responses in float32, the trapezoid integrals in float64, the
    XYZ -> sRGB matrix in float32. Reflectance spectra (``emitter``
    False) are weighted by D65 and normalised by D65's luminance."""
    from ..render.texture import d65_approx

    lam = np.linspace(sp.CIE_MIN, sp.CIE_MAX, 471)
    lam32 = torch.as_tensor(lam, dtype=torch.float32)
    vals = np.asarray(eval_fn(lam), np.float64)
    cie = sp.cie1931_xyz(lam32).numpy().astype(np.float64)
    if emitter:
        xyz = np.trapezoid(vals[:, None] * cie, lam, axis=0)
    else:
        d65 = d65_approx(lam32).numpy().astype(np.float64)
        denom = np.trapezoid(d65 * cie[:, 1], lam)
        xyz = np.trapezoid(vals[:, None] * d65[:, None] * cie, lam,
                           axis=0) / denom
    rgb = sp.xyz_to_srgb(torch.as_tensor(xyz[None], dtype=torch.float32))
    return np.maximum(rgb.numpy()[0], 0.0)

def _image_data(d):
    """The image of a bitmap or envmap dict: its inline ``data``, or its
    ``filename`` read on the host (float32): an EXR keeps its first 3
    channels when it has 3 or more (a 1-channel EXR stays (H, W, 1)),
    other formats go through ``bitmap.read_image``."""
    if "data" in d:
        return np.asarray(d["data"], np.float32)
    fn = d["filename"]
    if fn.lower().endswith(".exr"):
        img, _names = bitmap.read_exr(fn)
        return img[..., :3] if img.shape[-1] >= 3 else img
    return np.asarray(bitmap.read_image(fn), np.float32)


AXPROF_BINS = 64  # fixed per-axis majorant profile resolution (media)

SMP_TABLE_N = 96  # spectrum sampling-table resolution (spectrum_sample)


def _spectrum_sampling_table(kind, row):
    """The piecewise-linear wavelength sampling table of a spectral row
    (Texture::sample_spectrum / pdf_spectrum, texture.h:23-201): the
    spectrum at SMP_TABLE_N nodes, normalised into a density, and its
    trapezoid CDF. Sampling draws from this density and reports it as the
    pdf, so eval / pdf stays unbiased where the table under-resolves the
    spectrum. Returns smp_nodes, smp_pdf, smp_cdf (SMP_TABLE_N,) each."""
    from ..render.texture import d65_approx, srgb_model_eval

    P = SMP_TABLE_N
    wmin, wmax = sp.WAVELENGTH_MIN, sp.WAVELENGTH_MAX
    if kind == "uniform":
        nodes = np.linspace(wmin, wmax, P)
        f = np.full(P, float(row["value"]))
    elif kind == "regular":
        lo, hi = float(row["lo"]), float(row["hi"])
        vals = np.asarray(row["values"], np.float64)
        nodes = np.linspace(lo, hi, P)
        f = np.interp(nodes, np.linspace(lo, hi, len(vals)), vals)
    elif kind == "irregular":
        nd = np.asarray(row["nodes"], np.float64)
        vals = np.asarray(row["values"], np.float64)
        nodes = np.linspace(nd[0], nd[-1], P)
        f = np.interp(nodes, nd, vals)
    elif kind in ("srgb", "srgb_d65", "blackbody", "d65"):
        nodes = np.linspace(wmin, wmax, P)
        lam = torch.as_tensor(nodes, dtype=torch.float32)
        if kind == "blackbody":
            f = sp.blackbody_radiance(lam, float(row["temperature"])).numpy() \
                * float(row["scale"])
        else:
            f = np.ones(P)
            if kind in ("srgb", "srgb_d65"):
                f = f * srgb_model_eval(torch.as_tensor(
                    row["coeff"], dtype=torch.float32)[None], lam)[0].numpy()
            if kind in ("d65", "srgb_d65"):
                f = f * d65_approx(lam).numpy() * float(row["scale"])
    else:
        raise ValueError(kind)
    f = np.maximum(np.asarray(f, np.float64), 1e-12)
    seg = 0.5 * (f[1:] + f[:-1]) * np.diff(nodes)
    integral = seg.sum()
    cdf = np.concatenate([[0.0], np.cumsum(seg)]) / integral
    return {"smp_nodes": nodes.astype(np.float32),
            "smp_pdf": (f / integral).astype(np.float32),
            "smp_cdf": cdf.astype(np.float32)}


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
