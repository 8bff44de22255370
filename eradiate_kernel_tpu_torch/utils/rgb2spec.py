"""RGB -> smooth reflectance spectrum fitting (Jakob & Hanika 2019;
utils/rgb2spec.py counterpart, numpy on the host at scene build).

Mitsuba ships precomputed rgb2spec coefficient tables (ext/rgb2spec,
loaded by srgb.cpp:14-37). Here the sigmoid-polynomial coefficients are
fitted per rgb value at scene build with a damped Gauss-Newton on the
CIE/D65 projection (a few dozen iterations a colour, cached). The model is
srgb.h:9-21's sigmoid polynomial, so spectral renders reproduce the
requested sRGB reflectances under D65. The projection is built from the
float32 CIE table and D65 of the port (CPU tensors), widened to float64.
"""

from __future__ import annotations

import functools

import numpy as np

from ..core import spectrum as sp

_LAM = np.linspace(sp.CIE_MIN, sp.CIE_MAX, 95)


@functools.lru_cache(maxsize=1)
def _projection():
    """(3, K) matrix taking spectral reflectance samples to normalized sRGB
    under D65 (the same bake the rgb variant uses in build.py)."""
    import torch

    from ..render.texture import d65_approx

    lam = _LAM
    lam32 = torch.as_tensor(lam, dtype=torch.float32)
    cie = sp.cie1931_xyz(lam32).numpy().astype(np.float64)
    d65 = d65_approx(lam32).numpy().astype(np.float64)
    w = d65[:, None] * cie                     # (K, 3) integrand weights
    w *= (lam[1] - lam[0])
    denom = (d65 * cie[:, 1]).sum() * (lam[1] - lam[0])
    xyz_to_srgb = np.array([[3.240479, -1.537150, -0.498535],
                            [-0.969256, 1.875991, 0.041556],
                            [0.055648, -0.204043, 1.057311]])
    return xyz_to_srgb @ (w.T / denom)         # (3, K)


def _model(coeff):
    """Sigmoid polynomial over _LAM; coeff (3,) -> (K,) reflectance."""
    x = coeff[0] * _LAM ** 2 + coeff[1] * _LAM + coeff[2]
    return 0.5 * x / np.sqrt(1.0 + x * x) + 0.5


def _jacobian(coeff):
    x = coeff[0] * _LAM ** 2 + coeff[1] * _LAM + coeff[2]
    dsig = 0.5 / (1.0 + x * x) ** 1.5
    basis = np.stack([_LAM ** 2, _LAM, np.ones_like(_LAM)])  # (3, K)
    return (dsig * basis).T                                   # (K, 3)


@functools.lru_cache(maxsize=4096)
def fit_srgb_coeff(r, g, b):
    """Sigmoid-polynomial coefficients reproducing linear sRGB (r, g, b)
    under D65. Gauss-Newton with Levenberg damping; inputs clipped to the
    fittable gamut like the reference's table."""
    target = np.clip([r, g, b], 1e-4, 0.9999)
    P = _projection()

    # init: flat spectrum at luminance
    lum = float(0.2126 * target[0] + 0.7152 * target[1] + 0.0722 * target[2])
    y = 2.0 * lum - 1.0
    coeff = np.array([0.0, 0.0, y / np.sqrt(max(1.0 - y * y, 1e-9))])

    lam_damp = 1e-4
    resid = P @ _model(coeff) - target
    err = float(resid @ resid)
    for _ in range(60):
        J = P @ _jacobian(coeff)               # (3, 3)
        JtJ = J.T @ J + lam_damp * np.eye(3)
        step = np.linalg.solve(JtJ, J.T @ resid)
        new = coeff - step
        new_resid = P @ _model(new) - target
        new_err = float(new_resid @ new_resid)
        if new_err < err:
            coeff, resid, err = new, new_resid, new_err
            lam_damp = max(lam_damp * 0.5, 1e-8)
            if err < 1e-10:
                break
        else:
            lam_damp *= 4.0
            if lam_damp > 1e6:
                break
    return tuple(np.asarray(coeff, np.float32))


def fit_srgb_coeff_batch(rgb: np.ndarray) -> np.ndarray:
    """Vectorized sigmoid-polynomial fit for (N, 3) linear-sRGB reflectances
    (the whole-image analog of fit_srgb_coeff — one damped Gauss-Newton over
    all texels at once; used to upsample envmaps/bitmaps at scene build,
    envmap.cpp:69-89 / bitmap spectral conversion)."""
    rgb = np.asarray(rgb, np.float64).reshape(-1, 3)
    target = np.clip(rgb, 1e-4, 0.9999)
    N = len(target)
    P = _projection()                                  # (3, K)
    K = P.shape[1]

    lum = target @ np.array([0.2126, 0.7152, 0.0722])
    y = 2.0 * lum - 1.0
    coeff = np.zeros((N, 3))
    coeff[:, 2] = y / np.sqrt(np.maximum(1.0 - y * y, 1e-9))

    basis = np.stack([_LAM ** 2, _LAM, np.ones_like(_LAM)])  # (3, K)

    def model(c):
        x = c @ basis                                  # (N, K)
        return 0.5 * x / np.sqrt(1.0 + x * x) + 0.5

    def residual(c):
        return model(c) @ P.T - target                 # (N, 3)

    damp = np.full(N, 1e-4)
    resid = residual(coeff)
    err = np.einsum("ni,ni->n", resid, resid)
    eye = np.eye(3)
    for _ in range(120):
        x = coeff @ basis
        dsig = 0.5 / (1.0 + x * x) ** 1.5              # (N, K)
        # J_n = P @ (dsig_n * basis).T  -> (N, 3, 3)
        J = np.einsum("ok,nk,bk->nob", P, dsig, basis)
        JtJ = np.einsum("nob,noc->nbc", J, J) \
            + damp[:, None, None] * eye
        g = np.einsum("nob,no->nb", J, resid)
        step = np.linalg.solve(JtJ, g[..., None])[..., 0]
        new = coeff - step
        new_resid = residual(new)
        new_err = np.einsum("ni,ni->n", new_resid, new_resid)
        better = new_err < err
        coeff = np.where(better[:, None], new, coeff)
        resid = np.where(better[:, None], new_resid, resid)
        err = np.where(better, new_err, err)
        damp = np.where(better, np.maximum(damp * 0.5, 1e-8), damp * 4.0)
        if err.max() < 1e-10:
            break
    # polish stragglers (the flat init traps a handful of saturated texels
    # in a local minimum) with a multi-start Gauss-Newton
    bad = np.where(err > 1e-8)[0]
    for i in bad[:4096]:
        coeff[i] = _fit_multistart(target[i])
    return coeff.astype(np.float32)


def _fit_multistart(target):
    """27-start damped GN for colors the flat init cannot reach (saturated
    hues need |coeff| ~ 10-100; cf. the spread of the reference's rgb2spec
    table entries)."""
    P = _projection()
    basis = np.stack([_LAM ** 2, _LAM, np.ones_like(_LAM)])

    def model(c):
        x = c @ basis
        return 0.5 * x / np.sqrt(1.0 + x * x) + 0.5

    best, best_err = None, np.inf
    for a in (-1e-5, 0.0, 1e-5):
        for b in (-0.01, 0.0, 0.01):
            for c0 in (-3.0, 0.0, 3.0):
                c = np.array([a, b, c0])
                damp = 1e-4
                r = model(c) @ P.T - target
                e = float(r @ r)
                for _ in range(200):
                    x = c @ basis
                    dsig = 0.5 / (1.0 + x * x) ** 1.5
                    J = P @ (dsig * basis).T
                    step = np.linalg.solve(J.T @ J + damp * np.eye(3),
                                           J.T @ r)
                    cn = c - step
                    rn = model(cn) @ P.T - target
                    en = float(rn @ rn)
                    if en < e:
                        c, r, e = cn, rn, en
                        damp = max(damp * 0.5, 1e-8)
                        if e < 1e-14:
                            break
                    else:
                        damp *= 4.0
                        if damp > 1e8:
                            break
                if e < best_err:
                    best, best_err = c, e
                if best_err < 1e-14:
                    return best
    return best
