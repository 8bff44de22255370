"""The CIE 1931 colour-matching table, Planck's law, sRGB <-> XYZ
conversion, luminance and hero-wavelength sampling (core/spectrum.py
counterpart). The wavelength range is the Eradiate kernel's, 280-2400 nm
(spectrum.h:15-20); the spectral variant carries ``N_HERO`` = 4 hero
wavelengths a ray.

The CIE table is the 2-degree standard observer (CIE 15:2004, public-domain
standard data; 95 samples at 5 nm over 360-830 nm), normalised so that a
unit-radiance spectrum has luminance Y = 1: ``CIE_XYZ_TABLE`` holds the
responses divided by the trapezoid integral of ybar (units 1/nm).
"""

from __future__ import annotations

import numpy as np
import torch

from .math import channel_mean

WAVELENGTH_MIN = 280.0
WAVELENGTH_MAX = 2400.0
CIE_MIN = 360.0
CIE_MAX = 830.0
CIE_SAMPLES = 95
N_HERO = 4  # hero wavelengths per ray in spectral mode

# (xbar, ybar, zbar) per row, 360-830 nm at 5 nm
_CIE_1931_TABLE = np.array([
    [0.0001299, 0.000003917, 0.0006061],
    [0.0002321, 0.000006965, 0.001086],
    [0.0004149, 0.00001239, 0.001946],
    [0.0007416, 0.00002202, 0.003486],
    [0.001368, 0.000039, 0.006450001],
    [0.002236, 0.000064, 0.01054999],
    [0.004243, 0.00012, 0.02005001],
    [0.00765, 0.000217, 0.03621],
    [0.01431, 0.000396, 0.06785001],
    [0.02319, 0.00064, 0.1102],
    [0.04351, 0.00121, 0.2074],
    [0.07763, 0.00218, 0.3713],
    [0.13438, 0.004, 0.6456],
    [0.21477, 0.0073, 1.0390501],
    [0.2839, 0.0116, 1.3856],
    [0.3285, 0.01684, 1.62296],
    [0.34828, 0.023, 1.74706],
    [0.34806, 0.0298, 1.7826],
    [0.3362, 0.038, 1.77211],
    [0.3187, 0.048, 1.7441],
    [0.2908, 0.06, 1.6692],
    [0.2511, 0.0739, 1.5281],
    [0.19536, 0.09098, 1.28764],
    [0.1421, 0.1126, 1.0419],
    [0.09564, 0.13902, 0.8129501],
    [0.05795001, 0.1693, 0.6162],
    [0.03201, 0.20802, 0.46518],
    [0.0147, 0.2586, 0.3533],
    [0.0049, 0.323, 0.272],
    [0.0024, 0.4073, 0.2123],
    [0.0093, 0.503, 0.1582],
    [0.0291, 0.6082, 0.1117],
    [0.06327, 0.71, 0.07824999],
    [0.1096, 0.7932, 0.05725001],
    [0.1655, 0.862, 0.04216],
    [0.2257499, 0.9148501, 0.02984],
    [0.2904, 0.954, 0.0203],
    [0.3597, 0.9803, 0.0134],
    [0.4334499, 0.9949501, 0.008749999],
    [0.5120501, 1.0, 0.005749999],
    [0.5945, 0.995, 0.0039],
    [0.6784, 0.9786, 0.002749999],
    [0.7621, 0.952, 0.0021],
    [0.8425, 0.9154, 0.0018],
    [0.9163, 0.87, 0.001650001],
    [0.9786, 0.8163, 0.0014],
    [1.0263, 0.757, 0.0011],
    [1.0567, 0.6949, 0.001],
    [1.0622, 0.631, 0.0008],
    [1.0456, 0.5668, 0.0006],
    [1.0026, 0.503, 0.00034],
    [0.9384, 0.4412, 0.00024],
    [0.8544499, 0.381, 0.00019],
    [0.7514, 0.321, 0.0001],
    [0.6424, 0.265, 0.00004999999],
    [0.5419, 0.217, 0.00003],
    [0.4479, 0.175, 0.00002],
    [0.3608, 0.1382, 0.00001],
    [0.2835, 0.107, 0.0],
    [0.2187, 0.0816, 0.0],
    [0.1649, 0.061, 0.0],
    [0.1212, 0.04458, 0.0],
    [0.0874, 0.032, 0.0],
    [0.0636, 0.0232, 0.0],
    [0.04677, 0.017, 0.0],
    [0.0329, 0.01192, 0.0],
    [0.0227, 0.00821, 0.0],
    [0.01584, 0.005723, 0.0],
    [0.01135916, 0.004102, 0.0],
    [0.008110916, 0.002929, 0.0],
    [0.005790346, 0.002091, 0.0],
    [0.004109457, 0.001484, 0.0],
    [0.002899327, 0.001047, 0.0],
    [0.00204919, 0.00074, 0.0],
    [0.001439971, 0.00052, 0.0],
    [0.0009999493, 0.0003611, 0.0],
    [0.0006900786, 0.0002492, 0.0],
    [0.0004760213, 0.0001719, 0.0],
    [0.0003323011, 0.00012, 0.0],
    [0.0002348261, 0.0000848, 0.0],
    [0.0001661505, 0.00006, 0.0],
    [0.000117413, 0.0000424, 0.0],
    [0.00008307527, 0.00003, 0.0],
    [0.00005870652, 0.0000212, 0.0],
    [0.00004150994, 0.00001499, 0.0],
    [0.00002935326, 0.0000106, 0.0],
    [0.00002067383, 0.0000074657, 0.0],
    [0.00001455977, 0.0000052578, 0.0],
    [0.00001025398, 0.0000037029, 0.0],
    [0.000007221456, 0.0000026078, 0.0],
    [0.000005085868, 0.0000018366, 0.0],
    [0.000003581652, 0.0000012934, 0.0],
    [0.000002522525, 0.00000091093, 0.0],
    [0.000001776509, 0.00000064153, 0.0],
    [0.000001251141, 0.00000045181, 0.0],
], dtype=np.float64)

assert _CIE_1931_TABLE.shape == (CIE_SAMPLES, 3)
_CIE_LAM = np.linspace(CIE_MIN, CIE_MAX, CIE_SAMPLES)
_CIE_XYZ_NP = _CIE_1931_TABLE.astype(np.float32)
_CIE_Y_INTEGRAL = float(np.trapezoid(_CIE_XYZ_NP[:, 1], _CIE_LAM))
CIE_XYZ_TABLE = np.asarray(_CIE_XYZ_NP / _CIE_Y_INTEGRAL, np.float32)


def cie1931_xyz(wavelength):
    """Linear interpolation of the CIE table (spectrum.h:148-200):
    wavelength (...,) nm, float32 -> (..., 3) normalised xyz responses, 0
    outside [CIE_MIN, CIE_MAX]."""
    t = (wavelength - CIE_MIN) * ((CIE_SAMPLES - 1) / (CIE_MAX - CIE_MIN))
    active = (wavelength >= CIE_MIN) & (wavelength <= CIE_MAX)
    i0 = torch.clamp(t.to(torch.int32), 0, CIE_SAMPLES - 2).long()
    w1 = (t - i0)[..., None]
    tab = torch.as_tensor(CIE_XYZ_TABLE, device=wavelength.device)
    v = tab[i0] * (1.0 - w1) + tab[i0 + 1] * w1
    return torch.where(active[..., None], v, 0.0)


def _pow5(x):
    """x ** 5 as XLA lowers an integer power: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def blackbody_radiance(wavelength_nm, temperature):
    """Planck's law in float32, spectral radiance in W/m^2/sr/nm
    (src/spectra/blackbody.cpp). The constants divide by 0-d tensors, not
    through ``number / tensor`` (torch computes that as a reciprocal times
    the number)."""
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23
    const = lambda v: torch.tensor(v, dtype=torch.float32,
                                   device=wavelength_nm.device)
    lam = wavelength_nm * 1e-9
    p = const(2.0 * h * c * c) / _pow5(lam) / (
        torch.exp(const(h * c) / (lam * kb * temperature)) - 1.0)
    return p * 1e-9  # per nm

SRGB_TO_XYZ_M = np.asarray(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]], np.float32)

XYZ_TO_SRGB_M = np.asarray(
    [[3.240479, -1.537150, -0.498535],
     [-0.969256, 1.875991, 0.041556],
     [0.055648, -0.204043, 1.057311]], np.float32)


def _apply(m, v):
    """v @ m.T with the float32 matrix widened to v's dtype (the
    reference's promotion in a double variant)."""
    return torch.matmul(v, torch.as_tensor(m.T, dtype=v.dtype,
                                           device=v.device))


def srgb_to_xyz(rgb):
    return _apply(SRGB_TO_XYZ_M, rgb)


def xyz_to_srgb(xyz):
    return _apply(XYZ_TO_SRGB_M, xyz)


def cie1931_y(wavelength):
    return cie1931_xyz(wavelength)[..., 1]


def spectrum_to_xyz(value, wavelengths):
    """Hero-wavelength estimator of XYZ, the mean over the wavelength axis
    (spectrum.h:210-217) as a sum times 1 / nw, jnp.mean's lowering: value
    and wavelengths (..., nw) -> (..., 3)."""
    xyz = cie1931_xyz(wavelengths) * value[..., None]  # (..., nw, 3)
    return channel_mean(xyz.transpose(-1, -2))


def luminance(value, wavelengths=None):
    """Y of linear sRGB values (..., 3) -> (...); with ``wavelengths``,
    the hero-wavelength estimate of Y of spectral values (..., nw)."""
    if wavelengths is not None:
        return channel_mean(cie1931_y(wavelengths) * value)
    return (value[..., 0] * 0.212671 + value[..., 1] * 0.715160
            + value[..., 2] * 0.072169)


def sample_shifted(sample, n=N_HERO):
    """One uniform sample (...,) -> n stratified-shifted samples (..., n)
    in [0, 1) (math.h:419-440)."""
    shift = torch.arange(n, dtype=torch.float32, device=sample.device) / n
    v = sample[..., None] + shift
    return torch.where(v > 1.0, v - 1.0, v)


def sample_uniform_spectrum(sample):
    """Uniform wavelengths over the CIE range, weight = the range's width
    (spectrum.h:250-253) -> (wavelength, weight)."""
    lam = sample * (CIE_MAX - CIE_MIN) + CIE_MIN
    return lam, torch.full_like(lam, CIE_MAX - CIE_MIN)


def pdf_uniform_spectrum(wavelength):
    """The density of sample_uniform_spectrum (the reference keeps it
    consistent with its sampler over the CIE range)."""
    return pdf_uniform_spectrum_cie(wavelength)


def pdf_uniform_spectrum_cie(wavelength):
    ok = (wavelength >= CIE_MIN) & (wavelength <= CIE_MAX)
    return torch.where(ok, 1.0 / (CIE_MAX - CIE_MIN), 0.0)


def sample_rgb_spectrum(sample):
    """Radziszewski's visible importance spectrum, valid only when the
    wavelength range is 360-830 nm; over Eradiate's 280-2400 nm it falls
    back to uniform sampling (spectrum.h:271-285). -> (wavelength,
    weight = 1 / pdf)."""
    if (WAVELENGTH_MIN, WAVELENGTH_MAX) == (360.0, 830.0):
        lam = 538.0 - torch.atanh(
            0.8569106254698279 - 1.8275019724092267 * sample) \
            * 138.88888888888889
        tmp = torch.cosh(0.0072 * (lam - 538.0))
        return lam, 253.82 * tmp * tmp
    return sample_uniform_spectrum(sample)


def pdf_rgb_spectrum(wavelength):
    if (WAVELENGTH_MIN, WAVELENGTH_MAX) == (360.0, 830.0):
        tmp = 1.0 / torch.cosh(0.0072 * (wavelength - 538.0))
        ok = (wavelength >= WAVELENGTH_MIN) & (wavelength <= WAVELENGTH_MAX)
        return torch.where(ok, 0.003939804229326285 * tmp * tmp, 0.0)
    return pdf_uniform_spectrum(wavelength)


def sample_wavelength(sample):
    """A sensor's default wavelengths: stratified hero wavelengths
    (sample_shifted) through sample_rgb_spectrum (spectrum.h:305-313).
    sample (...,) -> (wavelengths (..., 4), weights (..., 4))."""
    return sample_rgb_spectrum(sample_shifted(sample))
