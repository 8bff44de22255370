"""sRGB <-> XYZ color conversion and luminance (the rgb and mono part of
core/spectrum.py)."""

from __future__ import annotations

import numpy as np
import torch

SRGB_TO_XYZ_M = np.asarray(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]], np.float32)

XYZ_TO_SRGB_M = np.asarray(
    [[3.240479, -1.537150, -0.498535],
     [-0.969256, 1.875991, 0.041556],
     [0.055648, -0.204043, 1.057311]], np.float32)


def _apply(m, v):
    return torch.matmul(v, torch.as_tensor(m.T, device=v.device))


def srgb_to_xyz(rgb):
    return _apply(SRGB_TO_XYZ_M, rgb)


def xyz_to_srgb(xyz):
    return _apply(XYZ_TO_SRGB_M, xyz)


def luminance(value):
    """Y of linear sRGB values (..., 3) -> (...)."""
    return (value[..., 0] * 0.212671 + value[..., 1] * 0.715160
            + value[..., 2] * 0.072169)
