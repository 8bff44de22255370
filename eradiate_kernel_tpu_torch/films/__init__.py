"""Film accumulation and development (films/__init__.py counterpart).

The film is an (H, W, 5) tensor with channels [X, Y, Z, A, W]."""

from __future__ import annotations

import torch

from ..core.spectrum import xyz_to_srgb
from ..rfilters import filter_radius

N_BASE_CHANNELS = 5  # X, Y, Z, A, W


def film_put(image, pos, values, rfilter_kind: str, rfilter_params=None):
    """Add samples into the film in place and return it. image: (H, W, C);
    pos: (N, 2) continuous pixel coords (x, y); values: (N, C). A filter of
    radius <= 0.5 puts each sample into exactly one pixel."""
    H, W, _ = image.shape
    if filter_radius(rfilter_kind, rfilter_params) > 0.5 + 1e-6:
        raise NotImplementedError(
            "film_put: only single-pixel filters (radius <= 0.5) so far")
    px = torch.clamp(pos[:, 0].to(torch.int64), 0, W - 1)
    py = torch.clamp(pos[:, 1].to(torch.int64), 0, H - 1)
    return image.index_put_((py, px), values, accumulate=True)


def develop(image, pixel_format: str = "rgb"):
    """Weight-divide and convert XYZ (hdrfilm.cpp develop): 'rgb' (linear
    sRGB), 'rgba' (+ alpha), 'xyz' or 'luminance'."""
    w = torch.clamp(image[..., 4:5], min=1e-12)
    xyz = image[..., 0:3] / w
    if pixel_format == "luminance":
        return xyz[..., 1:2]
    if pixel_format == "xyz":
        return xyz
    rgb = xyz_to_srgb(xyz)
    if pixel_format == "rgba":
        return torch.cat([rgb, image[..., 3:4] / w], dim=-1)
    return rgb
