"""Film accumulation and development (films/__init__.py counterpart).

The film is an (H, W, 5) tensor with channels [X, Y, Z, A, W]."""

from __future__ import annotations

import torch

from ..core.spectrum import xyz_to_srgb
from ..rfilters import filter_radius

N_BASE_CHANNELS = 5  # X, Y, Z, A, W


def _pixels(image, pos, rfilter_kind, rfilter_params, what):
    """(py, px): the one pixel of each sample under a filter of radius
    <= 0.5 (positions clamped to the film); wider filters raise."""
    H, W, _ = image.shape
    if filter_radius(rfilter_kind, rfilter_params) > 0.5 + 1e-6:
        raise NotImplementedError(
            f"{what}: only single-pixel filters (radius <= 0.5) so far; "
            "wider filters come with slice 5")
    px = torch.clamp(pos[:, 0].to(torch.int64), 0, W - 1)
    py = torch.clamp(pos[:, 1].to(torch.int64), 0, H - 1)
    return py, px


def film_put(image, pos, values, rfilter_kind: str, rfilter_params=None):
    """Add samples into the film in place and return it. image: (H, W, C);
    pos: (N, 2) continuous pixel coords (x, y); values: (N, C). A filter of
    radius <= 0.5 puts each sample into exactly one pixel."""
    return image.index_put_(
        _pixels(image, pos, rfilter_kind, rfilter_params, "film_put"),
        values, accumulate=True)


def film_gather(image, pos, rfilter_kind: str, rfilter_params=None):
    """The adjoint of film_put: image (H, W, C), a cotangent film; pos
    (N, 2) -> (N, C), the film's value at each sample's pixel, so that
    <film_put(0, pos, v), image> == <v, film_gather(image, pos)>."""
    return image[_pixels(image, pos, rfilter_kind, rfilter_params,
                         "film_gather")]


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
