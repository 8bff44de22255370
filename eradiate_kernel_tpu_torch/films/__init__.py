"""Film accumulation and development (films/__init__.py counterpart).

The film is an (H, W, 5) tensor with channels [X, Y, Z, A, W]. A filter of
radius <= 0.5 puts each sample into one pixel; a wider one splats it over
``n = int(2r + 0.999) + 1`` taps an axis from ``floor(pos - r + 0.5)``
with separable weights (imageblock.cpp), taps outside the film weighing 0.
``film_gather`` is the adjoint of ``film_put`` over the same taps;
``save`` develops a film and writes it to an image file."""

from __future__ import annotations

import numpy as np
import torch

from ..core.spectrum import xyz_to_srgb
from ..rfilters import eval_filter, filter_radius
from ..utils import bitmap

N_BASE_CHANNELS = 5  # X, Y, Z, A, W


def _single_pixel(kind, params):
    return filter_radius(kind, params) <= 0.5 + 1e-6


def _pixels(image, pos):
    """(py, px): each sample's one pixel (positions clamped to the film)."""
    H, W, _ = image.shape
    px = torch.clamp(pos[:, 0].to(torch.int64), 0, W - 1)
    py = torch.clamp(pos[:, 1].to(torch.int64), 0, H - 1)
    return py, px


def _taps(image, pos, kind, params):
    """The footprint of each sample under a wide filter: (iy, ix) (N, n)
    tap rows and columns clamped into the film, and (wy, wx) (N, n) their
    weights, 0 for taps outside the film."""
    H, W, _ = image.shape
    radius = filter_radius(kind, params)
    n = int(2 * radius + 0.999) + 1
    taps = torch.arange(n, device=pos.device)
    tap_x = torch.floor(pos[:, 0] - radius + 0.5).to(torch.int64)[:, None] \
        + taps
    tap_y = torch.floor(pos[:, 1] - radius + 0.5).to(torch.int64)[:, None] \
        + taps
    wx = eval_filter(kind, (tap_x.to(torch.float32) + 0.5) - pos[:, 0:1],
                     params)
    wy = eval_filter(kind, (tap_y.to(torch.float32) + 0.5) - pos[:, 1:2],
                     params)
    wx = torch.where((tap_x >= 0) & (tap_x < W), wx, 0.0)
    wy = torch.where((tap_y >= 0) & (tap_y < H), wy, 0.0)
    return (torch.clamp(tap_y, 0, H - 1), torch.clamp(tap_x, 0, W - 1),
            wy, wx)


def film_put(image, pos, values, rfilter_kind: str, rfilter_params=None):
    """Add samples into the film in place and return it. image: (H, W, C);
    pos: (N, 2) continuous pixel coords (x, y); values: (N, C).

    A wide filter adds one tap row at a time (n index_add_ calls of N * n
    rows: the update tensor stays (N * n, C)); index_add_ accumulates with
    atomics on the card, so the film's sums come in no fixed order there."""
    if _single_pixel(rfilter_kind, rfilter_params):
        return image.index_put_(_pixels(image, pos), values, accumulate=True)
    H, W, C = image.shape
    iy, ix, wy, wx = _taps(image, pos, rfilter_kind, rfilter_params)
    flat = image.view(H * W, C)
    for r in range(iy.shape[1]):
        w = wy[:, r:r + 1] * wx                              # (N, n)
        lin = iy[:, r:r + 1] * W + ix                        # (N, n)
        flat.index_add_(0, lin.reshape(-1),
                        (values[:, None, :] * w[..., None]).reshape(-1, C))
    return image


def film_gather(image, pos, rfilter_kind: str, rfilter_params=None):
    """The adjoint of film_put: image (H, W, C), a cotangent film; pos
    (N, 2) -> (N, C), the filter-weighted sum of the film over each
    sample's taps, so that <film_put(0, pos, v), image> ==
    <v, film_gather(image, pos)>."""
    if _single_pixel(rfilter_kind, rfilter_params):
        return image[_pixels(image, pos)]
    H, W, C = image.shape
    iy, ix, wy, wx = _taps(image, pos, rfilter_kind, rfilter_params)
    flat = image.reshape(H * W, C)
    out = torch.zeros(pos.shape[0], C, dtype=image.dtype, device=image.device)
    for r in range(iy.shape[1]):
        rows = flat[iy[:, r:r + 1] * W + ix]                 # (N, n, C)
        out = out + torch.sum(rows * (wy[:, r:r + 1] * wx)[..., None], dim=1)
    return out


def develop(image, mode: str = "rgb", pixel_format: str = "rgb"):
    """Weight-divide and convert XYZ (hdrfilm.cpp develop): 'rgb' (linear
    sRGB), 'rgba' (+ alpha), 'xyz' or 'luminance'; a ``mode="mono"`` film
    develops to its luminance (H, W, 1) whatever the format."""
    w = torch.clamp(image[..., 4:5], min=1e-12)
    xyz = image[..., 0:3] / w
    if mode == "mono" or pixel_format == "luminance":
        return xyz[..., 1:2]
    if pixel_format == "xyz":
        return xyz
    rgb = xyz_to_srgb(xyz)
    if pixel_format == "rgba":
        return torch.cat([rgb, image[..., 3:4] / w], dim=-1)
    return rgb


def save(path: str, image, mode: str = "rgb", pixel_format: str = "rgb",
         aovs: dict | None = None):
    """Develop a raw film (on any device) and write it from host memory
    (hdrfilm's develop-to-file): '.exr' as f32 ZIP with channels Y, RGB
    or RGBA and then the ``aovs`` (name -> (H, W) image) under their
    names; '.pfm', '.ppm' and '.hdr'/'.rgbe' in their formats; anything
    else as PNG with the sRGB transfer."""
    def host(a):
        return np.asarray(a.detach().cpu() if torch.is_tensor(a) else a)

    img = host(develop(image, mode, pixel_format))
    low = path.lower()
    if low.endswith(".exr"):
        names = {1: ["Y"], 3: ["R", "G", "B"],
                 4: ["R", "G", "B", "A"]}[img.shape[-1]]
        if aovs:
            extra = np.stack([host(v) for v in aovs.values()], -1)
            img = np.concatenate([img, extra], -1)
            names = names + list(aovs)
        bitmap.write_exr(path, img, names)
    elif low.endswith(".pfm"):
        bitmap.write_pfm(path, img)
    elif low.endswith(".ppm"):
        bitmap.write_ppm(path, img)
    elif low.endswith((".hdr", ".rgbe")):
        bitmap.write_rgbe(path, img)
    else:
        bitmap.write_png(path, img)
