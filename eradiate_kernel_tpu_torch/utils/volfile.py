"""Mitsuba binary volume (.vol) codec.

The reference's gridvolume/gridvolume_spectral plugins load their data from
`.vol` files (src/textures/volume_data.h:44-104 read_binary_volume_data):

    bytes 0-2   'V' 'O' 'L'
    byte  3     version (uint8, must be 3)
    int32       data type (1 = float32 — the only supported encoding)
    int32 x 3   shape (xres, yres, zres)
    int32       channel count
    float32 x 6 axis-aligned bbox (xmin, ymin, zmin, xmax, ymax, zmax)
    float32 x (xres*yres*zres*channels)  data, x index varying fastest

The returned array uses this package's (D, H, W, C) = (z, y, x, channels)
grid convention, which matches the file's x-fastest layout directly.
"""

from __future__ import annotations

import struct

import numpy as np

_HEADER = struct.Struct("<3sB5i6f")


def read_vol(path: str):
    """Read a .vol file -> (data (D, H, W, C) float32, bbox (2, 3) float32).

    bbox rows are (min, max) — the grid's placement in object space; the
    loader composes it into world_to_local when `use_grid_bbox` is set
    (grid3d.cpp:152-154)."""
    with open(path, "rb") as f:
        buf = f.read(_HEADER.size)
        if len(buf) < _HEADER.size:
            raise ValueError(f"{path}: truncated .vol header")
        magic, version, dtype, xres, yres, zres, nch, *dims = \
            _HEADER.unpack(buf)
        if magic != b"VOL":
            raise ValueError(f"{path}: not a .vol file (magic {magic!r})")
        if version != 3:
            raise ValueError(f"{path}: unsupported .vol version {version} "
                             "(only 3)")
        if dtype != 1:
            raise ValueError(f"{path}: unsupported data type {dtype} "
                             "(only 1 = float32)")
        n = xres * yres * zres * nch
        data = np.fromfile(f, dtype="<f4", count=n)
        if data.size != n:
            raise ValueError(f"{path}: truncated .vol data "
                             f"({data.size} of {n} floats)")
    bbox = np.asarray(dims, np.float32).reshape(2, 3)
    return data.reshape(zres, yres, xres, nch), bbox


def write_vol(path: str, data, bbox=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))):
    """Write (D, H, W[, C]) float data as a version-3 float32 .vol file."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3:
        data = data[..., None]
    if data.ndim != 4:
        raise ValueError(f"write_vol wants (D, H, W[, C]), got {data.shape}")
    d, h, w, c = data.shape
    bbox = np.asarray(bbox, np.float32).reshape(2, 3)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(b"VOL", 3, 1, w, h, d, c,
                             *bbox.reshape(-1).tolist()))
        f.write(np.ascontiguousarray(data, "<f4").tobytes())
