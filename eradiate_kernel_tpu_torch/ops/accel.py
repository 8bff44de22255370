"""Triangle-tile acceleration structure (ops/accel.py counterpart).

Triangles are sorted along a 30-bit Morton curve of their centroids and cut
into tiles of K=128 with conservative AABBs. The host-side build is the
native builder csrc/tile_builder.cpp (the reference's, built with g++ at
first use by utils/native_cache.py); ``_build_tiles_numpy`` is its plain
version, which computes the same float32 centroids, Morton codes and
stable order and which the builder falls back to only where there is no
g++. The packed arrays are bit-equal to the reference's ``pack_tiles``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils.native_cache import host_builder

TILE_K = 128  # triangles per tile


def _expand_bits(v):
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _builder():
    lib = host_builder("tile_builder")
    if lib is not None:
        lib.build_tri_tiles.restype = ctypes.c_int
        lib.build_tri_tiles.argtypes = [_F32P, ctypes.c_int64, _I32P,
                                        ctypes.c_int64, ctypes.c_int, _I32P,
                                        _F32P, _F32P]
    return lib


def build_tri_tiles(vertices, faces, tile_size=TILE_K):
    """(perm (T*K,) i32 with -1 padding, tile_lo (T, 3), tile_hi (T, 3)),
    by the native builder (its numpy version where there is no g++)."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    lib = _builder()
    if lib is None:
        return _build_tiles_numpy(vertices, faces, tile_size)
    F = len(faces)
    T = -(-F // tile_size)
    perm = np.empty(T * tile_size, np.int32)
    tile_lo = np.empty((T, 3), np.float32)
    tile_hi = np.empty((T, 3), np.float32)
    n = lib.build_tri_tiles(vertices.ctypes.data_as(_F32P), len(vertices),
                            faces.ctypes.data_as(_I32P), F, tile_size,
                            perm.ctypes.data_as(_I32P),
                            tile_lo.ctypes.data_as(_F32P),
                            tile_hi.ctypes.data_as(_F32P))
    if n != T:
        raise RuntimeError(f"tile_builder returned {n} tiles, not {T}")
    return perm, tile_lo, tile_hi


def _build_tiles_numpy(vertices, faces, tile_size=TILE_K):
    """The plain version of csrc/tile_builder.cpp (the same algorithm)."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    tri = vertices[faces]                      # (F, 3, 3)
    centroid = tri.mean(axis=1)
    lo = centroid.min(0)
    ext = np.maximum(centroid.max(0) - lo, 1e-20)
    q = np.clip(((centroid - lo) / ext * 1024), 0, 1023).astype(np.uint64)
    code = ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))
    order = np.argsort(code, kind="stable").astype(np.int32)
    F = len(faces)
    T = -(-F // tile_size)
    perm = np.full(T * tile_size, -1, np.int32)
    perm[:F] = order
    # per-tile bounds over full triangles; padding entries cannot win a
    # min or max
    pts = tri[np.maximum(perm, 0)].reshape(T, tile_size, 3, 3)
    real = (perm >= 0).reshape(T, tile_size, 1, 1)
    tile_lo = np.where(real, pts, np.float32(1e30)).min(axis=(1, 2))
    tile_hi = np.where(real, pts, np.float32(-1e30)).max(axis=(1, 2))
    return perm, tile_lo.astype(np.float32), tile_hi.astype(np.float32)


def pack_tiles(vertices, faces, face_shape, tile_size=TILE_K):
    """The intersector's tile arrays, as a dict of numpy arrays:

      v0/e1/e2: (T, K, 3) pre-gathered triangle data
      prim:     (T, K) i32 original face index (-1 = padding)
      shape:    (T, K) i32 shape index of each triangle (-1 = padding)
      lo/hi:    (T, 3) tile AABBs

    Padding triangles sit at a far-away degenerate point (v0 = 1e30,
    e1 = e2 = 0), so their determinant is 0 and they never hit.
    """
    perm, tile_lo, tile_hi = build_tri_tiles(vertices, faces, tile_size)
    T = len(tile_lo)
    safe = np.maximum(perm, 0)
    f = faces[safe]
    v0 = vertices[f[:, 0]]
    v1 = vertices[f[:, 1]]
    v2 = vertices[f[:, 2]]
    pad = perm < 0
    v0[pad] = 1e30
    v1[pad] = 1e30
    v2[pad] = 1e30
    shape = face_shape[safe].astype(np.int32)
    shape[pad] = -1
    return {
        "v0": v0.reshape(T, tile_size, 3).astype(np.float32),
        "e1": (v1 - v0).reshape(T, tile_size, 3).astype(np.float32),
        "e2": (v2 - v0).reshape(T, tile_size, 3).astype(np.float32),
        "prim": perm.reshape(T, tile_size),
        "shape": shape.reshape(T, tile_size),
        "lo": tile_lo,
        "hi": tile_hi,
    }
