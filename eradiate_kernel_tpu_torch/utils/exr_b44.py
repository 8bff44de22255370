"""Pure-Python B44 / B44A scanline-EXR block decoder (utils/exr_b44.py
counterpart; host-side numpy, reading only).

The B44 4x4-block half-float codec re-derived from the public OpenEXR
format specification: per 4x4 block a 16-bit base sample, a 6-bit shift
and 15 chained 6-bit deltas in 14 bytes; B44A also emits 3-byte flat
blocks. Vectorized over blocks in numpy; tests/test_torch_bitmap.py holds
it to files that libOpenEXR writes. B44 is lossy, and nothing in the port
writes it.

Chunk layout (32 scanlines): channels in file (alphabetical) order,
planar: HALF channels as a row-major sequence of 4x4 pixel blocks
(partial edge blocks padded by the encoder, excess pixels discarded
here), non-HALF channels as raw uncompressed rows.
"""

from __future__ import annotations

import numpy as np

_PIXEL_HALF = 1


def _decode14(b):
    """Vectorized 14-byte block decode: b (N, 14) uint16 -> s (N, 16)
    uint16 half-bit patterns (row-major 4x4)."""
    b = b.astype(np.uint16)
    s = np.zeros((len(b), 16), np.uint16)
    s[:, 0] = (b[:, 0] << 8) | b[:, 1]
    shift = (b[:, 2] >> 2).astype(np.uint16)
    bias = (np.uint16(0x20) << shift).astype(np.uint16)
    # the 15 chained 6-bit deltas, in bit order after s0 + shift
    r = np.stack([
        ((b[:, 2] << 4) | (b[:, 3] >> 4)) & 0x3F,
        ((b[:, 3] << 2) | (b[:, 4] >> 6)) & 0x3F,
        b[:, 4] & 0x3F,
        b[:, 5] >> 2,
        ((b[:, 5] << 4) | (b[:, 6] >> 4)) & 0x3F,
        ((b[:, 6] << 2) | (b[:, 7] >> 6)) & 0x3F,
        b[:, 7] & 0x3F,
        b[:, 8] >> 2,
        ((b[:, 8] << 4) | (b[:, 9] >> 4)) & 0x3F,
        ((b[:, 9] << 2) | (b[:, 10] >> 6)) & 0x3F,
        b[:, 10] & 0x3F,
        b[:, 11] >> 2,
        ((b[:, 11] << 4) | (b[:, 12] >> 4)) & 0x3F,
        ((b[:, 12] << 2) | (b[:, 13] >> 6)) & 0x3F,
        b[:, 13] & 0x3F,
    ], 1).astype(np.uint16)
    d = ((r << shift[:, None]) - bias[:, None]).astype(np.uint16)
    # chain order: down column 0, then along each row (uint16 wraparound
    # arithmetic is part of the format)
    s[:, 4] = s[:, 0] + d[:, 0]
    s[:, 8] = s[:, 4] + d[:, 1]
    s[:, 12] = s[:, 8] + d[:, 2]
    s[:, 1] = s[:, 0] + d[:, 3]
    s[:, 5] = s[:, 4] + d[:, 4]
    s[:, 9] = s[:, 8] + d[:, 5]
    s[:, 13] = s[:, 12] + d[:, 6]
    s[:, 2] = s[:, 1] + d[:, 7]
    s[:, 6] = s[:, 5] + d[:, 8]
    s[:, 10] = s[:, 9] + d[:, 9]
    s[:, 14] = s[:, 13] + d[:, 10]
    s[:, 3] = s[:, 2] + d[:, 11]
    s[:, 7] = s[:, 6] + d[:, 12]
    s[:, 11] = s[:, 10] + d[:, 13]
    s[:, 15] = s[:, 14] + d[:, 14]
    return _from_transfer(s)


def _from_transfer(s):
    """Invert the encoder's order-preserving transfer: codes with the top
    bit set were positive halfs (strip it), the rest were negative or
    special (bitwise complement)."""
    neg = (s & 0x8000) == 0
    return np.where(neg, ~s, s & np.uint16(0x7FFF)).astype(np.uint16)


def b44_decompress(buf: bytes, channels, W: int, ny: int,
                   b44a: bool = False) -> bytes:
    """Decode one B44/B44A chunk -> raw scanline-interleaved bytes
    (ny rows x channels-in-order). channels: [(name, pixel_type)] in file
    order; pixel sizes 2 (HALF) or 4 (FLOAT/UINT)."""
    data = np.frombuffer(buf, np.uint8)
    nbx = -(-W // 4)
    nby = -(-ny // 4)
    n_blocks = nbx * nby
    planes = []
    pos = 0
    for _name, ptype in channels:
        if ptype != _PIXEL_HALF:
            nbytes = W * ny * 4
            planes.append(("raw", data[pos:pos + nbytes].tobytes()))
            pos += nbytes
            continue
        if not b44a:
            blk = data[pos:pos + 14 * n_blocks].reshape(n_blocks, 14)
            pos += 14 * n_blocks
            s = _decode14(blk)
        else:
            # B44A: 3-byte flat blocks (third byte 0xFC) mixed with
            # 14-byte blocks — sizes are data-dependent, so walk the
            # stream once for offsets, then decode each class batched
            offs = np.empty(n_blocks, np.int64)
            flat = np.empty(n_blocks, bool)
            p = pos
            for i in range(n_blocks):
                offs[i] = p
                f = data[p + 2] == 0xFC
                flat[i] = f
                p += 3 if f else 14
            pos = p
            s = np.empty((n_blocks, 16), np.uint16)
            if flat.any():
                fo = offs[flat]
                v = ((data[fo].astype(np.uint16) << 8)
                     | data[fo + 1]).astype(np.uint16)
                s[flat] = _from_transfer(v)[:, None]
            if (~flat).any():
                fo = offs[~flat]
                blk = data[fo[:, None] + np.arange(14)]
                s[~flat] = _decode14(blk)
        # (nby, nbx, 4, 4) -> padded rows/cols -> crop to (ny, W)
        grid = s.reshape(nby, nbx, 4, 4).transpose(0, 2, 1, 3) \
                .reshape(nby * 4, nbx * 4)[:ny, :W]
        planes.append(("half", grid.astype("<u2").tobytes()))

    # re-interleave planar -> per-scanline channel-ordered raw bytes
    out = bytearray()
    cursors = [0] * len(planes)
    sizes = [2 * W if k == "half" else 4 * W for k, _ in planes]
    for _y in range(ny):
        for ci, (kind, pdata) in enumerate(planes):
            c = cursors[ci]
            out += pdata[c:c + sizes[ci]]
            cursors[ci] = c + sizes[ci]
    return bytes(out)
