"""Mitsuba's tensor-file exchange format, read and written with numpy and
the standard library (utils/tensorfile.py counterpart; the measured BSDF's
``.bsdf`` files).

The format is a flat binary container of named n-d arrays:

    bytes 0-11   "tensor_file\\0"
    bytes 12-13  version (1, 0)
    u32          field count
    per field:   u16 name length, name bytes, u16 ndim, u8 dtype,
                 u64 absolute data offset, ndim x u64 shape
    ...          raw little-endian array data at the recorded offsets

dtype codes follow Mitsuba's Struct::Type. Files are read whole: tables are
prepared once at scene build, off the hot path.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = b"tensor_file\x00"

# Struct::Type codes (struct.h:26-38)
_DTYPES = {
    1: np.uint8, 2: np.int8,
    3: np.uint16, 4: np.int16,
    5: np.uint32, 6: np.int32,
    7: np.uint64, 8: np.int64,
    9: np.float16, 10: np.float32, 11: np.float64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def read_tensor_file(path) -> dict:
    """Load every field of a tensor file as {name: numpy array}."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:12] != _MAGIC:
        raise ValueError(f"{path}: not a tensor file (bad magic)")
    n_fields, = struct.unpack_from("<I", raw, 14)
    fields = {}
    pos = 18
    for _ in range(n_fields):
        name_len, = struct.unpack_from("<H", raw, pos)
        pos += 2
        name = raw[pos:pos + name_len].decode("utf-8")
        pos += name_len
        ndim, dtype_code = struct.unpack_from("<HB", raw, pos)
        pos += 3
        offset, = struct.unpack_from("<Q", raw, pos)
        pos += 8
        shape = struct.unpack_from(f"<{ndim}Q", raw, pos)
        pos += 8 * ndim
        if dtype_code not in _DTYPES:
            raise ValueError(f"{path}: field {name!r} has unknown dtype "
                             f"code {dtype_code}")
        dt = np.dtype(_DTYPES[dtype_code]).newbyteorder("<")
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(raw, dtype=dt, count=count, offset=offset)
        fields[name] = arr.reshape(shape).astype(_DTYPES[dtype_code])
    return fields


def write_tensor_file(path, fields: dict) -> None:
    """Write {name: array-like} in the reference's tensor-file layout."""
    arrays = {}
    for name, value in fields.items():
        if isinstance(value, str):
            value = np.frombuffer(value.encode("utf-8"), np.uint8)
        arr = np.ascontiguousarray(value)
        if arr.dtype not in _CODES:
            raise ValueError(f"field {name!r}: unsupported dtype {arr.dtype}")
        arrays[name] = arr

    header_size = 12 + 2 + 4
    for name, arr in arrays.items():
        header_size += 2 + len(name.encode()) + 2 + 1 + 8 + 8 * arr.ndim

    out = bytearray()
    out += _MAGIC
    out += bytes([1, 0])
    out += struct.pack("<I", len(arrays))
    offset = header_size
    for name, arr in arrays.items():
        nb = name.encode("utf-8")
        out += struct.pack("<H", len(nb))
        out += nb
        out += struct.pack("<HB", arr.ndim, _CODES[arr.dtype])
        out += struct.pack("<Q", offset)
        out += struct.pack(f"<{arr.ndim}Q", *arr.shape)
        offset += arr.nbytes
    assert len(out) == header_size
    for arr in arrays.values():
        out += arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))
