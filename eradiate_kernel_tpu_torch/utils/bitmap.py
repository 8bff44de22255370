"""Image IO: the Bitmap analog (utils/bitmap.py counterpart; Mitsuba's
src/libcore/bitmap.cpp). Host-side numpy: files are read and written from
host memory, once at scene build or after a render.

- Scanline OpenEXR, pure Python: NONE/RLE/ZIPS/ZIP/PIZ/PXR24 read and
  write, B44/B44A read, f32/f16/u32 channels (the wavelet/Huffman, 24-bit
  float and 4x4-block codecs in exr_piz.py and exr_b44.py, re-derived from
  the public format). DWAA and DWAB are read only through a native
  OpenEXR loader, which the port does not have yet: they raise.
- PFM, binary PPM and Radiance RGBE (.hdr) read and write.
- PNG and other LDR formats through PIL (imported where it is used), with
  the sRGB transfer.

The writers produce the bytes of the reference's pure-Python writers.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_EXR_MAGIC = 20000630
_PIXEL_HALF = 1   # OpenEXR HALF (f16)
_PIXEL_FLOAT = 2  # OpenEXR FLOAT (f32)

# compression enum (OpenEXR ImfCompression.h) -> scanlines per chunk
_COMPRESSION = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4,
                "pxr24": 5}
_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16, 6: 32, 7: 32}
_DWA = {8: "DWAA", 9: "DWAB"}


def _attr(name: str, type_: str, payload: bytes) -> bytes:
    return (name.encode() + b"\x00" + type_.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload)


# --- OpenEXR ZIP/RLE byte transforms (ImfZip.cpp / ImfRle.cpp) ---------------
#
# Both codecs pre-transform the raw chunk bytes: de-interleave even/odd bytes
# into two halves, then delta-encode (d[i] = b[i] - b[i-1] + 128 mod 256).
# The transforms below are vectorized NumPy re-derivations of that public
# spec, not ports of the C++.

def _predictor_encode(b: np.ndarray) -> np.ndarray:
    d = b.astype(np.int16)
    d[1:] = d[1:] - d[:-1] + 128
    return (d % 256).astype(np.uint8)


def _predictor_decode(b: np.ndarray) -> np.ndarray:
    # t[i] = t[i-1] + b[i] - 128  =>  prefix sum
    c = np.cumsum(b.astype(np.int64)) - 128 * np.arange(len(b), dtype=np.int64)
    return (c % 256).astype(np.uint8)


def _interleave_split(b: np.ndarray) -> np.ndarray:
    """Even bytes first, odd bytes second (compress direction)."""
    return np.concatenate([b[0::2], b[1::2]])


def _interleave_merge(b: np.ndarray) -> np.ndarray:
    """Inverse of _interleave_split (decompress direction)."""
    n = len(b)
    h = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = b[:h]
    out[1::2] = b[h:]
    return out


def _exr_pack(raw: bytes) -> bytes:
    return _predictor_encode(
        _interleave_split(np.frombuffer(raw, np.uint8))).tobytes()


def _exr_unpack(buf: bytes) -> bytes:
    return _interleave_merge(
        _predictor_decode(np.frombuffer(buf, np.uint8))).tobytes()


def _rle_compress(data: bytes) -> bytes:
    """OpenEXR RLE: signed count byte; < 0 -> -count literals, >= 0 ->
    count+1 repeats of the next byte (ImfRle.cpp contract)."""
    out = bytearray()
    b = np.frombuffer(data, np.uint8)
    n = len(b)
    i = 0
    MAX_RUN = 127
    while i < n:
        run = 1
        while i + run < n and b[i + run] == b[i] and run < MAX_RUN + 1:
            run += 1
        if run >= 3:
            out.append(run - 1)
            out.append(int(b[i]))
            i += run
        else:
            # literal run: until the next >=3 repeat or MAX_RUN
            j = i
            while (j < n and j - i < MAX_RUN
                   and not (j + 2 < n and b[j] == b[j + 1] == b[j + 2])):
                j += 1
            out.append(256 - (j - i))  # -(count) as unsigned byte
            out.extend(b[i:j].tobytes())
            i = j
    return bytes(out)


def _rle_decompress(data: bytes, out_size: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < out_size:
        count = data[i]
        i += 1
        if count > 127:           # negative int8: literal copy
            c = 256 - count
            out.extend(data[i:i + c])
            i += c
        else:                     # repeat next byte count+1 times
            out.extend(data[i:i + 1] * (count + 1))
            i += 1
    if len(out) != out_size:
        raise ValueError(f"RLE output size {len(out)} != {out_size}")
    return bytes(out)


def _compress_chunk(raw: bytes, compression: int, channels=None, W=0,
                    ny=0) -> bytes:
    if compression == 0:
        return raw
    if compression == 1:
        packed = _rle_compress(_exr_pack(raw))
    elif compression in (2, 3):
        packed = zlib.compress(_exr_pack(raw))
    elif compression == 4:
        from .exr_piz import piz_compress

        packed = piz_compress(raw, channels, W, ny)
    elif compression == 5:
        from .exr_piz import pxr24_compress

        packed = pxr24_compress(raw, channels, W, ny)
    else:
        raise ValueError(f"unsupported EXR compression {compression}")
    # OpenEXR stores raw when compression does not shrink the chunk
    return packed if len(packed) < len(raw) else raw


def _decompress_chunk(buf: bytes, raw_size: int, compression: int,
                      channels=None, W=0, ny=0) -> bytes:
    if compression == 0 or len(buf) >= raw_size:
        return buf
    if compression == 1:
        return _exr_unpack(_rle_decompress(buf, raw_size))
    if compression in (2, 3):
        return _exr_unpack(zlib.decompress(buf))
    if compression == 4:
        from .exr_piz import piz_decompress

        return piz_decompress(buf, channels, W, ny)
    if compression == 5:
        from .exr_piz import pxr24_decompress

        return pxr24_decompress(buf, channels, W, ny)
    if compression in (6, 7):
        from .exr_b44 import b44_decompress

        return b44_decompress(buf, channels, W, ny, b44a=compression == 7)
    raise ValueError(
        f"unsupported EXR compression {compression} (supported: "
        f"none/rle/zips/zip/piz/pxr24 + b44/b44a read)")


def write_exr(path: str, img, channel_names=None, compression="zip",
              pixel_type="f32"):
    """Write (H, W) or (H, W, C) float data as a scanline EXR.

    compression: 'none' | 'rle' | 'zips' | 'zip' (OpenEXR default) | 'piz'
    | 'pxr24'. pixel_type: 'f32' | 'f16'. Channels are stored sorted by
    name within each scanline, as OpenEXR stores them.
    """
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if channel_names is None:
        channel_names = {1: ["Y"], 2: ["R", "G"], 3: ["R", "G", "B"],
                         4: ["R", "G", "B", "A"]}.get(C) or \
            [f"ch{i}" for i in range(C)]
    # b44/dwa requests are written as zip (still a valid EXR, as the
    # reference's pure writer does)
    comp = _COMPRESSION.get(compression, _COMPRESSION["zip"])
    lines_pb = _LINES_PER_BLOCK[comp]
    ptype = _PIXEL_FLOAT if pixel_type == "f32" else _PIXEL_HALF
    dtype = np.float32 if pixel_type == "f32" else np.float16
    if len(channel_names) != C:
        raise ValueError(
            f"{len(channel_names)} channel names for {C} channels")
    # EXR stores channels sorted alphabetically within each scanline
    order = sorted(range(C), key=lambda i: channel_names[i])

    chan_payload = b""
    for i in order:
        chan_payload += (channel_names[i].encode() + b"\x00"
                         + struct.pack("<iiii", ptype, 0, 1, 1))
    chan_payload += b"\x00"

    header = b""
    header += _attr("channels", "chlist", chan_payload)
    header += _attr("compression", "compression", bytes([comp]))
    header += _attr("dataWindow", "box2i",
                    struct.pack("<iiii", 0, 0, W - 1, H - 1))
    header += _attr("displayWindow", "box2i",
                    struct.pack("<iiii", 0, 0, W - 1, H - 1))
    header += _attr("lineOrder", "lineOrder", b"\x00")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    head = struct.pack("<ii", _EXR_MAGIC, 2) + header
    n_blocks = -(-H // lines_pb)

    chunks = []
    for bi in range(n_blocks):
        y0 = bi * lines_pb
        ny = min(lines_pb, H - y0)
        raw = b"".join(
            np.ascontiguousarray(img[y0 + dy, :, i]).astype(dtype).tobytes()
            for dy in range(ny) for i in order)
        chans = [(channel_names[i], ptype) for i in order]
        chunks.append((y0, _compress_chunk(raw, comp, chans, W, ny)))

    offset = len(head) + 8 * n_blocks
    with open(path, "wb") as f:
        f.write(head)
        for y0, payload in chunks:
            f.write(struct.pack("<Q", offset))
            offset += 8 + len(payload)
        for y0, payload in chunks:
            f.write(struct.pack("<ii", y0, len(payload)))
            f.write(payload)


def read_exr(path: str):
    """Read a scanline EXR -> (img (H, W, C) f32, names): none, rle, zips,
    zip, piz, pxr24, b44 and b44a; f32, f16 and u32 channels. RGB(A)
    channels come in R, G, B, A order, others in the file's (sorted)
    order."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version = struct.unpack_from("<ii", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if _version & 0x200:
        raise ValueError(f"{path}: tiled EXRs are not supported")
    pos = 8
    channels = []
    compression = None
    dw = None

    def cstr():
        nonlocal pos
        end = data.index(b"\x00", pos)
        s = data[pos:end].decode()
        pos = end + 1
        return s

    while True:
        if data[pos] == 0:
            pos += 1
            break
        name = cstr()
        _type = cstr()
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                e = payload.index(b"\x00", p)
                cname = payload[p:e].decode()
                ptype, _plin, sx, sy = struct.unpack_from("<iiii", payload,
                                                          e + 1)
                if sx != 1 or sy != 1:
                    raise ValueError(f"{path}: subsampled channels are not "
                                     "supported")
                channels.append((cname, ptype))
                p = e + 1 + 16
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", payload)
    if compression in _DWA:
        raise NotImplementedError(
            f"{path}: {_DWA[compression]} compression is read by a native "
            "OpenEXR loader, which comes with slice 7b; write the file with "
            "another compression")
    if compression not in (0, 1, 2, 3, 4, 5, 6, 7):
        raise ValueError(
            f"unsupported EXR compression {compression} (supported: "
            f"none/rle/zips/zip/piz/pxr24 + b44/b44a read)")
    lines_pb = _LINES_PER_BLOCK[compression]
    x0, y0, x1, y1 = dw
    W = x1 - x0 + 1
    H = y1 - y0 + 1
    C = len(channels)
    psizes = [{_PIXEL_HALF: 2, _PIXEL_FLOAT: 4, 0: 4}[pt]
              for _n, pt in channels]
    line_bytes = W * sum(psizes)
    n_blocks = -(-H // lines_pb)
    offsets = struct.unpack_from("<" + "Q" * n_blocks, data, pos)
    img = np.zeros((H, W, C), np.float32)
    for off in offsets:
        y, size = struct.unpack_from("<ii", data, off)
        yb = y - y0
        ny = min(lines_pb, H - yb)
        raw = _decompress_chunk(data[off + 8:off + 8 + size],
                                ny * line_bytes, compression, channels, W, ny)
        p = 0
        for dy in range(ny):
            for ci, (_cname, ptype) in enumerate(channels):
                if ptype == _PIXEL_FLOAT:
                    row = np.frombuffer(raw, np.float32, W, p)
                    p += 4 * W
                elif ptype == _PIXEL_HALF:
                    row = np.frombuffer(raw, np.float16, W,
                                        p).astype(np.float32)
                    p += 2 * W
                elif ptype == 0:  # UINT
                    row = np.frombuffer(raw, np.uint32, W,
                                        p).astype(np.float32)
                    p += 4 * W
                else:
                    raise ValueError(f"unsupported pixel type {ptype}")
                img[yb + dy, :, ci] = row
    names = [c[0] for c in channels]
    # reorder RGB(A) conventionally if present
    want = [n for n in ("R", "G", "B", "A") if n in names]
    if len(want) == C:
        idx = [names.index(n) for n in want]
        img = img[..., idx]
        names = want
    return img, names


def write_png(path: str, img, gamma=True):
    """LDR output with sRGB transfer (bitmap.cpp gamma conversion)."""
    from PIL import Image

    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    if gamma:
        a = np.clip(img, 0.0, 1.0)
        img = np.where(a <= 0.0031308, 12.92 * a,
                       1.055 * a ** (1 / 2.4) - 0.055)
    Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)) \
        .save(path)


def read_image(path: str):
    """Generic loader: EXR/PFM/PPM/HDR via the native codecs, everything
    else via PIL; returns linear float32 (H, W, C)."""
    low = path.lower()
    if low.endswith(".exr"):
        return read_exr(path)[0]
    if low.endswith(".pfm"):
        return read_pfm(path)
    if low.endswith(".ppm"):
        return read_ppm(path)
    if low.endswith((".hdr", ".rgbe")):
        return read_rgbe(path)
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    # undo sRGB transfer
    return np.where(img <= 0.04045, img / 12.92,
                    ((img + 0.055) / 1.055) ** 2.4).astype(np.float32)


# -----------------------------------------------------------------------------
# PFM / PPM / RGBE — the reference's remaining HDR/portable formats
# (bitmap.cpp FileFormat::{PFM,PPM,RGBE})
# -----------------------------------------------------------------------------

def write_pfm(path: str, img):
    """Portable FloatMap: 'PF' (rgb) / 'Pf' (gray), little-endian, rows
    bottom-up (bitmap.cpp write_pfm)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c == 1:
        header, data = b"Pf", img[..., 0]
    else:
        if c != 3:
            img = img[..., :3] if c > 3 else np.repeat(img, 3, -1)[..., :3]
        header, data = b"PF", img
    with open(path, "wb") as f:
        f.write(header + b"\n%d %d\n-1.0\n" % (w, h))
        f.write(np.ascontiguousarray(data[::-1]).tobytes())


def read_pfm(path: str):
    """Read PFM -> linear float32 (H, W, C)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        w, h = (int(x) for x in f.readline().split())
        scale = float(f.readline())
        c = 3 if magic == b"PF" else 1
        dt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * c * 4), dt).reshape(h, w, c)
    return np.ascontiguousarray(data[::-1]).astype(np.float32)


def write_ppm(path: str, img, gamma=True):
    """Binary PPM (P6) with sRGB transfer (bitmap.cpp write_ppm)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    img = img[..., :3]
    if gamma:
        a = np.clip(img, 0.0, 1.0)
        img = np.where(a <= 0.0031308, 12.92 * a,
                       1.055 * a ** (1 / 2.4) - 0.055)
    u8 = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    h, w, _ = u8.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(u8.tobytes())


def read_ppm(path: str):
    """Read binary PPM (P6) -> linear float32 (H, W, 3)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"P6":
            raise ValueError(f"{path}: not a binary PPM")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = (int(x) for x in line.split())
        maxv = int(f.readline())
        data = np.frombuffer(f.read(w * h * 3), np.uint8).reshape(h, w, 3)
    img = data.astype(np.float32) / maxv
    return np.where(img <= 0.04045, img / 12.92,
                    ((img + 0.055) / 1.055) ** 2.4).astype(np.float32)


def write_rgbe(path: str, img):
    """Radiance .hdr (shared-exponent RGBE, uncompressed scanlines —
    bitmap.cpp FileFormat::RGBE / Ward's format)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    img = np.maximum(img[..., :3], 0.0)
    h, w, _ = img.shape
    maxc = img.max(-1)
    nz = maxc >= 1e-32
    _m, e = np.frexp(np.where(nz, maxc, 1.0))
    scale = np.where(nz, np.ldexp(1.0, -e) * 256.0, 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (h, w))
        f.write(rgbe.tobytes())


def _rgbe_decode_scanlines(data: bytes, h: int, w: int) -> np.ndarray:
    """Radiance scanline decoding: new-style RLE (0x02 0x02 marker,
    per-component runs), old-style repeat markers (1,1,1,n), and flat
    scanlines — the full format Ward's ray tools emit."""
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    y = 0
    prev = None
    while y < h:
        if (w >= 8 and w < 0x8000 and pos + 4 <= len(data)
                and data[pos] == 2 and data[pos + 1] == 2
                and ((data[pos + 2] << 8) | data[pos + 3]) == w):
            pos += 4
            line = np.zeros((4, w), np.uint8)
            for comp in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        line[comp, x:x + count - 128] = data[pos]
                        pos += 1
                        x += count - 128
                    else:            # literals
                        line[comp, x:x + count] = np.frombuffer(
                            data, np.uint8, count, pos)
                        pos += count
                        x += count
            rgbe[y] = line.T
            prev = rgbe[y]
            y += 1
        else:
            # flat scanline, possibly with old-style repeat markers
            x = 0
            shift = 0
            while x < w:
                px = np.frombuffer(data, np.uint8, 4, pos)
                pos += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    rep = int(px[3]) << shift
                    src = rgbe[y, x - 1] if x > 0 else prev[-1]
                    rgbe[y, x:x + rep] = src
                    x += rep
                    shift += 8
                else:
                    rgbe[y, x] = px
                    x += 1
                    shift = 0
            prev = rgbe[y]
            y += 1
    return rgbe


def read_rgbe(path: str):
    """Read a Radiance .hdr (flat, old-style, or new-style RLE scanlines)
    -> linear float32 (H, W, 3)."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance file")
        line = f.readline()
        while line.strip():
            line = f.readline()
        res = f.readline().split()
        if res[0] != b"-Y" or res[2] != b"+X":
            raise ValueError(f"{path}: unsupported orientation {res}")
        h, w = int(res[1]), int(res[3])
        data = f.read()
    if len(data) == h * w * 4:
        rgbe = np.frombuffer(data, np.uint8).reshape(h, w, 4)
    else:
        rgbe = _rgbe_decode_scanlines(data, h, w)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]) \
        .astype(np.float32)
