"""Pure-Python PIZ and PXR24 codecs of the scanline EXR reader and writer
(utils/exr_piz.py counterpart; host-side numpy, no torch).

Re-derivations of the public OpenEXR data formats (ImfPizCompressor /
ImfHuf / ImfWav and ImfPxr24Compressor semantics, documented in the
OpenEXR technical introduction). tests/test_torch_bitmap.py holds the
writer's bytes to the reference's and the reader to files that
libOpenEXR writes.

PIZ chunk layout:
    u16 minNonZero, u16 maxNonZero        (LE)
    u8  bitmap[maxNonZero-minNonZero+1]   (present-value bitset, bit 0 of
                                           value 0 always cleared)
    u32 nHuf                              (LE, huffman byte count)
    u8  huf[nHuf]                         (canonical-Huffman bitstream with
                                           a 20-byte header, see _huf_*)
The decompressed payload is channel-major u16 planes (one per channel, f32
channels = 2 interleaved u16s/pixel), 2D-wavelet transformed; the LUT from
the bitmap maps stored indices back to u16 values.

PXR24 chunk: zlib deflate of per-scanline, per-channel byte planes of
delta-encoded pixels (f32 -> truncated 24-bit float, 3 planes MSB..LSB;
f16 -> 2 planes; u32 -> 4 planes).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3

HUF_ENCBITS = 16
HUF_DECBITS = 14
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1

SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN  # 6
LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN


# --- bitmap / LUT ------------------------------------------------------------

def _bitmap_from_data(data: np.ndarray):
    """(bitmap u8[8192], minNonZero, maxNonZero) for u16 ``data``."""
    present = np.zeros(USHORT_RANGE, np.bool_)
    present[data] = True
    present[0] = False  # zero is never stored in the bitmap
    bitmap = np.packbits(present.reshape(-1, 8)[:, ::-1], axis=1,
                         bitorder="big").reshape(-1)
    nz = np.nonzero(bitmap)[0]
    if len(nz) == 0:
        return bitmap, 1, 0  # empty range (all-zero data)
    return bitmap, int(nz[0]), int(nz[-1])


def _forward_lut(bitmap: np.ndarray):
    """value -> stored index; returns (lut u16[65536], maxValue)."""
    bits = np.unpackbits(bitmap.reshape(-1, 1), axis=1,
                         bitorder="little").reshape(-1)
    present = bits.astype(bool)
    present[0] = True
    lut = np.where(present, np.cumsum(present) - 1, 0).astype(np.uint16)
    return lut, int(np.sum(present)) - 1


def _reverse_lut(bitmap: np.ndarray):
    """stored index -> value; returns (lut u16[65536], maxValue)."""
    bits = np.unpackbits(bitmap.reshape(-1, 1), axis=1,
                         bitorder="little").reshape(-1)
    present = bits.astype(bool)
    present[0] = True
    vals = np.nonzero(present)[0].astype(np.uint16)
    lut = np.zeros(USHORT_RANGE, np.uint16)
    lut[:len(vals)] = vals
    return lut, len(vals) - 1


# --- 2D wavelet (ImfWav semantics) ------------------------------------------

def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (ai - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc14(a, b):
    as_ = a.astype(np.int16).astype(np.int32)
    bs = b.astype(np.int16).astype(np.int32)
    ms = (as_ + bs) >> 1
    ds = as_ - bs
    return (ms.astype(np.int16).astype(np.uint16),
            ds.astype(np.int16).astype(np.uint16))


_NBITS = 16
_A_OFFSET = 1 << (_NBITS - 1)
_MOD_MASK = (1 << _NBITS) - 1


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    bi = b.astype(np.int32)
    m = (ao + bi) >> 1
    d = ao - bi
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wav2_decode(buf: np.ndarray, nx: int, ox: int, ny: int, oy: int,
                 mx: int):
    """In-place inverse 2D wavelet on the strided plane inside ``buf``
    (flat u16 array): element (y, x) lives at buf[y*oy + x*ox]."""
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    view = np.lib.stride_tricks.as_strided(
        buf[:1 + (ny - 1) * oy + (nx - 1) * ox],
        shape=(ny, nx), strides=(2 * oy, 2 * ox))
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        # full 2x2 quads on the [0 : ny-p2+1 : p2] x [0 : nx-p2+1 : p2] grid
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            q00 = view[np.ix_(ys, xs)]
            q01 = view[np.ix_(ys, xs + p)]
            q10 = view[np.ix_(ys + p, xs)]
            q11 = view[np.ix_(ys + p, xs + p)]
            i00, i10 = dec(q00, q10)
            i01, i11 = dec(q01, q11)
            a00, a01 = dec(i00, i01)
            a10, a11 = dec(i10, i11)
            view[np.ix_(ys, xs)] = a00
            view[np.ix_(ys, xs + p)] = a01
            view[np.ix_(ys + p, xs)] = a10
            view[np.ix_(ys + p, xs + p)] = a11
        if nx & p:
            # odd remainder column (C loop leaves px = len(xs)*p2 there)
            x = len(xs) * p2
            if len(ys):
                a, b = dec(view[ys, x], view[ys + p, x])
                view[ys, x] = a
                view[ys + p, x] = b
        if ny & p:
            y = len(ys) * p2
            xs2 = np.arange(0, nx - p2 + 1, p2)
            if len(xs2):
                a, b = dec(view[y, xs2], view[y, xs2 + p])
                view[y, xs2] = a
                view[y, xs2 + p] = b
        p2 = p
        p >>= 1


def _wav2_encode(buf: np.ndarray, nx: int, ox: int, ny: int, oy: int,
                 mx: int):
    """In-place forward 2D wavelet (inverse order of _wav2_decode)."""
    enc = _wenc14 if mx < (1 << 14) else _wenc16
    view = np.lib.stride_tricks.as_strided(
        buf[:1 + (ny - 1) * oy + (nx - 1) * ox],
        shape=(ny, nx), strides=(2 * oy, 2 * ox))
    n = min(nx, ny)
    p = 1
    p2 = 2
    while p2 <= n:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            a00 = view[np.ix_(ys, xs)]
            a01 = view[np.ix_(ys, xs + p)]
            a10 = view[np.ix_(ys + p, xs)]
            a11 = view[np.ix_(ys + p, xs + p)]
            i00, i01 = enc(a00, a01)
            i10, i11 = enc(a10, a11)
            q00, q10 = enc(i00, i10)
            q01, q11 = enc(i01, i11)
            view[np.ix_(ys, xs)] = q00
            view[np.ix_(ys, xs + p)] = q01
            view[np.ix_(ys + p, xs)] = q10
            view[np.ix_(ys + p, xs + p)] = q11
        if nx & p:
            x = len(xs) * p2
            if len(ys):
                a, b = enc(view[ys, x], view[ys + p, x])
                view[ys, x] = a
                view[ys + p, x] = b
        if ny & p:
            y = len(ys) * p2
            xs2 = np.arange(0, nx - p2 + 1, p2)
            if len(xs2):
                a, b = enc(view[y, xs2], view[y, xs2 + p])
                view[y, xs2] = a
                view[y, xs2 + p] = b
        p = p2
        p2 <<= 1


# --- canonical Huffman (ImfHuf format) ---------------------------------------

class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get(self, n: int) -> int:
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


class _BitWriter:
    __slots__ = ("out", "c", "lc", "nbits")

    def __init__(self):
        self.out = bytearray()
        self.c = 0
        self.lc = 0
        self.nbits = 0

    def put(self, nbits: int, code: int):
        nbits = int(nbits)
        self.c = (self.c << nbits) | int(code)
        self.lc += nbits
        self.nbits += nbits
        while self.lc >= 8:
            self.lc -= 8
            self.out.append((self.c >> self.lc) & 0xFF)

    def flush(self) -> bytes:
        if self.lc:
            self.out.append((self.c << (8 - self.lc)) & 0xFF)
            self.lc = 0
        return bytes(self.out)


def _huf_canonical(lengths: np.ndarray) -> np.ndarray:
    """Code-length array -> canonical codes (hufCanonicalCodeTable):
    returns int64 array with (code << 6) | length packed like ImfHuf."""
    n = np.zeros(59, np.int64)
    for ln in lengths[lengths > 0]:
        n[ln] += 1
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    packed = np.zeros(len(lengths), np.int64)
    for i in range(len(lengths)):
        ln = int(lengths[i])
        if ln > 0:
            packed[i] = ln | (n[ln] << 6)
            n[ln] += 1
    return packed


def _huf_unpack_table(reader: _BitReader, im: int, iM: int) -> np.ndarray:
    """hufUnpackEncTable: 6-bit lengths with zero-run codes -> packed
    canonical table (code << 6 | len) over the full symbol range."""
    lengths = np.zeros(HUF_ENCSIZE, np.int32)
    i = im
    while i <= iM:
        l = reader.get(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = reader.get(8) + SHORTEST_LONG_RUN
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            i += l - SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    if i > HUF_ENCSIZE:
        raise ValueError("corrupt PIZ huffman table")
    return _huf_canonical(lengths)


def _huf_pack_table(writer: _BitWriter, packed: np.ndarray, im: int,
                    iM: int):
    """hufPackEncTable inverse of _huf_unpack_table."""
    i = im
    while i <= iM:
        ln = int(packed[i]) & 63
        if ln == 0:
            # count zero run
            j = i
            while j <= iM and (int(packed[j]) & 63) == 0 \
                    and j - i < LONGEST_LONG_RUN:
                j += 1
            run = j - i
            if run >= SHORTEST_LONG_RUN:
                writer.put(6, LONG_ZEROCODE_RUN)
                writer.put(8, run - SHORTEST_LONG_RUN)
                i = j
                continue
            if run >= 2:
                writer.put(6, SHORT_ZEROCODE_RUN + run - 2)
                i = j
                continue
            writer.put(6, 0)
            i += 1
        else:
            writer.put(6, ln)
            i += 1


def _huf_decode(packed: np.ndarray, im: int, iM: int, data: bytes,
                nbits: int, n_out: int) -> np.ndarray:
    """hufDecode: canonical codes + MSB-first bitstream -> u16 symbols.
    rlc (run-length marker) = iM per the format."""
    lengths = (packed & 63).astype(np.int32)
    codes = (packed >> 6).astype(np.int64)

    # fast table for codes <= HUF_DECBITS; longer codes go in per-prefix lists
    tbl_len = np.zeros(HUF_DECSIZE, np.int32)
    tbl_lit = np.zeros(HUF_DECSIZE, np.int32)
    long_codes = {}
    for sym in range(im, iM + 1):
        l = int(lengths[sym])
        if l == 0:
            continue
        c = int(codes[sym])
        if l > HUF_DECBITS:
            prefix = c >> (l - HUF_DECBITS)
            long_codes.setdefault(prefix, []).append(sym)
        else:
            start = c << (HUF_DECBITS - l)
            tbl_len[start:start + (1 << (HUF_DECBITS - l))] = l
            tbl_lit[start:start + (1 << (HUF_DECBITS - l))] = sym

    out = np.zeros(n_out, np.uint16)
    oi = 0
    rlc = iM
    c = 0
    lc = 0
    nbytes = (nbits + 7) // 8
    pos = 0

    def emit(sym):
        nonlocal oi, c, lc, pos
        if sym == rlc:
            if lc < 8:
                c = (c << 8) | data[pos]
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            if oi == 0 or oi + cs > n_out:
                raise ValueError("corrupt PIZ huffman run")
            out[oi:oi + cs] = out[oi - 1]
            oi += cs
        else:
            if oi >= n_out:
                raise ValueError("PIZ huffman output overrun")
            out[oi] = sym
            oi += 1

    while pos < nbytes:
        c = (c << 8) | data[pos]
        pos += 1
        lc += 8
        while lc >= HUF_DECBITS:
            idx = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
            l = int(tbl_len[idx])
            if l:
                lc -= l
                emit(int(tbl_lit[idx]))
            else:
                # long code: linear-search this prefix's candidates
                for sym in long_codes.get(idx, ()):
                    l2 = int(lengths[sym])
                    while lc < l2 and pos < nbytes:
                        c = (c << 8) | data[pos]
                        pos += 1
                        lc += 8
                    if lc >= l2 and int(codes[sym]) == \
                            ((c >> (lc - l2)) & ((1 << l2) - 1)):
                        lc -= l2
                        emit(sym)
                        break
                else:
                    raise ValueError("corrupt PIZ huffman data")
    # trailing bits (final partial byte)
    i = (8 - nbits) & 7
    c >>= i
    lc -= i
    while lc > 0:
        idx = (c << (HUF_DECBITS - lc)) & HUF_DECMASK
        l = int(tbl_len[idx])
        if l and l <= lc:
            lc -= l
            emit(int(tbl_lit[idx]))
        else:
            break
    if oi != n_out:
        raise ValueError(f"PIZ huffman decoded {oi} of {n_out} symbols")
    return out


def _huf_build_lengths(freq: np.ndarray) -> np.ndarray:
    """Huffman code lengths (<= 58 bits) for symbols with freq > 0 via the
    standard two-queue merge; any valid prefix code decodes fine since the
    table itself is stored in the stream."""
    syms = np.nonzero(freq)[0]
    lengths = np.zeros(len(freq), np.int32)
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    import heapq

    heap = [(int(freq[s]), int(s), (int(s),)) for s in syms]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, _t1, s1 = heapq.heappop(heap)
        f2, _t2, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (f1 + f2, min(_t1, _t2), s1 + s2))
    if lengths.max() > 58:  # pathological; flatten (still a prefix code)
        raise ValueError("huffman length overflow")
    return lengths


def _huf_compress(data: np.ndarray) -> bytes:
    """hufCompress: u16 symbols -> ImfHuf chunk (20-byte header + packed
    code-length table + MSB-first bitstream with RLE runs on rlc=iM)."""
    freq = np.bincount(data, minlength=HUF_ENCSIZE).astype(np.int64)
    nz = np.nonzero(freq)[0]
    max_sym = int(nz[-1]) if len(nz) else 0
    rlc = max_sym + 1  # reserve the run-length marker symbol
    freq[rlc] = 1
    im = int(np.nonzero(freq)[0][0])
    iM = rlc

    lengths = _huf_build_lengths(freq)
    packed = _huf_canonical(lengths)

    tw = _BitWriter()
    _huf_pack_table(tw, packed, im, iM)
    table_bytes = tw.flush()

    # encode with run-length compaction: runs of the same symbol become
    # sym, rlc, count(8 bits) when beneficial
    bw = _BitWriter()
    codes = (packed >> 6).astype(np.int64)
    lens = (packed & 63).astype(np.int32)

    # find runs
    n = len(data)
    i = 0
    arr = data
    # vectorized run detection
    change = np.nonzero(np.diff(arr))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    rl_code = int(codes[rlc])
    rl_len = int(lens[rlc])
    for s, e in zip(starts, ends):
        sym = int(arr[s])
        cl = int(lens[sym])
        cc = int(codes[sym])
        run = e - s
        bw.put(cl, cc)
        run -= 1
        # emit repeats: prefer rlc runs of up to 255 when cheaper
        while run > 0:
            chunk = min(run, 255)
            if chunk * cl > rl_len + 8:
                bw.put(rl_len, rl_code)
                bw.put(8, chunk)
            else:
                for _ in range(chunk):
                    bw.put(cl, cc)
            run -= chunk
    stream = bw.flush()

    header = struct.pack("<IIIII", im, iM, len(table_bytes), bw.nbits, 0)
    return header + table_bytes + stream


def _huf_uncompress(buf: bytes, n_out: int) -> np.ndarray:
    im, iM, _table_len, nbits, _room = struct.unpack_from("<IIIII", buf, 0)
    if iM >= HUF_ENCSIZE:
        raise ValueError("corrupt PIZ huffman header")
    reader = _BitReader(buf[20:])
    packed = _huf_unpack_table(reader, im, iM)
    data_start = 20 + reader.pos
    return _huf_decode(packed, im, iM, buf[data_start:], nbits, n_out)


# --- PIZ chunk codec ---------------------------------------------------------

def piz_decompress(buf: bytes, channels, W: int, ny: int) -> bytes:
    """PIZ chunk -> raw scanline-interleaved bytes (the generic EXR chunk
    layout). channels: [(name, pixel_type)] in file order; pixel sizes in
    u16 units: HALF=1, FLOAT/UINT=2."""
    min_nz, max_nz = struct.unpack_from("<HH", buf, 0)
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        count = max_nz - min_nz + 1
        bitmap[min_nz:min_nz + count] = np.frombuffer(buf, np.uint8, count,
                                                      pos)
        pos += count
    lut, max_value = _reverse_lut(bitmap)
    (n_huf,) = struct.unpack_from("<I", buf, pos)
    pos += 4

    sizes = [1 if pt == 1 else 2 for _n, pt in channels]  # u16s per pixel
    total = sum(W * ny * s for s in sizes)
    tmp = _huf_uncompress(buf[pos:pos + n_huf], total)

    # per-channel wavelet decode
    off = 0
    for (name, pt), size in zip(channels, sizes):
        n_ch = W * ny * size
        plane = tmp[off:off + n_ch]
        for j in range(size):
            _wav2_decode(plane[j:], W, size, ny, W * size, max_value)
        off += n_ch

    tmp = lut[tmp]

    # channel-major planes -> scanline-interleaved raw bytes
    out = bytearray()
    offs = np.cumsum([0] + [W * ny * s for s in sizes])
    for y in range(ny):
        for ci, size in enumerate(sizes):
            row = tmp[offs[ci] + y * W * size: offs[ci] + (y + 1) * W * size]
            out += row.tobytes()
    return bytes(out)


def piz_compress(raw: bytes, channels, W: int, ny: int) -> bytes:
    """Inverse of piz_decompress (raw scanline-interleaved -> PIZ chunk)."""
    sizes = [1 if pt == 1 else 2 for _n, pt in channels]
    total = sum(W * ny * s for s in sizes)
    data = np.frombuffer(raw, np.uint16)
    assert len(data) == total, (len(data), total)

    # scanline-interleaved -> channel-major planes
    tmp = np.zeros(total, np.uint16)
    offs = np.cumsum([0] + [W * ny * s for s in sizes])
    p = 0
    for y in range(ny):
        for ci, size in enumerate(sizes):
            tmp[offs[ci] + y * W * size: offs[ci] + (y + 1) * W * size] = \
                data[p:p + W * size]
            p += W * size

    bitmap, min_nz, max_nz = _bitmap_from_data(tmp)
    lut, max_value = _forward_lut(bitmap)
    tmp = lut[tmp]

    off = 0
    for (name, pt), size in zip(channels, sizes):
        n_ch = W * ny * size
        plane = tmp[off:off + n_ch]
        for j in range(size):
            _wav2_encode(plane[j:], W, size, ny, W * size, max_value)
        off += n_ch

    huf = _huf_compress(tmp)
    out = struct.pack("<HH", min_nz, max_nz)
    if min_nz <= max_nz:
        out += bitmap[min_nz:max_nz + 1].tobytes()
    out += struct.pack("<I", len(huf)) + huf
    return out


# --- PXR24 chunk codec -------------------------------------------------------

def _float_to_float24(f: np.ndarray) -> np.ndarray:
    """f32 -> 24-bit float bits (ImfPxr24Compressor floatToFloat24 scheme):
    drop the low 8 mantissa bits with round-half-up; NaNs keep their top
    mantissa bits (quietened), infinities pass through."""
    i = np.ascontiguousarray(f, np.float32).view(np.uint32)
    s = (i & 0x80000000) >> 8
    e = i & 0x7F800000
    m = i & 0x007FFFFF
    em = e | m
    plain = em >> 8
    plain = plain + ((em & 0x80) >> 7)  # round half up on the dropped bits
    m8 = m >> 8
    nan = (e >> 8) | m8 | (m8 == 0)
    special = np.where(m != 0, nan, e >> 8)
    out = np.where(e == 0x7F800000, special, plain)
    return (s | out).astype(np.uint32)


def _float24_to_float(b: np.ndarray) -> np.ndarray:
    return (b.astype(np.uint32) << 8).view(np.float32)


def pxr24_decompress(buf: bytes, channels, W: int, ny: int) -> bytes:
    """PXR24 chunk -> raw scanline-interleaved bytes."""
    tmp = np.frombuffer(zlib.decompress(buf), np.uint8)
    out = bytearray()
    pos = 0
    for y in range(ny):
        for name, pt in channels:
            if pt == 2:  # FLOAT: 3 planes of diffed 24-bit values
                planes = [tmp[pos + k * W: pos + (k + 1) * W].astype(np.uint32)
                          for k in range(3)]
                pos += 3 * W
                diffs = (planes[0] << 16) | (planes[1] << 8) | planes[2]
                pix = np.cumsum(diffs.astype(np.int64)) & 0xFFFFFF
                out += _float24_to_float(pix.astype(np.uint32)).tobytes()
            elif pt == 1:  # HALF: 2 planes
                planes = [tmp[pos + k * W: pos + (k + 1) * W].astype(np.uint32)
                          for k in range(2)]
                pos += 2 * W
                diffs = (planes[0] << 8) | planes[1]
                pix = (np.cumsum(diffs.astype(np.int64)) & 0xFFFF) \
                    .astype(np.uint16)
                out += pix.tobytes()
            else:  # UINT: 4 planes
                planes = [tmp[pos + k * W: pos + (k + 1) * W].astype(np.uint64)
                          for k in range(4)]
                pos += 4 * W
                diffs = ((planes[0] << 24) | (planes[1] << 16)
                         | (planes[2] << 8) | planes[3])
                pix = (np.cumsum(diffs.astype(np.int64)) & 0xFFFFFFFF) \
                    .astype(np.uint32)
                out += pix.tobytes()
    return bytes(out)


def pxr24_compress(raw: bytes, channels, W: int, ny: int) -> bytes:
    """Inverse of pxr24_decompress (lossy for FLOAT channels: 24-bit)."""
    out = bytearray()
    pos = 0
    for y in range(ny):
        for name, pt in channels:
            if pt == 2:
                row = np.frombuffer(raw, np.float32, W, pos)
                pos += 4 * W
                pix = _float_to_float24(row).astype(np.int64)
                diffs = np.diff(pix, prepend=0) & 0xFFFFFF
                d = diffs.astype(np.uint32)
                out += (d >> 16).astype(np.uint8).tobytes()
                out += ((d >> 8) & 0xFF).astype(np.uint8).tobytes()
                out += (d & 0xFF).astype(np.uint8).tobytes()
            elif pt == 1:
                row = np.frombuffer(raw, np.uint16, W, pos).astype(np.int64)
                pos += 2 * W
                diffs = np.diff(row, prepend=0) & 0xFFFF
                d = diffs.astype(np.uint32)
                out += (d >> 8).astype(np.uint8).tobytes()
                out += (d & 0xFF).astype(np.uint8).tobytes()
            else:
                row = np.frombuffer(raw, np.uint32, W, pos).astype(np.int64)
                pos += 4 * W
                diffs = np.diff(row, prepend=0) & 0xFFFFFFFF
                d = diffs.astype(np.uint64)
                out += (d >> 24).astype(np.uint8).tobytes()
                out += ((d >> 16) & 0xFF).astype(np.uint8).tobytes()
                out += ((d >> 8) & 0xFF).astype(np.uint8).tobytes()
                out += (d & 0xFF).astype(np.uint8).tobytes()
    return zlib.compress(bytes(out))
