"""Mesh file loaders (utils/meshio.py counterpart; Mitsuba's obj.cpp,
ply.cpp and serialized.cpp): Wavefront OBJ, PLY (ascii and binary little
endian) and Mitsuba's ``serialized`` format, plus an ascii PLY writer.

Host side, once at scene build. The parsing is vectorized with numpy (a
130,050-face terrain parsed line by line takes seconds), and every loader
returns the same float32 and int32 arrays as the reference's line-by-line
loader: decimal text goes to float64 and then to float32, as Python's
``float`` and the reference's float32 arrays do, and an OBJ's vertices are
numbered in the order in which their (position/uv/normal) tokens first
appear.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np


def _floats(rows, n):
    """(len(rows), n) float32 from the first n tokens of each row."""
    if not rows:
        return np.zeros((0, n), np.float32)
    return _parse(b" ".join(t for r in rows for t in r[:n])).reshape(
        -1, n).astype(np.float32)


def _columns(lines, n):
    """(len(lines), n) float32 from the first n numbers of each line."""
    vals = _parse(b"\n".join(lines))
    if vals.size == n * len(lines):
        return vals.reshape(-1, n).astype(np.float32)
    return _floats([ln.split() for ln in lines], n)


def _parse(text):
    """The whitespace-separated decimals of ``text`` as float64 (numpy's C
    parser, correctly rounded as Python's float)."""
    return np.fromstring(text, dtype=np.float64, sep=" ")


def _fan(counts, idx):
    """Triangles (idx[0], idx[k], idx[k + 1]) of polygons given by their
    vertex counts and the flat array of their vertex ids, in polygon order."""
    counts = np.asarray(counts, np.int64)
    if counts.size == 0:
        return np.zeros((0, 3), np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n_tri = np.maximum(counts - 2, 0)
    poly = np.repeat(np.arange(len(counts)), n_tri)
    k = np.arange(int(n_tri.sum())) - np.repeat(np.cumsum(n_tri) - n_tri,
                                                n_tri)
    base = starts[poly]
    return np.stack([idx[base], idx[base + k + 1], idx[base + k + 2]],
                    axis=-1).astype(np.int32)


def _first_appearance(keys):
    """Ids of ``keys`` (an array) numbered by first appearance, and the
    distinct keys in that order."""
    uniq, first, inverse = np.unique(keys, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inverse.reshape(-1)], uniq[order]


def load_obj(filename):
    """Wavefront OBJ: v / vn / vt / f (polygons triangulated as fans).
    Returns (vertices (V, 3), faces (F, 3), normals (V, 3) or None,
    uvs (V, 2) or None)."""
    with open(filename, "rb") as fh:
        text = fh.read()
    rows = {key: re.findall(rb"^" + key + rb" (.*)$", text, re.M)
            for key in (b"v", b"vn", b"vt", b"f")}
    positions = _columns(rows[b"v"], 3)
    normals_raw = _columns(rows[b"vn"], 3)
    uvs_raw = _columns(rows[b"vt"], 2)
    if not rows[b"f"]:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                None if not rows[b"vn"] else np.zeros((0, 3), np.float32),
                None if not rows[b"vt"] else np.zeros((0, 2), np.float32))
    face_rows = [ln.split() for ln in rows[b"f"]]
    counts = [len(r) for r in face_rows]
    tokens = [t for r in face_rows for t in r]
    # one vertex per distinct token, numbered by first appearance
    flat = b" " + b" ".join(tokens)
    if b"/" not in flat and b" -" not in flat and b" 0" not in flat:
        # plain positive indices: a token's text is its number's
        vid, uniq = _first_appearance(np.array(flat.split(), np.int64))
        ptn = np.zeros((len(uniq), 3), np.int64)
        ptn[:, 0] = uniq
    else:
        vid, uniq = _first_appearance(np.array(tokens))
        ptn = np.zeros((len(uniq), 3), np.int64)
        for j, tok in enumerate(uniq):
            parts = tok.split(b"/")
            ptn[j, 0] = int(parts[0])
            if len(parts) > 1 and parts[1]:
                ptn[j, 1] = int(parts[1])
            if len(parts) > 2 and parts[2]:
                ptn[j, 2] = int(parts[2])
    pi, ti, ni = ptn[:, 0], ptn[:, 1], ptn[:, 2]
    verts = positions[np.where(pi > 0, pi - 1, pi + len(positions))]
    uvs = normals = None
    if rows[b"vt"]:
        uvs = np.where((ti != 0)[:, None], uvs_raw[np.where(ti != 0, ti - 1,
                                                            0)], 0.0)
        uvs = uvs.astype(np.float32)
    if rows[b"vn"]:
        normals = np.where((ni != 0)[:, None],
                           normals_raw[np.where(ni != 0, ni - 1, 0)], 0.0)
        normals = normals.astype(np.float32)
    return verts, _fan(counts, vid), normals, uvs


def load_ply(filename):
    """PLY (ascii or binary little endian): vertex xyz and faces. Returns
    (vertices (V, 3) float32, faces (F, 3) int32)."""
    with open(filename, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"{filename}: not a PLY file")
        fmt = None
        n_vert = n_face = 0
        vert_props = []
        in_vertex = False
        while True:
            line = fh.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element vertex"):
                n_vert = int(line.split()[-1])
                in_vertex = True
            elif line.startswith(b"element face"):
                n_face = int(line.split()[-1])
                in_vertex = False
            elif line.startswith(b"property") and in_vertex:
                vert_props.append(line.split()[-1].decode())
            elif line == b"end_header":
                break
        n_props = len(vert_props)
        ix = vert_props.index("x")
        body = fh.read()
    if fmt == "ascii":
        lines = body.splitlines()
        vtext = b"\n".join(lines[:n_vert])
        vals = _parse(vtext)
        if vals.size == n_vert * n_props:  # one row of n_props a vertex
            verts = vals.reshape(n_vert, n_props)[:, ix:ix + 3]
            verts = verts.astype(np.float32)
        else:
            verts = _floats([ln.split()[ix:] for ln in lines[:n_vert]], 3)
        flines = lines[n_vert:n_vert + n_face]
        vals = np.array(b" ".join(flines).split(), np.int64)
        if vals.size == 4 * n_face and np.all(vals[::4] == 3):
            return verts, vals.reshape(-1, 4)[:, 1:].astype(np.int32)
        rows = [ln.split() for ln in flines]
        counts = [int(r[0]) for r in rows]
        idx = np.asarray([int(t) for r in rows for t in r[1:]], np.int64)
        return verts, _fan(counts, idx)
    if fmt == "binary_little_endian":
        nbytes = n_vert * n_props * 4
        data = np.frombuffer(body, "<f4", n_vert * n_props)
        verts = data.reshape(n_vert, n_props)[:, ix:ix + 3].astype(np.float32)
        raw = body[nbytes:]
        tri = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
        if len(raw) >= n_face * tri.itemsize:
            rec = np.frombuffer(raw, tri, n_face)
            if np.all(rec["n"] == 3):  # every face a triangle
                return verts, rec["i"].astype(np.int32)
        counts, idx, off = [], [], 0
        for _ in range(n_face):
            cnt = raw[off]
            counts.append(cnt)
            idx.extend(struct.unpack_from(f"<{cnt}i", raw, off + 1))
            off += 1 + 4 * cnt
        return verts, _fan(counts, np.asarray(idx, np.int64))
    raise ValueError(f"unsupported ply format {fmt}")


def write_ply(filename, vertices, faces):
    """An ascii PLY of float32 vertices and triangle faces."""
    with open(filename, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(vertices)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        fh.write(f"element face {len(faces)}\n")
        fh.write("property list uchar int vertex_indices\nend_header\n")
        for v in vertices:
            fh.write(f"{v[0]} {v[1]} {v[2]}\n")
        for f in faces:
            fh.write(f"3 {f[0]} {f[1]} {f[2]}\n")


def load_serialized(path, shape_index=0):
    """Mitsuba's ``serialized`` mesh (serialized.cpp).

    Format: uint16 magic 0x041C, uint16 version, a zlib stream of [uint32
    flags, name (version >= 3, a C string), uint64 n_verts, uint64 n_faces,
    positions, normals?, texcoords?, colors?, faces]; a footer of uint64
    offsets, one a sub-mesh, and a uint32 count. Returns (verts, faces,
    normals or None, uvs or None)."""
    has_normals, has_texcoords, has_colors = 0x0001, 0x0002, 0x0008
    double_precision = 0x2000
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<HH", data, 0)
    if magic != 0x041C:
        raise ValueError(f"not a .serialized file: magic {magic:#x}")
    (count,) = struct.unpack_from("<I", data, len(data) - 4)
    offsets = struct.unpack_from("<" + "Q" * count, data,
                                 len(data) - 4 - 8 * count)
    if not 0 <= shape_index < count:
        raise ValueError(f"shape_index {shape_index} of {count} meshes")
    raw = zlib.decompress(data[offsets[shape_index] + 4:])
    pos = 0
    (flags,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    if version >= 3:  # a null-terminated utf-8 name
        pos = raw.index(b"\x00", pos) + 1
    n_verts, n_faces = struct.unpack_from("<QQ", raw, pos)
    pos += 16
    dt = np.float64 if flags & double_precision else np.float32
    isize = np.dtype(dt).itemsize

    def take(n):
        nonlocal pos
        out = np.frombuffer(raw, dt, n, pos)
        pos += n * isize
        return out.astype(np.float32)

    verts = take(3 * n_verts).reshape(-1, 3)
    normals = take(3 * n_verts).reshape(-1, 3) if flags & has_normals \
        else None
    uvs = take(2 * n_verts).reshape(-1, 2) if flags & has_texcoords else None
    if flags & has_colors:
        take(3 * n_verts)
    faces = np.frombuffer(raw, np.uint32, 3 * n_faces, pos) \
        .astype(np.int32).reshape(-1, 3)
    return verts, faces, normals, uvs
