"""Binned-SAH BVH over triangle tiles (ops/bvh.py counterpart).

The leaves are the K=128 triangle tiles of ops/accel.py (one leaf = one
tile, or one (group tile, instance) pair in an instanced scene); the
binary tree over their AABBs is built on the host at scene-build time and
collapsed into 8-wide nodes for the wide traversal. The binary tree comes
from the native builder csrc/bvh_builder.cpp (the reference's, built with
g++ at first use by utils/native_cache.py); ``_build_tile_bvh_numpy`` is
its plain version, bit-equal to it, which the builder takes where there
is no g++ or ``ERT_NO_NATIVE`` is set (as the reference does).

Layout consumed by ops/intersect.py:
  nbox  (N, 1, 8) f32: [lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, 0, 0]
  nmeta (N, 4)   i32: [left, right, tile, inst]; tile >= 0 marks a leaf,
                      whose left/right are 0; inst = -1 outside instances.
  cbox  (N8, 8, 8) f32: per slot [lo.xyz, hi.xyz, 0, 0]; empty slots hold
                      an inverted box (lo = 1e30, hi = -1e30).
  cmeta (N8, 8, 4) i32: per slot [child, tile, inst, 0]; child >= 0 is an
                      inner node, else tile >= 0 is a leaf; both -1 empty.
Root is node 0; N = 2 * leaves - 1.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.native_cache import host_builder

MAX_DEPTH = 48      # median splits near this depth bound the binary stack
N_BINS = 16


_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _builder():
    if os.environ.get("ERT_NO_NATIVE"):
        return None
    lib = host_builder("bvh_builder")
    if lib is not None:
        lib.build_tile_bvh.restype = ctypes.c_int
        lib.build_tile_bvh.argtypes = [_F32P, _F32P, _I32P, _I32P,
                                       ctypes.c_int64, _F32P, _I32P]
    return lib


def build_tile_bvh(tile_lo, tile_hi, leaf_tile=None, leaf_inst=None):
    """Build the flattened binary BVH over leaf AABBs tile_lo/hi (T, 3),
    by the native builder (its numpy version where there is none).

    leaf_tile/leaf_inst: optional per-leaf payloads; leaf i stores
    (leaf_tile[i], leaf_inst[i]) in nmeta[:, 2:4] instead of (i, -1).
    Returns (nbox (N,1,8) f32, nmeta (N,4) i32, depth)."""
    T = len(tile_lo)
    if T < 1:
        raise ValueError("build_tile_bvh needs at least one leaf")
    lib = _builder()
    if lib is None:
        return _build_tile_bvh_numpy(tile_lo, tile_hi, leaf_tile, leaf_inst)
    lo = np.ascontiguousarray(tile_lo, np.float32)
    hi = np.ascontiguousarray(tile_hi, np.float32)
    lt = np.ascontiguousarray(
        np.arange(T) if leaf_tile is None else leaf_tile, np.int32)
    li = np.ascontiguousarray(
        np.full(T, -1) if leaf_inst is None else leaf_inst, np.int32)
    N = 2 * T - 1
    nbox = np.empty((N, 8), np.float32)
    nmeta = np.empty((N, 4), np.int32)
    depth = lib.build_tile_bvh(lo.ctypes.data_as(_F32P),
                               hi.ctypes.data_as(_F32P),
                               lt.ctypes.data_as(_I32P),
                               li.ctypes.data_as(_I32P), T,
                               nbox.ctypes.data_as(_F32P),
                               nmeta.ctypes.data_as(_I32P))
    if depth <= 0:
        raise RuntimeError(f"bvh_builder failed ({depth}) on {T} leaves")
    return nbox.reshape(N, 1, 8), nmeta, depth


def _build_tile_bvh_numpy(tile_lo, tile_hi, leaf_tile=None, leaf_inst=None):
    """The plain version of csrc/bvh_builder.cpp (bit-equal outputs)."""
    T = len(tile_lo)
    if leaf_tile is None:
        leaf_tile = np.arange(T, dtype=np.int32)
    if leaf_inst is None:
        leaf_inst = np.full(T, -1, np.int32)
    cent = 0.5 * (tile_lo + tile_hi)
    N = 2 * T - 1
    nbox = np.zeros((N, 8), np.float32)
    nmeta = np.zeros((N, 4), np.int32)
    next_node = 1
    max_depth_seen = 0
    # work stack of (node id, leaf index array, depth); the pop order fixes
    # the node numbering, which must match the reference's
    work = [(0, np.arange(T), 0)]
    while work:
        node, ids, depth = work.pop()
        max_depth_seen = max(max_depth_seen, depth)
        nbox[node, 0:3] = tile_lo[ids].min(0)
        nbox[node, 3:6] = tile_hi[ids].max(0)
        if len(ids) == 1:
            nmeta[node] = (0, 0, leaf_tile[ids[0]], leaf_inst[ids[0]])
            continue
        order, split = _choose_split(tile_lo[ids], tile_hi[ids], cent[ids],
                                     force_median=depth >= MAX_DEPTH - 2)
        li, ri = next_node, next_node + 1
        next_node += 2
        nmeta[node] = (li, ri, -1, -1)
        work.append((li, ids[order[:split]], depth + 1))
        work.append((ri, ids[order[split:]], depth + 1))
    assert next_node == N
    return nbox.reshape(N, 1, 8), nmeta, max_depth_seen + 1


def _choose_split(lo, hi, cent, force_median=False):
    """(ordering, split point) of one node's leaves: binned SAH over the
    largest centroid-extent axis, median split when SAH degenerates."""
    n = len(lo)
    c_lo = cent.min(0)
    c_ext = cent.max(0) - c_lo
    axis = int(np.argmax(c_ext))
    order = np.argsort(cent[:, axis], kind="stable")
    if force_median or c_ext[axis] <= 0 or n <= 4:
        return order, n // 2

    slo, shi = lo[order], hi[order]
    pre_lo = np.minimum.accumulate(slo, axis=0)
    pre_hi = np.maximum.accumulate(shi, axis=0)
    suf_lo = np.minimum.accumulate(slo[::-1], axis=0)[::-1]
    suf_hi = np.maximum.accumulate(shi[::-1], axis=0)[::-1]

    def area(l, h):
        d = np.maximum(h - l, 0)
        return (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                + d[..., 2] * d[..., 0])

    ks = np.arange(1, n)
    if n > N_BINS:  # evaluate only ~N_BINS candidate splits
        ks = np.unique(np.linspace(1, n - 1, N_BINS).astype(np.int64))
    cost = (ks * area(pre_lo[ks - 1], pre_hi[ks - 1])
            + (n - ks) * area(suf_lo[ks], suf_hi[ks]))
    return order, int(ks[np.argmin(cost)])


def collapse_to_bvh8(nbox, nmeta):
    """Collapse the binary BVH into 8-wide nodes: from each binary subtree
    root, repeatedly expand the member of largest surface area that is an
    inner node until 8 slots are used or only leaves remain; inner members
    become child 8-wide nodes. Returns (cbox (N8,8,8) f32, cmeta (N8,8,4)
    i32)."""
    nbox = np.asarray(nbox).reshape(-1, 8)
    nmeta = np.asarray(nmeta)

    def area(b):
        d = np.maximum(b[3:6] - b[0:3], 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    out_box = [np.zeros((8, 8), np.float32)]
    out_meta = [np.full((8, 4), -1, np.int32)]
    work = [(0, 0)]   # (8-wide node id, binary node id)
    while work:
        nid, b_root = work.pop()
        members = [b_root]
        while len(members) < 8:
            best, best_a = -1, -1.0
            for i, m in enumerate(members):
                if nmeta[m, 2] < 0:   # inner
                    a = area(nbox[m])
                    if a > best_a:
                        best, best_a = i, a
            if best < 0:
                break
            m = members.pop(best)
            members.append(int(nmeta[m, 0]))
            members.append(int(nmeta[m, 1]))
        box = np.zeros((8, 8), np.float32)
        box[:, 0:3] = 1e30    # inverted: empty slots are never entered
        box[:, 3:6] = -1e30
        meta = np.full((8, 4), -1, np.int32)
        for j, m in enumerate(members):
            box[j, 0:6] = nbox[m, 0:6]
            if nmeta[m, 2] >= 0:   # binary leaf
                meta[j, 1] = nmeta[m, 2]
                meta[j, 2] = nmeta[m, 3]
            else:
                child_id = len(out_box)
                out_box.append(np.zeros((8, 8), np.float32))
                out_meta.append(np.full((8, 4), -1, np.int32))
                meta[j, 0] = child_id
                work.append((child_id, m))
        out_box[nid] = box
        out_meta[nid] = meta
    return (np.stack(out_box).astype(np.float32),
            np.stack(out_meta).astype(np.int32))
