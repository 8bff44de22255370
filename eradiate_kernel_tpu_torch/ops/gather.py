"""Per-lane row gathers from a resident table: the port of the TPU gather
probe (tools/probe_pallas_gather.py, kernels ``k_fancy``/``k_take``/
``k_tala``/``k_onehot`` via ``call`` :87), generalised to rows, and the
packed-corner trilinear lookup built on it. Both are entries of the CUDA
kernel ``csrc/grid_gather.cu``:

    gather_rows:        out[j, :] = table[clamp(idx[j], 0, V - 1), :]
    grid_trilinear:     the trilinear lookup of textures/volumes.py's
                        packed path (corner c000's index, the 8-corner
                        row, _lerp8)
    grid_trilinear_bwd: that lookup's gradient with respect to the grid
                        (each lane's cotangent scattered into its 8 corner
                        voxels with atomics)

Each launches its entry for CUDA tensors; for CPU tensors (or under
use_plain) the plain PyTorch versions serve: ``gather_rows_plain`` here,
``volumes.trilinear_gather_plain`` beside the eager chain it keeps and
``volumes.trilinear_backward_plain``. Indices are clamped like the
reference's jnp gathers (torch indexing would raise on them). A launch of
either forward entry counts as a ``grid_gather`` launch, a launch of the
backward entry as a ``grid_trilinear_bwd`` launch.

Every entry has a float64 twin (``<entry>_f64``) for the double
variants: a float64 table, points or cotangent launch it, float32 ones the
float32 entry; nothing is cast.

The wrappers are lean: the ctypes functions are looked up once, the checks
compare attributes directly, and the stream is the raw current-stream
handle of ``_build.stream``.
"""

from __future__ import annotations

import contextlib

import torch

from . import _build

# launches of the kernel in this process (the wrappers add one per launch),
# the float64 entries of the double variants under "<name>_f64"
launches = {"grid_gather": 0, "grid_trilinear_bwd": 0,
            "grid_gather_f64": 0, "grid_trilinear_bwd_f64": 0}

_P, _I, _L = _build.PTR, _build.INT, _build.LONG
_build.register("grid_gather", {
    "grid_gather_launch": [_P] * 3 + [_L, _I, _L, _I, _I, _P],
    "grid_trilinear_launch": [_P] * 4 + [_L] + [_I] * 4 + [_L, _P],
    "grid_trilinear_bwd_launch": [_P] * 4 + [_L] + [_I] * 4 + [_L, _P]})

# the float types the entries take, and each type's entry suffix
_FLOATS = _build.FLOAT_SUFFIX
_IDX = (torch.int32, torch.int64)
# the ctypes entries, looked up at the first launch
_fns = {}

# test hook: run the plain versions on CUDA tensors too (chip_smoke.py
# renders the same scene through both); see use_plain
_FORCE_PLAIN = False


@contextlib.contextmanager
def use_plain():
    """Route CUDA tensors through the plain versions for the duration (for
    the whole-path kernel-vs-plain checks only)."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def on_plain(t):
    """True if the plain versions serve tensor t (a CPU tensor, or under
    use_plain); raises for a device that is neither the CPU nor CUDA."""
    if t.is_cuda:
        return _FORCE_PLAIN
    if t.device.type == "cpu":
        return True
    raise ValueError(f"grid_gather: unsupported device {t.device}")


def _fn(entry, dtype=torch.float32):
    """The ctypes entry for float type ``dtype`` (looked up once)."""
    key = entry + _FLOATS[dtype]
    fn = _fns.get(key)
    if fn is None:
        fn = _fns[key] = _build.entry("grid_gather", key)
    return fn


def gather_rows_plain(table, idx):
    """table (V, R), idx (L,) integer -> (L, R): the plain version."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def _check_rows(table, idx):
    """The gather entry's argument check: returns the CUDA device index."""
    dev = table.get_device()
    if (table.dtype not in _FLOATS or idx.dtype not in _IDX
            or table.dim() != 2
            or idx.dim() != 1 or dev < 0 or idx.get_device() != dev
            or not table.is_contiguous() or not idx.is_contiguous()
            or table.shape[0] == 0):
        raise ValueError(
            f"grid_gather: table must be a contiguous, non-empty (V, R) "
            f"float32/float64 tensor and idx a contiguous (L,) int32/int64 "
            f"tensor "
            f"on one CUDA device, got {table.dtype} {tuple(table.shape)} on "
            f"{table.device} and {idx.dtype} {tuple(idx.shape)} on "
            f"{idx.device}")
    return dev


def _gather_cuda(table, idx):
    """Launch the gather entry of csrc/grid_gather.cu on the current stream
    (no sync)."""
    dev = _check_rows(table, idx)
    fn = _fn("grid_gather_launch", table.dtype)
    V, R = table.shape
    L = idx.shape[0]
    out = table.new_empty((L, R))
    if L == 0 or R == 0:
        return out
    tp = table.data_ptr()
    # out comes from the caching allocator, aligned to 512 bytes; a chunk
    # is 16 bytes, 4 floats or 2 doubles
    vec = R % (16 // table.element_size()) == 0 and tp % 16 == 0
    err = fn(tp, idx.data_ptr(), out.data_ptr(), V, R, L,
             idx.dtype == torch.int64, vec,
             _build.stream(dev))
    if err != 0:
        raise RuntimeError(f"grid_gather launch failed: cudaError {err}")
    launches["grid_gather" + _FLOATS[table.dtype]] += 1
    return out


def gather_rows(table, idx):
    """out[j] = table[clamp(idx[j])] on the tensors' device: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors (or under
    use_plain)."""
    if on_plain(table):
        return gather_rows_plain(table, idx)
    return _gather_cuda(table, idx)


def grid_trilinear(packed, grid_shape, slot, pl):
    """Launch the trilinear entry of csrc/grid_gather.cu on the current
    stream (no sync): packed (V, 8C) f32, grid_shape (S, D, H, W, C), slot
    (...) i32, pl (..., 3) f32 -> (..., C) f32 (each f32 f64 through the
    _f64 entry); bit-equal to volumes.trilinear_gather_plain."""
    S, D, H, W, C = grid_shape
    batch = slot.shape
    slot = slot.reshape(-1).contiguous()
    pl = pl.reshape(-1, 3).contiguous()
    L = slot.shape[0]
    dev = packed.get_device()
    if (packed.dtype not in _FLOATS or pl.dtype != packed.dtype
            or slot.dtype != torch.int32 or packed.dim() != 2
            or packed.shape[1] != 8 * C or packed.shape[0] == 0
            or pl.shape[0] != L or dev < 0 or pl.get_device() != dev
            or slot.get_device() != dev or not packed.is_contiguous()
            or packed.data_ptr() % 16):
        raise ValueError(
            f"grid_gather: the trilinear lookup takes a contiguous, 16-byte "
            f"aligned (V, {8 * C}) float32 or float64 table, points (..., 3) "
            f"of its type and int32 slots (...) on one CUDA device, got "
            f"{packed.dtype} {tuple(packed.shape)} on {packed.device}, "
            f"{pl.dtype} {tuple(pl.shape)}, {slot.dtype} {tuple(batch)}")
    out = packed.new_empty((L, C))
    if L:
        fn = _fn("grid_trilinear_launch", packed.dtype)
        err = fn(packed.data_ptr(), pl.data_ptr(), slot.data_ptr(),
                 out.data_ptr(), packed.shape[0], D, H, W, C, L,
                 _build.stream(dev))
        if err != 0:
            raise RuntimeError(f"grid_gather launch failed: cudaError {err}")
        launches["grid_gather" + _FLOATS[packed.dtype]] += 1
    return out.reshape(batch + (C,))


def _check_bwd(ct, pl, slot):
    """The backward entry's argument check (ct (L, C), pl (L, 3), slot
    (L,)): returns the CUDA device index."""
    L = slot.shape[0]
    dev = ct.get_device()
    if (ct.dtype not in _FLOATS or pl.dtype != ct.dtype
            or slot.dtype != torch.int32
            or ct.shape[0] != L or pl.shape[0] != L or dev < 0
            or pl.get_device() != dev or slot.get_device() != dev):
        raise ValueError(
            f"grid_gather: the trilinear backward takes a float32 or "
            f"float64 cotangent (..., C), points (..., 3) of its type and "
            f"int32 slots (...) on one CUDA device, got {ct.dtype} "
            f"{tuple(ct.shape)} on "
            f"{ct.device}, {pl.dtype} {tuple(pl.shape)}, {slot.dtype} "
            f"{tuple(slot.shape)}")
    return dev


def grid_trilinear_bwd(ct, grid_shape, slot, pl):
    """Launch the backward entry of csrc/grid_gather.cu on the current
    stream (no sync): ct (..., C) f32, the cotangent of grid_trilinear's
    output; slot (...) i32 and pl (..., 3) f32 as the lookup took them ->
    d_grid of ``grid_shape`` (S, D, H, W, C) f32 (each f32 f64 through the
    _f64 entry). Equal to volumes.trilinear_backward_plain up to the order
    of the atomic sums."""
    S, D, H, W, C = grid_shape
    ct = ct.reshape(-1, C).contiguous()
    slot = slot.reshape(-1).contiguous()
    pl = pl.reshape(-1, 3).contiguous()
    dev = _check_bwd(ct, pl, slot)
    # zeroed; the caching allocator aligns it to 512 bytes (the kernel's
    # vector reductions need 16)
    d_grid = ct.new_zeros(grid_shape)
    L = slot.shape[0]
    if L:
        fn = _fn("grid_trilinear_bwd_launch", ct.dtype)
        err = fn(ct.data_ptr(), pl.data_ptr(), slot.data_ptr(),
                 d_grid.data_ptr(), S * D * H * W, D, H, W, C, L,
                 _build.stream(dev))
        if err != 0:
            raise RuntimeError(
                f"grid_trilinear_bwd launch failed: cudaError {err}")
        launches["grid_trilinear_bwd" + _FLOATS[ct.dtype]] += 1
    return d_grid
