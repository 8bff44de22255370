"""Per-lane row gathers from a resident table: the port of the TPU gather
probe (tools/probe_pallas_gather.py, kernels ``k_fancy``/``k_take``/
``k_tala``/``k_onehot`` via ``call`` :87), generalised to rows, and the
packed-corner trilinear lookup built on it. Both are entries of the CUDA
kernel ``csrc/grid_gather.cu``:

    gather_rows:    out[j, :] = table[clamp(idx[j], 0, V - 1), :]
    grid_trilinear: the trilinear lookup of textures/volumes.py's packed
                    path (corner c000's index, the 8-corner row, _lerp8)

Each launches its entry for CUDA tensors; for CPU tensors (or under
use_plain) the plain PyTorch versions serve: ``gather_rows_plain`` here and
``volumes.trilinear_gather_plain`` beside the eager chain it keeps. Indices
are clamped like the reference's jnp gathers (torch indexing would raise on
them). Every launch of either entry counts as a ``grid_gather`` launch.

The wrappers are lean: the ctypes functions are looked up once, the checks
compare attributes directly, and the stream is the raw current-stream
handle of ``_build.stream``.
"""

from __future__ import annotations

import contextlib

import torch

from . import _build

# launches of the kernel in this process (the wrappers add one per launch)
launches = {"grid_gather": 0}

_P, _I, _L = _build.PTR, _build.INT, _build.LONG
_build.register("grid_gather", {
    "grid_gather_launch": [_P] * 3 + [_L, _I, _L, _I, _I, _P],
    "grid_trilinear_launch": [_P] * 4 + [_L] + [_I] * 4 + [_L, _P]})

_F32 = torch.float32
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


def _fn(entry):
    fn = _fns.get(entry)
    if fn is None:
        fn = _fns[entry] = _build.entry("grid_gather", entry)
    return fn


def gather_rows_plain(table, idx):
    """table (V, R), idx (L,) integer -> (L, R): the plain version."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def _check_rows(table, idx):
    """The gather entry's argument check: returns the CUDA device index."""
    dev = table.get_device()
    if (table.dtype != _F32 or idx.dtype not in _IDX or table.dim() != 2
            or idx.dim() != 1 or dev < 0 or idx.get_device() != dev
            or not table.is_contiguous() or not idx.is_contiguous()
            or table.shape[0] == 0):
        raise ValueError(
            f"grid_gather: table must be a contiguous, non-empty (V, R) "
            f"float32 tensor and idx a contiguous (L,) int32/int64 tensor "
            f"on one CUDA device, got {table.dtype} {tuple(table.shape)} on "
            f"{table.device} and {idx.dtype} {tuple(idx.shape)} on "
            f"{idx.device}")
    return dev


def _gather_cuda(table, idx):
    """Launch the gather entry of csrc/grid_gather.cu on the current stream
    (no sync)."""
    fn = _fn("grid_gather_launch")
    dev = _check_rows(table, idx)
    V, R = table.shape
    L = idx.shape[0]
    out = table.new_empty((L, R))
    if L == 0 or R == 0:
        return out
    tp = table.data_ptr()
    # out comes from the caching allocator, aligned to 512 bytes
    vec4 = R % 4 == 0 and tp % 16 == 0
    err = fn(tp, idx.data_ptr(), out.data_ptr(), V, R, L,
             idx.dtype == torch.int64, vec4,
             _build.stream(dev))
    if err != 0:
        raise RuntimeError(f"grid_gather launch failed: cudaError {err}")
    launches["grid_gather"] += 1
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
    (...) i32, pl (..., 3) f32 -> (..., C) f32; bit-equal to
    volumes.trilinear_gather_plain."""
    fn = _fn("grid_trilinear_launch")
    S, D, H, W, C = grid_shape
    batch = slot.shape
    slot = slot.reshape(-1).contiguous()
    pl = pl.reshape(-1, 3).contiguous()
    L = slot.shape[0]
    dev = packed.get_device()
    if (packed.dtype != _F32 or pl.dtype != _F32
            or slot.dtype != torch.int32 or packed.dim() != 2
            or packed.shape[1] != 8 * C or packed.shape[0] == 0
            or pl.shape[0] != L or dev < 0 or pl.get_device() != dev
            or slot.get_device() != dev or not packed.is_contiguous()
            or packed.data_ptr() % 16):
        raise ValueError(
            f"grid_gather: the trilinear lookup takes a contiguous, 16-byte "
            f"aligned (V, {8 * C}) float32 table, float32 points (..., 3) "
            f"and int32 slots (...) on one CUDA device, got "
            f"{packed.dtype} {tuple(packed.shape)} on {packed.device}, "
            f"{pl.dtype} {tuple(pl.shape)}, {slot.dtype} {tuple(batch)}")
    out = packed.new_empty((L, C))
    if L:
        err = fn(packed.data_ptr(), pl.data_ptr(), slot.data_ptr(),
                 out.data_ptr(), packed.shape[0], D, H, W, C, L,
                 _build.stream(dev))
        if err != 0:
            raise RuntimeError(f"grid_gather launch failed: cudaError {err}")
        launches["grid_gather"] += 1
    return out.reshape(batch + (C,))
