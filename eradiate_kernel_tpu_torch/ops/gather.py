"""Per-lane row gathers from a resident table: the port of the TPU gather
probe (tools/probe_pallas_gather.py, kernels ``k_fancy``/``k_take``/
``k_tala``/``k_onehot`` via ``call`` :87), generalised to rows.

    out[j, :] = table[clamp(idx[j], 0, V - 1), :]

``gather_rows`` launches the CUDA kernel ``csrc/grid_gather.cu`` for CUDA
tensors and runs the plain PyTorch version ``gather_rows_plain`` for CPU
tensors. The gridvolume lookups of textures/volumes.py (grids of more than
EINSUM_MAX_VOXELS voxels) fetch their packed 8-corner rows through it.
Indices are clamped like the reference's jnp gathers (torch indexing
would raise on them).
"""

from __future__ import annotations

import contextlib

import torch

from . import _build

# launches of the kernel in this process (the wrapper adds one per launch)
launches = {"grid_gather": 0}

_build.register("grid_gather", [_build.PTR] * 3 + [
    _build.LONG, _build.INT, _build.LONG, _build.INT, _build.INT,
    _build.PTR])

# test hook: run the plain version on CUDA tensors too (chip_smoke.py
# renders the same scene through both); see use_plain
_FORCE_PLAIN = False


@contextlib.contextmanager
def use_plain():
    """Route CUDA tensors through the plain gather for the duration (for
    the whole-path kernel-vs-plain checks only)."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def gather_rows_plain(table, idx):
    """table (V, R), idx (L,) integer -> (L, R): the plain version."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def _gather_cuda(table, idx):
    """Launch csrc/grid_gather.cu on the current stream (no sync)."""
    lib = _build.load("grid_gather")
    if table.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"grid_gather: table must be (V, R) and idx (L,), "
                         f"got {tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"grid_gather: idx must be int32 or int64, got "
                         f"{idx.dtype}")
    V, R = table.shape
    L = idx.shape[0]
    if V == 0:
        raise ValueError("grid_gather: empty table")
    dev = table.device
    _build.check("grid_gather", {"table": (table, torch.float32, (V, R)),
                                 "idx": (idx, idx.dtype, (L,))}, dev)
    out = torch.empty(L, R, dtype=torch.float32, device=dev)
    if L == 0 or R == 0:
        return out
    vec4 = (R % 4 == 0 and table.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.grid_gather_launch(table.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), V, R, L,
                                 int(idx.dtype == torch.int64), int(vec4),
                                 stream)
    if err != 0:
        raise RuntimeError(f"grid_gather launch failed: cudaError {err}")
    launches["grid_gather"] += 1
    return out


def gather_rows(table, idx):
    """out[j] = table[clamp(idx[j])] on the tensors' device: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors (or under
    use_plain)."""
    if table.device.type == "cpu" or _FORCE_PLAIN:
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"grid_gather: unsupported device {table.device}")
    return _gather_cuda(table, idx)
