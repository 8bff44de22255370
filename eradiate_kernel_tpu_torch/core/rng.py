"""Counter-based random numbers, bit-equal to eradiate_kernel_tpu/core/rng.py.

Threefry-2x32 (20 rounds) keyed by (seed, lane) with counter (dimension,
salt): any lane's d-th number is a pure function of (seed, lane, d), so the
port draws exactly the reference's samples. torch has no uint32 add, shift
or modulo on the CPU, so every uint32 value lives in an int64 tensor and is
masked back to 32 bits after each add and shift.
"""

from __future__ import annotations

import dataclasses

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 values held in int64 tensors
    (or Python ints); arguments broadcast. Returns two int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for block in range(5):
        for r in range(4):
            rot = _ROTATIONS[(block % 2) * 4 + r]
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << rot) | (x1 >> (32 - rot))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & MASK
    return x0, x1


def uint32_to_uniform(bits):
    """uint32 -> float32 in [0, 1) with 24 bits of mantissa."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_seed(seed: int):
    """Split a Python int seed into the (k0, k1) uint32 key pair."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s & MASK, (s >> 32) & MASK


@dataclasses.dataclass(frozen=True)
class Sampler:
    """The ``independent`` sampler: per-lane keys plus one dimension counter.

    k0/k1: per-lane key halves (int64 tensors holding uint32).
    dim:   the dimension counter. Every lane of a wavefront draws the same
           dimensions in the same order, so one Python int stands for the
           reference's per-lane uint32 array.
    """

    k0: torch.Tensor
    k1: torch.Tensor
    dim: int = 0

    @staticmethod
    def seed(seed: int, lane_index: torch.Tensor) -> "Sampler":
        """Decorrelated per-lane streams: key = threefry(seed, lane)."""
        s0, s1 = hash_seed(seed)
        lane = lane_index.to(torch.int64)
        k0, k1 = threefry2x32(s0, s1, lane, torch.zeros_like(lane))
        return Sampler(k0=k0, k1=k1, dim=0)

    def _bits(self, salt: int):
        return threefry2x32(self.k0, self.k1, self.dim, salt)

    def next_1d(self):
        b0, _ = self._bits(0)
        return (dataclasses.replace(self, dim=self.dim + 1),
                uint32_to_uniform(b0))

    def next_2d(self):
        b0, b1 = self._bits(1)
        return (dataclasses.replace(self, dim=self.dim + 1),
                torch.stack([uint32_to_uniform(b0), uint32_to_uniform(b1)],
                            dim=-1))
