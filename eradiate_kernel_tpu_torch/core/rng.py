"""Counter-based random numbers, bit-equal to eradiate_kernel_tpu/core/rng.py.

Threefry-2x32 (20 rounds) keyed by (seed, lane) with counter (dimension,
salt): any lane's d-th number is a pure function of (seed, lane, d), so the
port draws exactly the reference's samples, for the ``independent`` kind
and the four stratifying kinds. torch has no uint32 add, shift
or modulo on the CPU, so every uint32 value lives in an int64 tensor and is
masked back to 32 bits after each add and shift.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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


def _div(x, n):
    """x / n correctly rounded on every device: CUDA divides a tensor by a
    Python number as a multiply by its reciprocal, which the reference's
    division is not (n = 9: 1 ulp off), so n comes as a 0-d tensor made
    on x's device."""
    return x / x.new_full((), float(n))


def _radical_inverse_2(bits):
    """Base-2 radical inverse (bit reversal): the first dimension of the
    (0,2)-sequence. Left shifts are masked back to 32 bits."""
    bits = ((bits << 16) | (bits >> 16)) & MASK
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    return ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)


def _sobol_2(index):
    """Second dimension of the (0,2)-sequence (Sobol' direction numbers of
    the y component): a fixed 32-step loop over the index's bits."""
    v = 1 << 31
    result = torch.zeros_like(index)
    for _ in range(32):
        result = torch.where((index & 1) != 0, result ^ v, result)
        index = index >> 1
        v = v ^ (v >> 1)
    return result


SAMPLER_KINDS = ("independent", "stratified", "multijitter", "orthogonal",
                 "ldsampler")


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Stateless-counter sampler carried through wavefront loops.

    k0/k1: per-lane key halves (int64 tensors holding uint32), hashed from
           (seed, lane) for ``independent`` and from (seed, pixel) for the
           stratifying kinds, which stratify within a pixel's spp samples.
    dim:   the dimension counter. Every lane of a wavefront draws the same
           dimensions in the same order, so one Python int stands for the
           reference's per-lane uint32 array (the lane pool widens it to a
           per-lane tensor).
    s_idx: the sample index within the pixel (int64, < spp); zeros for
           ``independent``.

    ``kind`` is one of ``SAMPLER_KINDS``: stratified (jittered strata on an
    sx * sy grid), multijitter and orthogonal (correlated multi-jitter with
    hash rotations), ldsampler (an xor-scrambled (0,2)-sequence).
    """

    k0: torch.Tensor
    k1: torch.Tensor
    dim: int
    s_idx: torch.Tensor
    kind: str = "independent"
    spp: int = 1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @staticmethod
    def seed(seed: int, lane_index: torch.Tensor, kind: str = "independent",
             spp: int = 1) -> "Sampler":
        """Decorrelated per-lane streams: key = threefry(seed, lane), or for
        a stratifying kind threefry(seed, lane // spp) with ``s_idx`` the
        lane's index within its pixel."""
        if kind not in SAMPLER_KINDS:
            raise ValueError(f"unknown sampler kind {kind!r}")
        s0, s1 = hash_seed(seed)
        lane = lane_index.to(torch.int64)
        zero = torch.zeros_like(lane)
        if kind == "independent":
            k0, k1 = threefry2x32(s0, s1, lane, zero)
            return Sampler(k0=k0, k1=k1, dim=0, s_idx=zero)
        spp = int(spp)
        k0, k1 = threefry2x32(s0, s1, lane // spp, zero)
        return Sampler(k0=k0, k1=k1, dim=0, s_idx=lane % spp, kind=kind,
                       spp=spp)

    def _bits(self, salt: int):
        """Shared across a pixel's samples (rotation and scramble keys)."""
        return threefry2x32(self.k0, self.k1, self.dim, salt)

    def _bits_s(self, salt: int):
        """Unique per sample (the jitter): mixes the in-pixel index."""
        return threefry2x32(self.k0, self.k1, self.dim,
                            ((self.s_idx << 3) | salt) & MASK)

    def _grid_2d(self):
        """(sx, sy): the 2D strata factorization of spp."""
        sx = int(np.floor(np.sqrt(self.spp)))
        while self.spp % sx != 0:
            sx -= 1
        return sx, self.spp // sx

    def _step(self):
        return dataclasses.replace(self, dim=self.dim + 1)

    def next_1d(self):
        b0, b1 = self._bits(0)
        if self.kind == "independent":
            return self._step(), uint32_to_uniform(b0)
        j0, _ = self._bits_s(4)
        u = uint32_to_uniform(j0)
        rot = b1 % self.spp  # a per-dim rotation of the in-pixel index
        if self.kind == "ldsampler":
            vdc = _radical_inverse_2(
                (self.s_idx + ((rot * 0x9E3779B9) & MASK)) & MASK)
            u = uint32_to_uniform(vdc ^ b1)
        else:
            idx = (self.s_idx + rot) % self.spp
            u = _div(idx.to(torch.float32) + u, self.spp)
        return self._step(), u

    def next_2d(self):
        b0, b1 = self._bits(1)
        if self.kind == "independent":
            return self._step(), torch.stack(
                [uint32_to_uniform(b0), uint32_to_uniform(b1)], dim=-1)
        j0, j1 = self._bits_s(5)
        u0 = uint32_to_uniform(j0)
        u1 = uint32_to_uniform(j1)
        b2, b3 = self._bits(2)
        idx = (self.s_idx + b2 % self.spp) % self.spp
        if self.kind == "ldsampler":
            x = _radical_inverse_2(idx) ^ b0
            y = _sobol_2(idx) ^ b1
            pt = torch.stack([uint32_to_uniform(x), uint32_to_uniform(y)], -1)
        elif self.kind == "stratified":
            sx, sy = self._grid_2d()
            gx = (idx % sx).to(torch.float32)
            gy = (idx // sx).to(torch.float32)
            pt = torch.stack([_div(gx + u0, sx), _div(gy + u1, sy)], -1)
        else:  # multijitter / orthogonal: correlated multi-jitter layout
            sx, sy = self._grid_2d()
            gx = idx % sx
            gy = idx // sx
            r0, r1 = threefry2x32(self.k0 ^ b3, self.k1, gx, gy)
            jx = (gy + r0 % sy) % sy
            jy = (gx + r1 % sx) % sx
            px = _div(gx.to(torch.float32)
                      + _div(jx.to(torch.float32) + u0, sy), sx)
            py = _div(gy.to(torch.float32)
                      + _div(jy.to(torch.float32) + u1, sx), sy)
            pt = torch.stack([px, py], -1)
        return self._step(), pt

    def fork(self, salt: int) -> "Sampler":
        """An independent stream that keeps ``s_idx`` (NEE walks)."""
        k0, k1 = threefry2x32(self.k0, self.k1, 0xF0F0F0F0, salt)
        return Sampler(k0=k0, k1=k1, dim=0, s_idx=self.s_idx)
