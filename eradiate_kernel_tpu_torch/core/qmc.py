"""Radical-inverse QMC point sets (core/qmc.py counterpart; Mitsuba's
qmc.h).

``radical_inverse(base_index, index)`` digit-reverses ``index`` in the
``base_index``-th prime base. The scrambled variant passes every digit
through an affine permutation keyed by (base, seed), the reference's
stand-in for qmc.h's Faure permutation tables. uint32 values live in int64
tensors, masked to 32 bits after every multiply.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_N_PRIMES = 1024
MAX_DIGITS = 32  # uint32 indices: enough digits for every base >= 2


def _sieve_primes(n):
    limit = 1 << 14
    while True:
        is_p = np.ones(limit, bool)
        is_p[:2] = False
        for i in range(2, int(limit ** 0.5) + 1):
            if is_p[i]:
                is_p[i * i::i] = False
        primes = np.flatnonzero(is_p)
        if primes.size >= n:
            return primes[:n].astype(np.int64)
        limit *= 2


PRIMES = _sieve_primes(_N_PRIMES)


def prime_base(base_index):
    """The ``base_index``-th prime (an int64 tensor)."""
    return torch.as_tensor(PRIMES)[torch.as_tensor(base_index)]


def _digits(base_index, index, perm=None):
    """sum_k perm(digit_k) base^-(k+1) over MAX_DIGITS digits, and the
    last weight base^-MAX_DIGITS."""
    index = torch.as_tensor(index).to(torch.int64)
    base = prime_base(base_index).to(index.device)
    inv_base = 1.0 / base.to(torch.float32)
    value = torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    inv = inv_base.expand(index.shape)
    for _ in range(MAX_DIGITS):
        digit = index % base
        if perm is not None:
            digit = perm(digit)
        value = value + digit.to(torch.float32) * inv
        inv = inv * inv_base
        index = index // base
    return value, inv, base, inv_base


def radical_inverse(base_index, index):
    """The van der Corput radical inverse of ``index`` in the
    ``base_index``-th prime base, broadcast over both arguments."""
    value, _inv, _base, _ib = _digits(base_index, index)
    return torch.clamp(value, max=1.0 - 1e-7)


def _perm(digit, base, key):
    """d -> (a d + b) mod base with a in [1, base): a bijection for a
    prime base, keyed by ``key``."""
    a = 1 + key % (base - 1)
    b = (key >> 16) % base
    return (a * digit + b) % base


def radical_inverse_scrambled(base_index, index, seed):
    """The radical inverse with every digit passed through a seeded
    permutation of [0, base)."""
    base = prime_base(base_index)
    seed = torch.as_tensor(seed).to(torch.int64) & _MASK
    key = ((seed * 0x9E3779B9) & _MASK) ^ ((base * 0x85EBCA6B) & _MASK)
    index = torch.as_tensor(index)
    key = key.to(index.device)
    value, inv, base, inv_base = _digits(
        base_index, index, lambda d: _perm(d, base.to(index.device), key))
    # a permuted zero digit is nonzero: the tail of zero digits adds
    # perm(0) times a geometric series
    zero = _perm(torch.zeros_like(key), base, key).to(torch.float32)
    return torch.clamp(value + zero * inv / (1.0 - inv_base), 0.0,
                       1.0 - 1e-7)
