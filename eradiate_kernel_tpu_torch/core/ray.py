"""Ray batches (core/ray.py counterpart).

``wavelengths`` carries the hero wavelengths of the spectral variant, (N,
4); mono and rgb rays carry an empty (N, 0) tensor, the default.
"""

from __future__ import annotations

import dataclasses

import torch

from .math import RayEpsilon


@dataclasses.dataclass(frozen=True)
class Ray:
    o: torch.Tensor      # (N, 3)
    d: torch.Tensor      # (N, 3) unit direction
    mint: torch.Tensor   # (N,)
    maxt: torch.Tensor   # (N,)
    time: torch.Tensor   # (N,)
    wavelengths: torch.Tensor = None  # (N, nw); None: (N, 0)

    def __post_init__(self):
        if self.wavelengths is None:
            object.__setattr__(self, "wavelengths", self.o.new_zeros(
                self.o.shape[:-1] + (0,)))

    @staticmethod
    def make(o, d, mint=None, maxt=None, time=None, wavelengths=None):
        o, d = torch.broadcast_tensors(o, d)
        batch = o.shape[:-1]
        full = lambda v: torch.full(batch, v, dtype=o.dtype, device=o.device)
        return Ray(o=o, d=d,
                   mint=full(RayEpsilon) if mint is None else mint,
                   maxt=full(float("inf")) if maxt is None else maxt,
                   time=full(0.0) if time is None else time,
                   wavelengths=wavelengths)

    def at(self, t):
        return self.o + self.d * t[..., None]
