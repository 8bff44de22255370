"""Ray batches (core/ray.py counterpart).

The rgb variant carries no wavelengths, so the reference's empty
``wavelengths`` field is left out.
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

    @staticmethod
    def make(o, d, mint=None, maxt=None, time=None):
        o, d = torch.broadcast_tensors(o, d)
        batch = o.shape[:-1]
        full = lambda v: torch.full(batch, v, dtype=o.dtype, device=o.device)
        return Ray(o=o, d=d,
                   mint=full(RayEpsilon) if mint is None else mint,
                   maxt=full(float("inf")) if maxt is None else maxt,
                   time=full(0.0) if time is None else time)

    def at(self, t):
        return self.o + self.d * t[..., None]
