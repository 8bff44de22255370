"""Ray batches (core/ray.py counterpart).

``wavelengths`` carries the hero wavelengths of the spectral variant, (N,
4); mono and rgb rays carry an empty (N, 0) tensor, the default.
"""

from __future__ import annotations

import dataclasses

import torch

from .math import RayEpsilon, dot


@dataclasses.dataclass(frozen=True)
class Ray:
    o: torch.Tensor      # (N, 3)
    d: torch.Tensor      # (N, 3) unit direction
    mint: torch.Tensor   # (N,)
    maxt: torch.Tensor   # (N,)
    time: torch.Tensor   # (N,)
    wavelengths: torch.Tensor = None  # (N, nw); None: (N, 0)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

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

    def with_bounds(self, mint=None, maxt=None):
        """The ray with ``mint`` and / or ``maxt`` (numbers or tensors)
        broadcast over its lanes."""
        r = self
        if mint is not None:
            r = r.replace(mint=torch.as_tensor(
                mint, dtype=r.mint.dtype, device=r.mint.device).expand(
                r.mint.shape))
        if maxt is not None:
            r = r.replace(maxt=torch.as_tensor(
                maxt, dtype=r.maxt.dtype, device=r.maxt.device).expand(
                r.maxt.shape))
        return r


def spawn_ray(p, n, d, wavelengths, time, maxt=None):
    """A ray leaving ``p`` along ``d``, its origin offset along the
    geometric normal ``n`` by RayEpsilon (1 + max |p|) to the side ``d``
    leaves by (interaction.h spawn_ray); ``maxt`` defaults to inf."""
    eps = RayEpsilon * (1.0 + torch.amax(torch.abs(p), dim=-1))
    sgn = torch.where(dot(n, d) >= 0.0, 1.0, -1.0)
    o = p + (eps * sgn)[..., None] * n
    batch = p.shape[:-1]
    if maxt is None:
        maxt = torch.full(batch, float("inf"), dtype=p.dtype, device=p.device)
    return Ray(o=o, d=d, mint=torch.zeros(batch, dtype=p.dtype,
                                          device=p.device),
               maxt=maxt, time=time, wavelengths=wavelengths)
