"""Shading frame and local-frame trigonometry (core/frame.py counterpart)."""

from __future__ import annotations

import dataclasses

import torch

from .math import coordinate_system, dot, safe_sqrt, sqr


@dataclasses.dataclass(frozen=True)
class Frame:
    s: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor

    @staticmethod
    def from_normal(n):
        s, t = coordinate_system(n)
        return Frame(s=s, t=t, n=n)

    def to_local(self, v):
        return torch.stack([dot(v, self.s), dot(v, self.t), dot(v, self.n)],
                           dim=-1)

    def to_world(self, v):
        return (self.s * v[..., 0:1] + self.t * v[..., 1:2]
                + self.n * v[..., 2:3])

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def cos_theta(v):
    return v[..., 2]


def cos_theta_2(v):
    return sqr(v[..., 2])


def sin_theta_2(v):
    return torch.clamp(1.0 - sqr(v[..., 2]), min=0.0)


def sin_theta(v):
    return safe_sqrt(sin_theta_2(v))


def tan_theta(v):
    return sin_theta(v) / v[..., 2]


def tan_theta_2(v):
    return sin_theta_2(v) / torch.clamp(sqr(v[..., 2]), min=1e-20)


def sin_phi(v):
    s = sin_theta(v)
    return torch.where(s > 1e-9, v[..., 1] / torch.clamp(s, min=1e-9), 0.0)


def cos_phi(v):
    s = sin_theta(v)
    return torch.where(s > 1e-9, v[..., 0] / torch.clamp(s, min=1e-9), 1.0)


def sin_cos_phi_2(v):
    s2 = sin_theta_2(v)
    inv = torch.where(s2 > 1e-18, 1.0 / torch.clamp(s2, min=1e-18), 0.0)
    sin2 = torch.clamp(sqr(v[..., 1]) * inv, 0.0, 1.0)
    cos2 = torch.clamp(sqr(v[..., 0]) * inv, 0.0, 1.0)
    return (torch.where(s2 > 1e-18, sin2, 0.0),
            torch.where(s2 > 1e-18, cos2, 1.0))


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0
