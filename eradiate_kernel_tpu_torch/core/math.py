"""Elementary vector math (counterpart of eradiate_kernel_tpu/core/math.py).

Vectors are tensors with a trailing dimension of 3.
"""

from __future__ import annotations

import torch

# float32 machine epsilon * 1500: the self-intersection offset scale
RayEpsilon = 1.1920929e-07 * 1500.0
ShadowEpsilon = RayEpsilon * 10.0

# finite "no hit" distance (squares without float32 overflow)
INVALID_T = 1e18

_TINY = torch.finfo(torch.float32).tiny


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_rsqrt(x):
    return torch.rsqrt(torch.clamp(x, min=_TINY))


def sqr(x):
    return x * x


def dot(a, b, keepdim=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def channel_mean(v, keepdim=False):
    """The mean over the last axis as its sum times 1 / n: the reference's
    jnp.mean as XLA lowers it, to the ulp (a bump map's finite differences
    amplify an ulp of its height 1,000-fold)."""
    return torch.sum(v, dim=-1, keepdim=keepdim) * (1.0 / v.shape[-1])


def normalize(v):
    return v * safe_rsqrt(torch.sum(v * v, dim=-1, keepdim=True))


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def mulsign(a, b):
    """a * sign(b) with sign(+-0) = +-1."""
    return torch.where(b >= 0, a, -a)


def coordinate_system(n):
    """Orthonormal basis (s, t) around unit n (Duff et al. 2017)."""
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack([mulsign(sqr(n[..., 0]) * a, z) + 1.0,
                     mulsign(b, z),
                     mulsign(-n[..., 0], z)], dim=-1)
    t = torch.stack([b, sqr(n[..., 1]) * a + sign, -n[..., 1]], dim=-1)
    return s, t
