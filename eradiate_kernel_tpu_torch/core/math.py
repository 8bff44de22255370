"""Elementary vector math (counterpart of eradiate_kernel_tpu/core/math.py).

Vectors are tensors with a trailing dimension of 3.
"""

from __future__ import annotations

import torch

from .rng import _div

# float32 machine epsilon * 1500: the self-intersection offset scale
RayEpsilon = 1.1920929e-07 * 1500.0
ShadowEpsilon = RayEpsilon * 10.0
# half the float32 machine epsilon (the unit roundoff)
EPSILON = float(torch.finfo(torch.float32).eps) / 2

# finite "no hit" distance (squares without float32 overflow)
INVALID_T = 1e18

_TINY = torch.finfo(torch.float32).tiny


def widen(x, *others):
    """``x`` in the widest floating dtype of it and ``others`` (tensors):
    the reference's promotion, where a float32 array meeting a float64
    value becomes float64. Torch keeps a float32 tensor float32 against a
    0-d float64 tensor; in float32 variants this is ``x`` itself."""
    dtype = x.dtype
    for o in others:
        dtype = torch.promote_types(dtype, o.dtype)
    return x.to(dtype)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_rsqrt(x):
    return torch.rsqrt(torch.clamp(x, min=_TINY))


def sqr(x):
    return x * x


def safe_acos(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def safe_asin(x):
    return torch.asin(torch.clamp(x, -1.0, 1.0))


def dot(a, b, keepdims=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def norm(v, keepdims=False):
    return torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=keepdims),
                                  min=0.0))


def squared_norm(v, keepdims=False):
    return torch.sum(v * v, dim=-1, keepdim=keepdims)


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


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def rcp(x):
    """The reciprocal, 1 / 0 = +-inf (IEEE)."""
    return 1.0 / x


def safe_div(a, b, eps=1e-20):
    """a / b, and 0 where |b| <= eps."""
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def fmadd(a, b, c):
    return a * b + c


def sign(x):
    """+1 where x >= 0 (+0 included), -1 elsewhere."""
    return torch.where(x >= 0, 1.0, -1.0)


def mulsign(a, b):
    """a * sign(b) with sign(+-0) = +-1."""
    return torch.where(b >= 0, a, -a)


def select(mask, a, b):
    """torch.where(mask, a, b), a lane mask broadcast over a's trailing
    axis when a carries one more axis."""
    if (mask is not None and getattr(mask, "ndim", 0) > 0
            and getattr(a, "ndim", 0) > mask.ndim):
        mask = mask[..., None]
    return torch.where(mask, a, b)


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


def sph_to_dir(theta, phi):
    """Spherical angles (theta from +z, phi from +x) -> unit direction."""
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def dir_to_sph(d):
    return safe_acos(d[..., 2]), torch.atan2(d[..., 1], d[..., 0])


def solve_quadratic(a, b, c):
    """The roots of a x^2 + b x + c = 0 -> (valid, x0, x1), x0 <= x1, by
    the stable form q = -(b + sign(b) sqrt(disc)) / 2; a ~= 0 solves the
    linear equation (mitsuba/core/math.h solve_quadratic)."""
    linear = torch.abs(a) < 1e-20
    x_lin = -c / torch.where(linear, torch.where(b == 0, 1.0, b), 1.0)
    valid_lin = linear & (b != 0.0)
    disc = b * b - 4.0 * a * c
    temp = -0.5 * (b + mulsign(safe_sqrt(disc), b))
    x0q = temp / torch.where(linear, 1.0, a)
    x1q = c / torch.where(temp == 0, 1.0, temp)
    valid = torch.where(linear, valid_lin, disc >= 0.0)
    x0 = torch.where(linear, x_lin, torch.minimum(x0q, x1q))
    x1 = torch.where(linear, x_lin, torch.maximum(x0q, x1q))
    return valid, x0, x1


def linear_search(values, x):
    """The index i with values[i] <= x < values[i + 1], clamped to
    [0, N - 2]; ``values`` (N,) ascending."""
    idx = torch.searchsorted(values, x, right=True) - 1
    return torch.clamp(idx, 0, values.shape[0] - 2)


def morton_encode2(x, y):
    """The Morton code of two 16-bit coordinates (their bits
    interleaved), in int64."""

    def part(v):
        v = v.to(torch.int64) & 0x0000FFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        return (v | (v << 1)) & 0x55555555

    return part(x) | (part(y) << 1)


def legendre_p(n: int, x):
    """The Legendre polynomial P_n(x) by its three-term recurrence."""
    if n == 0:
        return torch.ones_like(x)
    p0, p1 = torch.ones_like(x), x
    for k in range(2, n + 1):
        p0, p1 = p1, _div((2 * k - 1) * x * p1 - (k - 1) * p0, k)
    return p1
