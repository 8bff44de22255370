"""Pieces the references share: the camera, the RPV BRDF, frames and the
film sums. Plain PyTorch on any device and in any float type."""

import math

import torch

# sRGB (D65) white in CIE XYZ: the film's X, Y and Z of a grey radiance of 1
XYZ_WHITE = (0.412453 + 0.357580 + 0.180423,
             0.212671 + 0.715160 + 0.072169,
             0.019334 + 0.119193 + 0.950227)


def normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def dot(a, b):
    return (a * b).sum(-1)


def camera_rays(cam, width, height, pixel, u1, u2, dtype):
    """Pinhole camera rays through jittered positions of ``pixel`` (flat
    index row * width + col), field of view ``cam['fov']`` degrees along x.
    Film x runs to the camera's right, film y downwards (the look_at frame:
    left = up x forward, the film's +x at -left)."""
    dev = pixel.device
    o = torch.tensor(cam["camera_origin"], dtype=torch.float64)
    fwd = normalize(torch.tensor(cam["camera_target"], dtype=torch.float64)
                    - o)
    left = normalize(torch.cross(torch.tensor(cam["camera_up"],
                                              dtype=torch.float64), fwd,
                                 dim=0))
    up = torch.cross(fwd, left, dim=0)
    basis = torch.stack([left, up, fwd]).to(dev, dtype)      # rows
    col = (pixel % width).to(dtype)
    row = (pixel // width).to(dtype)
    fx = (col + u1) / width
    fy = (row + u2) / height
    tan_half = math.tan(math.radians(cam["fov"]) / 2)
    x = -(2 * fx - 1) * tan_half
    y = -(2 * fy - 1) * tan_half * (height / width)
    d = normalize(torch.stack([x, y, torch.ones_like(x)], -1) @ basis)
    return o.to(dev, dtype).expand_as(d), d


def rpv(cfg, n, wi, wo):
    """Rahman-Pinty-Verstraete BRDF value (no cosine) of the surface with
    normal ``n`` for unit directions ``wi`` and ``wo`` pointing away from
    it (Rahman, Pinty & Verstraete 1993; rho_c = rho_0)."""
    rho0, g, k = cfg["rpv_rho_0"], cfg["rpv_g"], cfg["rpv_k"]
    c1 = dot(wi, n)
    c2 = dot(wo, n)
    t1 = wi - c1[..., None] * n
    t2 = wo - c2[..., None] * n
    s1 = torch.linalg.vector_norm(t1, dim=-1)
    s2 = torch.linalg.vector_norm(t2, dim=-1)
    cos_dphi = torch.where((s1 > 0) & (s2 > 0),
                           dot(t1, t2) / torch.clamp(s1 * s2, min=1e-30), 1.0)
    c1 = torch.clamp(c1, min=1e-6)
    c2 = torch.clamp(c2, min=1e-6)
    tan1, tan2 = s1 / c1, s2 / c2
    G = torch.sqrt(torch.clamp(tan1 * tan1 + tan2 * tan2
                               - 2 * tan1 * tan2 * cos_dphi, min=0))
    cos_g = c1 * c2 + s1 * s2 * cos_dphi
    F = (1 - g * g) / (1 + g * g + 2 * g * cos_g) ** 1.5
    minnaert = (c1 * c2 * (c1 + c2)) ** (k - 1)
    return rho0 * minnaert * F * (1 + (1 - rho0) / (1 + G)) / math.pi


def frame(n):
    """Two unit tangents completing ``n`` (Duff et al. 2017)."""
    sign = torch.where(n[..., 2] >= 0, 1.0, -1.0).to(n.dtype)
    a = -1 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack([1 + sign * n[..., 0] ** 2 * a, sign * b,
                     -sign * n[..., 0]], -1)
    t = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return s, t


def cosine_hemisphere(n, u1, u2):
    """Cosine-distributed unit directions about ``n``."""
    r = torch.sqrt(u1)
    phi = 2 * math.pi * u2
    z = torch.sqrt(torch.clamp(1 - u1, min=0))
    s, t = frame(n)
    return normalize((r * torch.cos(phi))[..., None] * s
                     + (r * torch.sin(phi))[..., None] * t
                     + z[..., None] * n)


def uniform_sphere(u1, u2):
    z = 1 - 2 * u1
    r = torch.sqrt(torch.clamp(1 - z * z, min=0))
    phi = 2 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


class Stream:
    """Uniform numbers in [0, 1) from a seeded generator on ``device``,
    drawn in float32 and handed over in ``dtype``."""

    def __init__(self, seed, device, dtype):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.device, self.dtype = device, dtype

    def __call__(self, n):
        u = torch.rand(n, generator=self.gen, device=self.device)
        return u.to(self.dtype)


def accumulate_dtype(dtype):
    """Film sums: float64 behind a float32 estimator; the estimator's own
    type below that (the control sums as it computes)."""
    return torch.float64 if dtype == torch.float32 else dtype


def film_from_sums(total, count, dtype=torch.float32):
    """(H, W, 5) film [X, Y, Z, A, W] of grey radiance sums, the port's
    raw film layout: the control hands this to the comparison."""
    white = torch.tensor(XYZ_WHITE, dtype=total.dtype, device=total.device)
    xyz = total[..., None] * white
    w = count.to(total.dtype)[..., None]
    return torch.cat([xyz, w, w], -1).to(dtype)
