"""Mueller and Stokes calculus (core/mueller.py counterpart; mueller.h).

Stokes vectors are (..., 4) tensors [S0 intensity, S1 0/90 linear, S2
+-45 linear, S3 circular]; Mueller matrices are (..., 4, 4). A Stokes
basis is defined with respect to a propagation direction and a horizontal
axis; ``rotate_stokes_basis`` re-expresses a vector in a rotated basis,
and ``rotated_element`` conjugates an optical element. The 4x4 products
are small batched matmuls.
"""

from __future__ import annotations

import math

import torch

from .math import coordinate_system, cross, dot


def _matrix(entries, like):
    """(..., 4, 4) with the entries {(i, j): value} and zeros elsewhere;
    ``like`` gives the batch shape, dtype and device."""
    z = torch.zeros_like(like)
    full = {k: torch.broadcast_to(torch.as_tensor(v, dtype=like.dtype,
                                                  device=like.device),
                                  like.shape)
            for k, v in entries.items()}
    return torch.stack([torch.stack([full.get((i, j), z) for j in range(4)],
                                    -1) for i in range(4)], -2)


def _tensor(value, dtype=torch.float32):
    return value if torch.is_tensor(value) else torch.as_tensor(value,
                                                                dtype=dtype)


def depolarizer(value=1.0):
    """Scales intensity and removes polarization (mueller.h depolarizer)."""
    value = _tensor(value)
    return _matrix({(0, 0): value}, value)


def absorber(value):
    """Ideal absorber: uniform attenuation (mueller.h absorber)."""
    value = _tensor(value)
    return torch.eye(4, dtype=value.dtype, device=value.device) \
        * value[..., None, None]


def linear_polarizer(value=1.0):
    """Ideal linear polarizer along the horizontal axis
    (mueller.h linear_polarizer); ``value`` is the peak transmittance."""
    value = _tensor(value)
    a = 0.5 * value
    return _matrix({(0, 0): a, (0, 1): a, (1, 0): a, (1, 1): a}, value)


def linear_retarder(phase):
    """Linear retarder with its fast axis horizontal and the phase delay
    ``phase`` (mueller.h linear_retarder); pi is a half-wave plate."""
    phase = _tensor(phase)
    c = torch.cos(phase)
    s = torch.sin(phase)
    return _matrix({(0, 0): 1.0, (1, 1): 1.0, (2, 2): c, (3, 3): c,
                    (2, 3): s, (3, 2): -s}, phase)


def right_circular_polarizer(dtype=torch.float32, device=None):
    """mueller.h right_circular_polarizer."""
    return torch.tensor([[0.5, 0, 0, 0.5], [0, 0, 0, 0], [0, 0, 0, 0],
                         [0.5, 0, 0, 0.5]], dtype=dtype, device=device)


def left_circular_polarizer(dtype=torch.float32, device=None):
    """mueller.h left_circular_polarizer."""
    return torch.tensor([[0.5, 0, 0, -0.5], [0, 0, 0, 0], [0, 0, 0, 0],
                         [-0.5, 0, 0, 0.5]], dtype=dtype, device=device)


def rotator(theta):
    """Rotation of the Stokes frame by ``theta`` (mueller.h rotator)."""
    theta = _tensor(theta)
    c = torch.cos(2.0 * theta)
    s = torch.sin(2.0 * theta)
    return _matrix({(0, 0): 1.0, (3, 3): 1.0, (1, 1): c, (1, 2): s,
                    (2, 1): -s, (2, 2): c}, theta)


def rotated_element(theta, m):
    """An element conjugated by basis rotations, R(theta) M R(-theta)
    (mueller.h rotated_element)."""
    theta = _tensor(theta)
    return rotator(theta) @ m @ rotator(-theta)


def specular_reflection(cos_theta_i, eta_c_real, eta_c_imag=None):
    """Mueller matrix of specular reflection off a (possibly conducting)
    interface (mueller.h specular_reflection): the s and p amplitudes of
    the complex Fresnel equations, in explicit real and imaginary parts.
    ``cos_theta_i`` >= 0; ``eta`` the relative IOR (real, and optionally
    imaginary). The three broadcast: a cosine with a keepdim channel axis
    against a per-channel conductor spectrum."""
    ci = torch.clamp(_tensor(cos_theta_i), 1e-6, 1.0)
    er = _tensor(eta_c_real, ci.dtype).to(ci.device)
    ei = torch.zeros_like(er) if eta_c_imag is None else _tensor(
        eta_c_imag, ci.dtype).to(ci.device)
    ci, er, ei = torch.broadcast_tensors(ci, er, ei)
    si2 = 1.0 - ci * ci
    e2_r = er * er - ei * ei
    e2_i = 2 * er * ei
    # ct = sqrt(eta^2 - sin^2), complex
    a_r = e2_r - si2
    a_i = e2_i
    mod = torch.sqrt(torch.sqrt(a_r * a_r + a_i * a_i))
    arg = 0.5 * torch.atan2(a_i, a_r)
    ct_r = mod * torch.cos(arg)
    ct_i = mod * torch.sin(arg)

    def cdiv(ar, ai, br, bi):
        d = br * br + bi * bi
        return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d

    # r_s = (ci - ct) / (ci + ct); r_p = (eta^2 ci - ct) / (eta^2 ci + ct)
    rs_r, rs_i = cdiv(ci - ct_r, -ct_i, ci + ct_r, ct_i)
    rp_r, rp_i = cdiv(e2_r * ci - ct_r, e2_i * ci - ct_i,
                      e2_r * ci + ct_r, e2_i * ci + ct_i)
    Rs = rs_r * rs_r + rs_i * rs_i
    Rp = rp_r * rp_r + rp_i * rp_i
    # the relative phase of s and p
    amp = torch.clamp(torch.sqrt(Rs * Rp), min=1e-20)
    cos_delta = (rs_r * rp_r + rs_i * rp_i) / amp
    sin_delta = (rs_i * rp_r - rs_r * rp_i) / amp
    a = 0.5 * (Rs + Rp)
    b = 0.5 * (Rs - Rp)
    c = torch.sqrt(Rs * Rp) * cos_delta
    s = torch.sqrt(Rs * Rp) * sin_delta
    return _matrix({(0, 0): a, (1, 1): a, (0, 1): b, (1, 0): b, (2, 2): c,
                    (3, 3): c, (2, 3): s, (3, 2): -s}, ci)


def specular_transmission(cos_theta_i, eta):
    """Mueller matrix of specular transmission through a dielectric
    (mueller.h specular_transmission); zero under total internal
    reflection."""
    ci = torch.clamp(_tensor(cos_theta_i), 1e-6, 1.0)
    eta = _tensor(eta, ci.dtype).to(ci.device)
    si2 = 1.0 - ci * ci
    ct2 = 1.0 - si2 / (eta * eta)
    valid = ct2 > 0
    ct = torch.sqrt(torch.clamp(ct2, min=1e-12))
    ts = 2.0 * ci / (ci + eta * ct)
    tp = 2.0 * ci / (eta * ci + ct)
    factor = eta * ct / ci  # the radiance / irradiance geometry factor
    Ts = ts * ts * factor
    Tp = tp * tp * factor
    a = 0.5 * (Ts + Tp)
    b = 0.5 * (Ts - Tp)
    c = torch.sqrt(Ts * Tp)
    m = _matrix({(0, 0): a, (1, 1): a, (0, 1): b, (1, 0): b, (2, 2): c,
                 (3, 3): c}, a)
    return torch.where(valid[..., None, None], m, 0.0)


def rayleigh_scatter(cos_theta):
    """The Rayleigh scattering matrix (Hansen & Travis 1974 eq. 2.15) in
    the scattering-plane frame whose horizontal axis is perpendicular to
    the scattering plane for both directions; ``cos_theta`` is the cosine
    of the scattering angle. M[0, 0] is the scalar Rayleigh phase value
    3 / (16 pi) (1 + cos^2), so S0 transport is the unpolarized one."""
    c = _tensor(cos_theta)
    k = 3.0 / (16.0 * math.pi)
    s2 = 1.0 - c * c
    return _matrix({(0, 0): k * (1.0 + c * c), (1, 1): k * (1.0 + c * c),
                    (0, 1): k * s2, (1, 0): k * s2, (2, 2): k * 2.0 * c,
                    (3, 3): k * 2.0 * c}, c)


def stokes_basis(d):
    """The canonical horizontal basis vector perpendicular to the
    propagation direction ``d`` (mueller.h stokes_basis)."""
    s, _t = coordinate_system(d)
    return s


def rotate_stokes_basis(d, basis_current, basis_target):
    """The rotator that re-expresses Stokes vectors from ``basis_current``
    to ``basis_target``, both perpendicular to ``d``
    (mueller.h rotate_stokes_basis)."""
    x = dot(basis_current, basis_target)
    y = dot(cross(basis_current, basis_target), d)
    return rotator(torch.atan2(y, x))


def rotate_mueller_basis(m, in_d, in_basis_current, in_basis_target,
                         out_d, out_basis_current, out_basis_target):
    """A Mueller matrix under new incident and outgoing Stokes frames
    (mueller.h:324-334): R_out @ M @ R_in^T."""
    r_in = rotate_stokes_basis(in_d, in_basis_current, in_basis_target)
    r_out = rotate_stokes_basis(out_d, out_basis_current, out_basis_target)
    return r_out @ m @ r_in.transpose(-1, -2)


def rotate_mueller_basis_collinear(m, d, basis_current, basis_target):
    """The same-frame variant (mueller.h:363-369): R @ M @ R^T."""
    r = rotate_stokes_basis(d, basis_current, basis_target)
    return r @ m @ r.transpose(-1, -2)


def plane_basis(v, d, eps=1e-14):
    """normalize(v), a basis vector perpendicular to a plane (of incidence,
    of a microfacet reflection), or stokes_basis(d) where v degenerates
    (normal incidence, where the Fresnel matrix is rotationally symmetric
    and any frame serves)."""
    n2 = dot(v, v, keepdims=True)
    ok = n2 > eps
    v = torch.where(ok, v, 1.0)
    v = v / torch.sqrt(torch.where(ok, dot(v, v, keepdims=True), 1.0))
    return torch.where(ok, v, stokes_basis(d))


def to_local_frames(m, wo_hat, wi_hat, s_in, s_out, channels=False):
    """``m`` given in the frames whose horizontal axes are ``s_in`` (light
    arriving along -wo_hat) and ``s_out`` (leaving along wi_hat),
    re-expressed in the implicit local Stokes bases of those directions;
    ``channels``: m carries a channel axis before the 4x4."""
    exp = (lambda v: v[..., None, :]) if channels else (lambda v: v)
    return rotate_mueller_basis(
        m, exp(-wo_hat), exp(s_in), exp(stokes_basis(-wo_hat)),
        exp(wi_hat), exp(s_out), exp(stokes_basis(wi_hat)))


def to_world_mueller(sh_frame, m, in_forward_local, out_forward_local):
    """A Mueller matrix given on shading-frame directions re-expressed in
    the implicit world-space Stokes bases (interaction.h:275-296
    to_world_mueller): matrices of consecutive path vertices then compose
    by plain matmul. ``m`` (..., nc, 4, 4) or (..., 4, 4); the two
    directions (..., 3) are the light's propagation directions."""
    in_w = sh_frame.to_world(in_forward_local)
    out_w = sh_frame.to_world(out_forward_local)
    in_cur = sh_frame.to_world(stokes_basis(in_forward_local))
    out_cur = sh_frame.to_world(stokes_basis(out_forward_local))
    if m.ndim == in_w.ndim + 2:  # a channel axis between batch and 4x4
        exp = lambda v: v[..., None, :]
    else:
        exp = lambda v: v
    return rotate_mueller_basis(
        m, exp(in_w), exp(in_cur), exp(stokes_basis(in_w)),
        exp(out_w), exp(out_cur), exp(stokes_basis(out_w)))
