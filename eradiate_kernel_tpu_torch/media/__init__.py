"""Participating media (media/__init__.py counterpart): homogeneous and
heterogeneous (gridvolume sigma_t) media, profile-majorant free flight,
and the control/residual tables of the residual ratio-tracking NEE walk.

Free flight samples against the LOCAL z-profile majorant of the segment
(``_flight_profile_setup``/``_flight_sample``: piecewise constant along
the ray, inverse-transform sampled in closed form); ``eval_tr_and_pdf``
rebuilds its optical depth from the parametrization stored on the
interaction. Each function that returns a value per channel takes the
lanes' ``wavelengths`` (N, nw): the spectral variant evaluates its spectra
and volumes there (nc = nw); mono and rgb rays carry (N, 0) and nc is the
variant's. The majorants and rates are sampling parameters: the segment
majorant (``medium_majorant_segment``) and the rate profile and constant
rate of ``_flight_profile_setup`` are detached, as the reference detaches
them (volpath.cpp:83), so the residual walk's collision rate, which is
read off that profile, is detached too. The optical depth rebuilt from
the profile (``eval_tr_and_pdf``) and the media's sigma values stay
attached: gradients reach the scene through sigma_t, sigma_s and sigma_n,
never through a sampling decision.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math import INVALID_T
from ..core.transform import Transform
from ..render.texture import scene_spectrum_eval
from ..scene.build_spectra import AXPROF_BINS
from ..textures.volumes import volume_eval
from ..utils.runtime import scoped_phase


@dataclasses.dataclass(frozen=True)
class MediumInteraction:
    """A sampled medium event (SoA). The ff_* fields carry the lane's
    profile free-flight parametrization (ff_on lanes); other lanes use the
    constant-majorant formulas."""

    t: torch.Tensor        # (N,) INVALID_T if no medium interaction
    p: torch.Tensor        # (N, 3)
    mint: torch.Tensor     # (N,)
    sigma_s: torch.Tensor  # (N, nc)
    sigma_n: torch.Tensor  # (N, nc)
    sigma_t: torch.Tensor  # (N, nc)
    combined_extinction: torch.Tensor  # (N, nc) local majorant for ff_on
    maxt: torch.Tensor     # (N,) segment end used for sampling
    ff_mq: torch.Tensor    # (N, P) travel-coordinate majorant profile
    ff_qa: torch.Tensor    # (N,) travel coordinate of mint
    ff_qb: torch.Tensor    # (N,) travel coordinate of maxt
    ff_adlz: torch.Tensor  # (N,) |d local z| per world t
    ff_on: torch.Tensor    # (N,) bool: profile-flight lanes

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def is_valid(self):
        return self.t < 0.5 * INVALID_T


def invalid_mi(n, nc, device, dtype=torch.float32):
    """An invalid interaction in ``dtype`` with zero coefficients (every
    consumer of a skipped sampling site is masked)."""
    f = lambda *shape, v=0.0: torch.full(shape, v, dtype=dtype,
                                         device=device)
    z, zn = f(n, nc), f(n)
    return MediumInteraction(
        t=f(n, v=INVALID_T), p=f(n, 3), mint=zn, sigma_s=z, sigma_n=z,
        sigma_t=z, combined_extinction=z, maxt=f(n, v=INVALID_T),
        ff_mq=f(n, AXPROF_BINS), ff_qa=zn, ff_qb=zn, ff_adlz=f(n, v=1.0),
        ff_on=torch.zeros(n, dtype=torch.bool, device=device))


def _kind_slot(scene, medium_idx, kind):
    """(mask, slot) of the lanes whose medium is of ``kind``; other lanes
    read slot 0 (the reference's gathers clamp, torch indexing raises)."""
    k = scene.config.medium_kinds.index(kind)
    m = scene.medium_kind[medium_idx] == k
    return m, torch.where(m, scene.medium_slot[medium_idx], 0)


def _w2l(params, slot):
    return Transform(m=params["w2l_m"][slot], inv_t=params["w2l_it"][slot])


def _homogeneous_sigma_t(scene, slot, wavelengths):
    params = scene.media["homogeneous"]
    return scene_spectrum_eval(scene, params["sigma_t"][slot], wavelengths) \
        * params["scale"][slot][..., None]


def ray_intersect_aabb(bb_min, bb_max, o, d_rcp, mint, maxt):
    """Slab test (bbox.h ray_intersect) -> (hit, near_t, far_t)."""
    t1 = (bb_min - o) * d_rcp
    t2 = (bb_max - o) * d_rcp
    near = torch.amax(torch.minimum(t1, t2), dim=-1)
    far = torch.amin(torch.maximum(t1, t2), dim=-1)
    return (near <= far) & (far >= mint) & (near <= maxt), near, far


def medium_intersect_bounds(scene, medium_idx, ray, active):
    """(seg_valid, mint, maxt) clipped to the ray bounds (medium.cpp:48-55):
    heterogeneous media are bounded by their grid's unit cube."""
    cfg = scene.config
    if not cfg.medium_kinds:
        return torch.zeros_like(active), ray.mint, ray.maxt
    mint, maxt = ray.mint, ray.maxt
    ok = torch.ones_like(active)
    if "heterogeneous" in cfg.medium_kinds:
        m, slot = _kind_slot(scene, medium_idx, "heterogeneous")
        w2l = _w2l(scene.media["heterogeneous"], slot)
        o_l = w2l.transform_affine_point(ray.o)
        d_l = w2l.transform_vector(ray.d)
        d_rcp = 1.0 / torch.where(torch.abs(d_l) < 1e-12,
                                  torch.where(d_l < 0, -1e-12, 1e-12), d_l)
        hit, near, far = ray_intersect_aabb(0.0, 1.0, o_l, d_rcp, ray.mint,
                                            ray.maxt)
        mint = torch.where(m, torch.maximum(ray.mint, near), mint)
        maxt = torch.where(m, torch.minimum(ray.maxt, far), maxt)
        ok = torch.where(m, hit, ok)
    return ok & active, mint, maxt


def medium_combined_extinction(scene, medium_idx, p, wavelengths):
    """Global majorant (per channel) of each lane's medium; ``p`` is
    unused, as in the reference (the majorant holds everywhere)."""
    nc = scene.config.variant.channels(wavelengths)
    out = torch.ones(medium_idx.shape + (nc,),
                     dtype=scene.config.variant.dtype,
                     device=medium_idx.device)
    for kind in scene.config.medium_kinds:
        m, slot = _kind_slot(scene, medium_idx, kind)
        if kind == "homogeneous":
            v = _homogeneous_sigma_t(scene, slot, wavelengths)
        else:
            v = scene.media[kind]["majorant"][slot][..., None].expand(
                medium_idx.shape + (nc,))
        out = torch.where(m[..., None], v, out)
    return torch.clamp(out, min=1e-8)


def _axis_range_max(prof3, p0, p1):
    """min over axes of the per-axis range-max of a (N, 3, P) profile set
    over the local-coordinate box [p0, p1] (both (N, 3) in [0, 1])."""
    lo = torch.minimum(p0, p1)
    hi = torch.maximum(p0, p1)
    P = prof3.shape[-1]
    ia = torch.clamp((lo * P).to(torch.int32), 0, P - 1)
    ib = torch.clamp((hi * P).to(torch.int32), 0, P - 1)
    ar = torch.arange(P, device=prof3.device)
    mask = (ar >= ia[..., None]) & (ar <= ib[..., None])
    per_axis = torch.amax(torch.where(mask, prof3, 0.0), dim=-1)
    return torch.amin(per_axis, dim=-1)


def medium_majorant_segment(scene, medium_idx, ray, mint, maxt,
                            wavelengths):
    """Per-lane majorant valid on the ray segment [mint, maxt]:
    heterogeneous media take the min over axes of their profiles' range-max
    over the segment, times the 'majorant' magnitude."""
    out = medium_combined_extinction(scene, medium_idx, ray.o, wavelengths)
    if "heterogeneous" not in scene.config.medium_kinds:
        return out
    m, slot = _kind_slot(scene, medium_idx, "heterogeneous")
    params = scene.media["heterogeneous"]
    w2l = _w2l(params, slot)
    t1 = torch.clamp(maxt, max=INVALID_T)
    p0 = torch.clamp(w2l.transform_affine_point(ray.at(mint)), 0.0, 1.0)
    p1 = torch.clamp(w2l.transform_affine_point(ray.at(t1)), 0.0, 1.0)
    seg = _axis_range_max(params["axprof"][slot], p0, p1) \
        * params["majorant"][slot]
    seg = torch.clamp(seg, min=1e-8).detach()
    return torch.where(m[..., None], seg[..., None], out)


def _flight_profile_setup(prof3, mag, w2l, ray, a, b):
    """Per-lane piecewise-constant rate profile along the ray segment
    [a, b]: the z-row of ``prof3`` (N, 3, P) at the local z, capped by the
    min over the x/y rows' range-max across the segment, times ``mag``.
    The travel coordinate q runs along the ray (q = z going up, 1 - z going
    down); the profile is flipped to match. Returns (mq (N, P), qa, qb,
    adlz, m_at_a, is_const); horizontal rays (is_const) use the constant
    rate m_at_a, the range-max of mq over [qa, qb]. mq and m_at_a are
    detached sampling parameters."""
    P = prof3.shape[-1]
    t1 = torch.clamp(b, max=INVALID_T)
    p0 = torch.clamp(w2l.transform_affine_point(ray.at(a)), 0.0, 1.0)
    p1 = torch.clamp(w2l.transform_affine_point(ray.at(t1)), 0.0, 1.0)
    lo = torch.minimum(p0[..., :2], p1[..., :2])
    hi = torch.maximum(p0[..., :2], p1[..., :2])
    ia = torch.clamp((lo * P).to(torch.int32), 0, P - 1)
    ib = torch.clamp((hi * P).to(torch.int32), 0, P - 1)
    ar = torch.arange(P, device=prof3.device)
    mask = (ar >= ia[..., None]) & (ar <= ib[..., None])   # (N, 2, P)
    mxy = torch.amin(torch.amax(torch.where(mask, prof3[..., :2, :], 0.0),
                                dim=-1), dim=-1)
    m_eff = torch.minimum(prof3[..., 2, :], mxy[..., None]) * mag[..., None]

    dlz = w2l.transform_vector(ray.d)[..., 2]
    adlz = torch.abs(dlz)
    up = dlz >= 0
    zl = p0[..., 2]
    zh = p1[..., 2]
    qa = torch.where(up, zl, 1.0 - zl)
    qb = torch.maximum(qa, torch.where(up, zh, 1.0 - zh))
    mq = torch.where(up[..., None], m_eff, torch.flip(m_eff, dims=(-1,)))
    k0 = torch.clamp((qa * P).to(torch.int32), 0, P - 1)
    k1 = torch.clamp((qb * P).to(torch.int32), 0, P - 1)
    span = (ar >= k0[..., None]) & (ar <= k1[..., None])
    m_at_a = torch.amax(torch.where(span, mq, 0.0), dim=-1)
    is_const = adlz < 1e-7
    return (mq.detach(), qa, qb, torch.clamp(adlz, min=1e-20),
            m_at_a.detach(), is_const)


def _bin_edges(P, like):
    """The P bins' indices and their lower and upper edges in [0, 1], in
    ``like``'s dtype (the reference divides in its default float dtype)."""
    ar = torch.arange(P, device=like.device)
    arf = ar.to(like.dtype)
    return ar, arf / P, (arf + 1.0) / P


def _flight_sample(mq, qa, qb, adlz, a, xi):
    """First-collision sample from the profile rate:
    Lambda(t) = int_a^t mq(q(s)) ds with q(s) = qa + adlz (s - a). Returns
    (t, m_local, lam_total); an escape (t > b) gives t = INVALID_T."""
    P = mq.shape[-1]
    ar, e_lo, e_hi = _bin_edges(P, mq)
    ov = torch.clamp(torch.minimum(qb[..., None], e_hi)
                     - torch.maximum(qa[..., None], e_lo), min=0.0)
    lam_bins = mq * ov
    cum = torch.cumsum(lam_bins, dim=-1)
    lam_total_z = cum[..., -1]
    target_z = -torch.log1p(-xi) * adlz
    escaped = target_z >= lam_total_z
    k = torch.sum((cum < target_z[..., None]).to(torch.int32), dim=-1)
    # xi == 0 selects k = 0 even when qa lies in a later bin: clamp to
    # qa's bin so the local rate is the one at the segment start
    k_qa = (qa * P).to(torch.int32)
    kc = torch.clamp(torch.maximum(k, k_qa), 0, P - 1)
    pick = lambda v: torch.gather(v, -1, kc[..., None].long())[..., 0]
    cum_k = pick(cum)
    lam_k = pick(lam_bins)
    m_k = pick(mq)
    cum_prev = cum_k - lam_k
    q_k0 = torch.maximum(qa, kc.to(mq.dtype) / P)
    dq = (target_z - cum_prev) / torch.clamp(m_k, min=1e-20)
    t = a + (q_k0 + dq - qa) / adlz
    t = torch.where(escaped, INVALID_T, t)
    return t, m_k, lam_total_z / adlz


def _flight_tau(mq, qa, qb, adlz, a, t):
    """Lambda(t): optical depth of the profile rate from a to t (flat
    beyond the segment end qb)."""
    P = mq.shape[-1]
    _ar, e_lo, e_hi = _bin_edges(P, mq)
    q_t = torch.minimum(qa + adlz * torch.clamp(t - a, 0.0, INVALID_T), qb)
    ov = torch.clamp(torch.minimum(q_t[..., None], e_hi)
                     - torch.maximum(qa[..., None], e_lo), min=0.0)
    return torch.sum(mq * ov, dim=-1) / adlz


def medium_scattering_coefficients(scene, medium_idx, p, wavelengths,
                                   majorant=None):
    """(sigma_s, sigma_n, sigma_t) at world point p; ``majorant`` overrides
    the global combined extinction."""
    dev = p.device
    nc = scene.config.variant.channels(wavelengths)
    sigma_s = torch.zeros(medium_idx.shape + (nc,), dtype=p.dtype,
                          device=dev)
    sigma_t = torch.zeros_like(sigma_s)
    if majorant is None:
        majorant = medium_combined_extinction(scene, medium_idx, p,
                                              wavelengths)
    for kind in scene.config.medium_kinds:
        m, slot = _kind_slot(scene, medium_idx, kind)
        params = scene.media[kind]
        if kind == "homogeneous":
            st = _homogeneous_sigma_t(scene, slot, wavelengths)
            al = scene_spectrum_eval(scene, params["albedo"][slot],
                                     wavelengths)
        else:
            st = volume_eval(scene, params["sigma_t_vol"][slot], p,
                             wavelengths) * params["scale"][slot][..., None]
            al = volume_eval(scene, params["albedo_vol"][slot], p,
                             wavelengths)
        sigma_t = torch.where(m[..., None], st, sigma_t)
        sigma_s = torch.where(m[..., None], st * al, sigma_s)
    sigma_n = torch.clamp(majorant - sigma_t, min=0.0)
    return sigma_s, sigma_n, sigma_t


def _profile_lerp_setup(prof, Dn, z):
    """(i0, f, p0, p1) of the piecewise-linear vertical profile at local z
    (cell-center knots: g = clip(z) * (D - 1))."""
    g = torch.clamp(z, 0.0, 1.0) * torch.clamp(Dn - 1, min=0)
    i0 = torch.clamp(g.to(torch.int32), min=0)
    i0 = torch.minimum(i0, torch.clamp(Dn - 2, min=0))
    f = g - i0
    p0 = torch.gather(prof, -1, i0[..., None].long())[..., 0]
    p1 = torch.gather(prof, -1, torch.minimum(i0 + 1, Dn - 1)[..., None]
                      .long())[..., 0]
    return i0, f, p0, p1


def _tau_1d_profile(prof, cum, Dn, o_z, dlz, a, b):
    """Exact optical depth of a piecewise-linear vertical profile over the
    ray segment [a, b] (unscaled): (T(z(b)) - T(z(a))) / dlz with the
    cumulative table T; horizontal rays take sigma(z0) * (b - a)."""
    z0 = o_z + dlz * a
    z1 = o_z + dlz * b

    def T(z):
        i0, f, p0, p1 = _profile_lerp_setup(prof, Dn, z)
        c0 = torch.gather(cum, -1, i0[..., None].long())[..., 0]
        dz = 1.0 / torch.clamp(Dn - 1, min=1).to(prof.dtype)
        t_multi = c0 + dz * (p0 * f + 0.5 * (p1 - p0) * f * f)
        # D == 1: constant profile, T(z) = p0 * z
        return torch.where(Dn > 1, t_multi, p0 * torch.clamp(z, 0.0, 1.0))

    straight = torch.abs(dlz) > 1e-8
    dlz_s = torch.where(straight, dlz, 1.0)
    _i, f0, p0, p1 = _profile_lerp_setup(prof, Dn, z0)
    sig0 = p0 * (1.0 - f0) + p1 * f0
    tau = torch.where(straight, (T(z1) - T(z0)) / dlz_s,
                      sig0 * torch.clamp(b - a, min=0.0))
    return torch.clamp(tau, min=0.0)


def _het_profile_tau(scene, slot, ray, a, b, prof, cum, D):
    """scale * the closed-form tau of one of a heterogeneous medium's
    vertical profiles (prof/cum/D name its table) over [a, b]."""
    params = scene.media["heterogeneous"]
    w2l = _w2l(params, slot)
    o_z = w2l.transform_affine_point(ray.o)[..., 2]
    dlz = w2l.transform_vector(ray.d)[..., 2]
    return _tau_1d_profile(params[prof][slot], params[cum][slot],
                           params[D][slot], o_z, dlz, a, b) \
        * params["scale"][slot]


def medium_ctrl_tau_segment(scene, medium_idx, ray, a, b, wavelengths):
    """CONTROL optical depth over [a, b] -> (N, nc): the exact integral of
    the control field sigma_c (homogeneous: sigma_t; heterogeneous: the
    horizontal-mean vertical profile)."""
    nc = scene.config.variant.channels(wavelengths)
    tau = a.new_zeros(a.shape + (nc,))
    seg = torch.clamp(b - a, min=0.0)
    for kind in scene.config.medium_kinds:
        m, slot = _kind_slot(scene, medium_idx, kind)
        if kind == "homogeneous":
            v = _homogeneous_sigma_t(scene, slot, wavelengths) \
                * seg[..., None]
        else:
            v = _het_profile_tau(scene, slot, ray, a, b, "cprof", "ccum",
                                 "cD")[..., None].expand(a.shape + (nc,))
        tau = torch.where(m[..., None], v, tau)
    return torch.clamp(tau, 0.0, 60.0)


def ff_majorant_mode(scene):
    """The free-flight majorant of the scene's integrator: 'profile' (the
    local z-profile, the default) or 'segment' (one rate a segment)."""
    return dict(scene.config.integrator.extra).get("ff_majorant", "profile")


def medium_residual_rate(scene, medium_idx, ray, a, b):
    """The residual collision rate of the segment [a, b] -> (N,): a bound
    on |sigma_t - sigma_c| over it (the min over axes of the residual
    profiles' range-max, times the medium's scale), detached; zero for
    homogeneous media (their control is exact)."""
    out = torch.zeros_like(a)
    if "heterogeneous" not in scene.config.medium_kinds:
        return out
    m, slot = _kind_slot(scene, medium_idx, "heterogeneous")
    params = scene.media["heterogeneous"]
    w2l = _w2l(params, slot)
    t1 = torch.clamp(b, max=INVALID_T)
    p0 = torch.clamp(w2l.transform_affine_point(ray.at(a)), 0.0, 1.0)
    p1 = torch.clamp(w2l.transform_affine_point(ray.at(t1)), 0.0, 1.0)
    rate = _axis_range_max(params["resprof"][slot], p0, p1) \
        * params["scale"][slot]
    return torch.where(m, torch.clamp(rate, min=0.0).detach(), out)


def medium_residual_sample(scene, medium_idx, ray, a, b, xi):
    """First residual collision on [a, b], sampled from the LOCAL z-profile
    residual rate, or under ``ff_majorant="segment"`` from the segment's
    one rate (medium_residual_rate). Returns (hit, dt, R_local) with
    R_local the rate at the sampled point. Homogeneous media never collide
    (zero residual)."""
    hit = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    dt = torch.zeros_like(a)
    if "heterogeneous" not in scene.config.medium_kinds:
        return hit, dt, dt
    if ff_majorant_mode(scene) == "segment":
        rate = medium_residual_rate(scene, medium_idx, ray, a, b)
        dts = a - torch.log1p(-xi) / torch.clamp(rate, min=1e-20)
        h = (dts < b) & (rate > 0)
        return h, torch.where(h, dts, 0.0), torch.where(h, rate, 0.0)
    m, slot = _kind_slot(scene, medium_idx, "heterogeneous")
    params = scene.media["heterogeneous"]
    mq, qa, qb, adlz, r_at_a, is_const = _flight_profile_setup(
        params["resprof"][slot], params["scale"][slot], _w2l(params, slot),
        ray, a, b)
    t_prof, r_k, _lam = _flight_sample(mq, qa, qb, adlz, a, xi)
    t_const = a - torch.log1p(-xi) / torch.clamp(r_at_a, min=1e-20)
    t_s = torch.where(is_const, t_const, t_prof)
    r_s = torch.where(is_const, r_at_a, r_k)
    h = m & (t_s < b) & (r_s > 0)
    return h, torch.where(h, t_s, 0.0), torch.where(h, r_s, 0.0)


def medium_ctrl_sigma(scene, medium_idx, p, wavelengths):
    """Control field sigma_c at world point p -> (N, nc), scale included."""
    nc = scene.config.variant.channels(wavelengths)
    out = p.new_zeros(medium_idx.shape + (nc,))
    for kind in scene.config.medium_kinds:
        m, slot = _kind_slot(scene, medium_idx, kind)
        params = scene.media[kind]
        if kind == "homogeneous":
            v = _homogeneous_sigma_t(scene, slot, wavelengths)
        else:
            z = _w2l(params, slot).transform_affine_point(p)[..., 2]
            _i, f, p0, p1 = _profile_lerp_setup(params["cprof"][slot],
                                                params["cD"][slot], z)
            sig = p0 * (1.0 - f) + p1 * f
            v = (sig * params["scale"][slot])[..., None].expand(
                medium_idx.shape + (nc,))
        out = torch.where(m[..., None], v, out)
    return out


def medium_sigma_t(scene, medium_idx, p, wavelengths):
    """sigma_t alone at world point p -> (N, nc) (the residual-collision
    integrand; no albedo lookup)."""
    nc = scene.config.variant.channels(wavelengths)
    out = p.new_zeros(medium_idx.shape + (nc,))
    for kind in scene.config.medium_kinds:
        m, slot = _kind_slot(scene, medium_idx, kind)
        params = scene.media[kind]
        if kind == "homogeneous":
            v = _homogeneous_sigma_t(scene, slot, wavelengths)
        else:
            v = volume_eval(scene, params["sigma_t_vol"][slot], p,
                            wavelengths) * params["scale"][slot][..., None]
        out = torch.where(m[..., None], v, out)
    return out


def _gauss_legendre_tau(scene, medium_idx, ray, a, b, wavelengths,
                        quad_points):
    """Gauss-Legendre quadrature of sigma_t over [a, b] with
    ``quad_points`` nodes -> (N, nc): the (N, K) node positions go through
    one sigma_t lookup, flattened (one gridvolume lookup for all K)."""
    nodes, weights = np.polynomial.legendre.leggauss(quad_points)
    nodes = torch.as_tensor(nodes, dtype=torch.float32, device=a.device)
    w = torch.as_tensor(weights, dtype=torch.float32, device=a.device)
    ts = (a[..., None] * 0.5 * (1.0 - nodes)
          + b[..., None] * 0.5 * (1.0 + nodes))               # (N, K)
    p_k = ray.o[..., None, :] + ray.d[..., None, :] * ts[..., None]
    n, K = ts.shape
    nw = wavelengths.shape[-1]
    sigma_t = medium_sigma_t(
        scene, medium_idx[:, None].expand(n, K).reshape(-1),
        p_k.reshape(-1, 3),
        wavelengths[:, None, :].expand(n, K, nw).reshape(n * K, nw))
    sigma_t = sigma_t.reshape(n, K, sigma_t.shape[-1])
    return 0.5 * torch.clamp(b - a, min=0.0)[..., None] * torch.sum(
        w[..., None] * sigma_t, dim=-2)


def medium_tau_segment(scene, medium_idx, ray, a, b, wavelengths,
                       quad_points=8):
    """Optical depth of sigma_t over [a, b] -> (N, nc): homogeneous media
    sigma_t * (b - a); plane-parallel heterogeneous media
    (config.het_profile1d) the exact closed form of their vertical
    profile; general 3D grids Gauss-Legendre quadrature with
    ``quad_points`` nodes (consistent, not unbiased)."""
    nc = scene.config.variant.channels(wavelengths)
    tau = a.new_zeros(a.shape + (nc,))
    seg = torch.clamp(b - a, min=0.0)
    for kind in scene.config.medium_kinds:
        m, slot = _kind_slot(scene, medium_idx, kind)
        if kind == "homogeneous":
            v = _homogeneous_sigma_t(scene, slot, wavelengths) \
                * seg[..., None]
        elif scene.config.het_profile1d:
            v = _het_profile_tau(scene, slot, ray, a, b, "zprof", "zcum",
                                 "zD")[..., None].expand(a.shape + (nc,))
        else:
            v = _gauss_legendre_tau(scene, medium_idx, ray, a, b,
                                    wavelengths, quad_points)
        tau = torch.where(m[..., None], v, tau)
    return torch.clamp(tau, 0.0, 60.0)


@scoped_phase("ert::free_flight")
def sample_interaction(scene, medium_idx, ray, sample, channel, active,
                       mode=None):
    """Medium::sample_interaction (medium.cpp:36-77). medium_idx: (N,) i32,
    clamped >= 0 by the caller; ``active`` excludes vacuum lanes. Under
    ``mode`` "profile" heterogeneous lanes fly against their local
    z-profile majorant; under any other (the reference's "segment") every
    lane flies against its segment's one majorant
    (medium_majorant_segment). The default (None) reads the integrator's
    ``ff_majorant`` (ff_majorant_mode: "profile" unless set)."""
    cfg = scene.config
    nc = cfg.variant.channels(ray.wavelengths)
    profile = (ff_majorant_mode(scene) if mode is None else mode) \
        == "profile"
    seg_ok, mint, maxt = medium_intersect_bounds(scene, medium_idx, ray,
                                                 active)
    mint = torch.where(seg_ok, torch.clamp(mint, min=0.0), 0.0)
    maxt = torch.where(seg_ok, torch.clamp(maxt, max=INVALID_T), INVALID_T)

    n = mint.shape[0]
    dev = mint.device
    if profile and tuple(cfg.medium_kinds) == ("heterogeneous",):
        # every lane takes the profile path below: no segment majorant
        combined = mint.new_ones(n, nc)
        m = mint.new_ones(n)
    else:
        combined = medium_majorant_segment(scene, medium_idx, ray, mint,
                                           maxt, ray.wavelengths)
        m = torch.gather(combined, -1,
                         torch.clamp(channel, 0, nc - 1)[:, None].long())[:, 0]

    sampled_t = mint - torch.log1p(-sample) / m
    inv = invalid_mi(n, nc, dev, mint.dtype)
    ff_mq, ff_qa, ff_qb, ff_adlz, ff_on = (inv.ff_mq, inv.ff_qa, inv.ff_qb,
                                           inv.ff_adlz, inv.ff_on)
    if profile and "heterogeneous" in cfg.medium_kinds:
        het, slot = _kind_slot(scene, medium_idx, "heterogeneous")
        het = het & seg_ok
        params = scene.media["heterogeneous"]
        mq, qa, qb, adlz, m_at_a, is_const = _flight_profile_setup(
            params["axprof"][slot], params["majorant"][slot],
            _w2l(params, slot), ray, mint, maxt)
        t_prof, m_local, _lam = _flight_sample(mq, qa, qb, adlz, mint, sample)
        t_prof = torch.minimum(t_prof, torch.where(
            t_prof < 0.5 * INVALID_T, maxt, INVALID_T))
        t_const = mint - torch.log1p(-sample) / torch.clamp(m_at_a, min=1e-20)
        use_prof = het & ~is_const
        use_const = het & is_const
        sampled_t = torch.where(use_prof, t_prof,
                                torch.where(use_const, t_const, sampled_t))
        m_loc = torch.where(use_prof, m_local,
                            torch.where(use_const, m_at_a, m))
        m_loc = torch.clamp(m_loc, min=1e-8)
        combined = torch.where(het[..., None], m_loc[..., None], combined)
        ff_mq = torch.where(use_prof[..., None], mq, ff_mq)
        ff_qa = torch.where(use_prof, qa, ff_qa)
        ff_qb = torch.where(use_prof, qb, ff_qb)
        ff_adlz = torch.where(use_prof, adlz, ff_adlz)
        ff_on = use_prof

    valid_mi = seg_ok & (sampled_t <= maxt)
    t = torch.where(valid_mi, sampled_t, INVALID_T)
    p = ray.at(torch.where(valid_mi, sampled_t, 0.0))
    sigma_s, sigma_n, sigma_t = medium_scattering_coefficients(
        scene, medium_idx, p, ray.wavelengths, majorant=combined)
    return MediumInteraction(
        t=t, p=p, mint=mint, sigma_s=sigma_s, sigma_n=sigma_n,
        sigma_t=sigma_t, combined_extinction=combined, maxt=maxt,
        ff_mq=ff_mq, ff_qa=ff_qa, ff_qb=ff_qb, ff_adlz=ff_adlz, ff_on=ff_on)


def eval_tr_and_pdf(mi: MediumInteraction, si_t):
    """Medium::eval_tr_and_pdf (medium.cpp:80-91). Profile-flight lanes
    rebuild the exact optical depth of their majorant profile; the optical
    depth is clamped to 60 so tr and the pdf never underflow."""
    t_end = torch.minimum(mi.t, si_t)
    t = torch.clamp(t_end - mi.mint, 0.0, INVALID_T)
    x_const = t[..., None] * mi.combined_extinction
    lam = _flight_tau(mi.ff_mq, mi.ff_qa, mi.ff_qb, mi.ff_adlz, mi.mint,
                      t_end)
    x = torch.where(mi.ff_on[..., None], lam[..., None], x_const)
    tr = torch.exp(-torch.clamp(x, 0.0, 60.0))
    pdf = torch.where((si_t < mi.t)[..., None], tr,
                      tr * mi.combined_extinction)
    return tr, pdf


def medium_is_homogeneous(scene, medium_idx):
    """Whether each lane's medium (N,) is homogeneous."""
    out = torch.zeros(medium_idx.shape, dtype=torch.bool,
                      device=medium_idx.device)
    for k, kind in enumerate(scene.config.medium_kinds):
        if kind == "homogeneous":
            out = out | (scene.medium_kind[medium_idx] == k)
    return out
