"""Emitters and scene-level emitter sampling (emitters/__init__.py
counterpart; Scene::sample_emitter_direction, scene.cpp:169-215): area
emitters on shapes, the constant and envmap environments, point, spot,
projector and directional lights. Each kind's ``*_sample_direction``
returns (DirectionSample, value) with the value already divided by the
kind's pdf where it has one (the area kind's division happens in
sample_emitter_direction, as in the reference). Values are evaluated at
the lanes' ``wavelengths`` (N, nw) in spectral (nc = nw); mono and rgb
lanes carry (N, 0). ``sample_emitter_ray``
draws rays leaving the emitters (Endpoint::sample_ray; no integrator of
either package traces them)."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import warp
from ..core.frame import Frame
from ..core.hierarchical2d import h2d_pdf, h2d_sample
from ..core.math import channel_mean, dot, normalize
from ..core.ray import Ray
from ..core.spectrum import N_HERO
from ..core.transform import Transform
from ..render import shape_sampling
from ..render.geometry import ray_test
from ..render.records import DirectionSample, merge
from ..render.texture import (srgb_model_eval, texture_eval,
                              texture_sample_spectrum)


def _zeros_like_batch(x, *shape, dtype=None):
    """Zeros (len(x), *shape) of ``dtype``, by default x's."""
    return torch.zeros(x.shape[0], *shape, dtype=dtype or x.dtype,
                       device=x.device)


def area_eval(scene, params, slot, si, active):
    """Radiance of an area emitter seen along si.wi (front side only)."""
    front = si.wi[:, 2] > 0.0
    v = texture_eval(scene, params["radiance"][slot], si.uv,
                     wavelengths=si.wavelengths)
    return torch.where((active & front)[:, None], v, 0.0)


def area_sample_direction(scene, params, slot, ref_p, wl, s1, s2, active):
    """A point on the emitter's shape, seen from ``ref_p``: solid-angle
    pdf dist^2 / (area cos), zero from behind."""
    ps = shape_sampling.sample_position(scene, params["shape"][slot], s1, s2)
    delta = ps.p - ref_p
    dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-20)
    dist = torch.sqrt(dist2)
    d = delta / dist[:, None]
    cos_em = dot(ps.n, -d)
    front = cos_em > 1e-7
    pdf_sa = ps.pdf * dist2 / torch.clamp(torch.abs(cos_em), min=1e-20)
    value = texture_eval(scene, params["radiance"][slot], ps.uv,
                         wavelengths=wl)
    value = torch.where((active & front)[:, None], value, 0.0)
    ds = DirectionSample(
        p=ps.p, n=ps.n, uv=ps.uv, d=d, dist=dist,
        pdf=torch.where(front, pdf_sa, 0.0),
        delta=torch.zeros_like(front),
        emitter_index=_zeros_like_batch(dist, dtype=torch.int32))
    return ds, value


def area_pdf_direction(scene, params, slot, ref_p, ds_p, ds_n, active):
    """Solid-angle pdf of area_sample_direction choosing ``ds_p``."""
    delta = ds_p - ref_p
    dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-20)
    d = delta / torch.sqrt(dist2)[:, None]
    cos_em = torch.abs(dot(ds_n, -d))
    pdf = (shape_sampling.pdf_position(scene, params["shape"][slot]) * dist2
           / torch.clamp(cos_em, min=1e-20))
    return torch.where(active & (cos_em > 1e-7), pdf, 0.0)


def constant_eval(scene, params, slot, wl, active):
    return torch.where(active[:, None], texture_eval(
        scene, params["radiance"][slot], wavelengths=wl), 0.0)


def constant_sample_direction(scene, params, slot, ref_p, wl, s1, s2,
                              active):
    """A uniform direction on the sphere, from a point two bounding radii
    away; value / pdf."""
    d = warp.square_to_uniform_sphere(s2)
    pdf = warp.square_to_uniform_sphere_pdf(d)
    r = 2.0 * scene.bsphere_radius
    value = texture_eval(scene, params["radiance"][slot], s2, wavelengths=wl)
    ds = DirectionSample(
        p=ref_p + d * r, n=-d, uv=s2, d=d, dist=r.expand(pdf.shape[0]),
        pdf=pdf, delta=torch.zeros_like(active),
        emitter_index=_zeros_like_batch(pdf, dtype=torch.int32))
    return ds, value / pdf[:, None]


def point_sample_direction(scene, params, slot, ref_p, wl, s1, s2, active):
    """point.cpp: the delta position, intensity over dist^2."""
    p = params["position"][slot]
    delta = p - ref_p
    dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-20)
    dist = torch.sqrt(dist2)
    d = delta / dist[:, None]
    value = texture_eval(scene, params["intensity"][slot],
                         wavelengths=wl) / dist2[:, None]
    ds = DirectionSample(
        p=p, n=-d, uv=_zeros_like_batch(dist, 2), d=d, dist=dist,
        pdf=torch.ones_like(dist), delta=torch.ones_like(active),
        emitter_index=_zeros_like_batch(dist, dtype=torch.int32))
    return ds, value


def directional_sample_direction(scene, params, slot, ref_p, wl, s1, s2,
                                 active):
    """directional.cpp:64-132: delta direction against the travel
    direction, from a point two bounding radii away."""
    d_emit = normalize(params["direction"][slot])
    d = -d_emit
    r = 2.0 * scene.bsphere_radius
    value = texture_eval(scene, params["irradiance"][slot], wavelengths=wl)
    ds = DirectionSample(
        p=ref_p + d * r, n=d_emit, uv=_zeros_like_batch(d, 2), d=d,
        dist=r.expand(d.shape[0]), pdf=torch.ones_like(d[:, 0]),
        delta=torch.ones_like(active),
        emitter_index=_zeros_like_batch(d, dtype=torch.int32))
    return ds, value


def _toward(params, slot, ref_p):
    """(p, d, dist, dist2) from ``ref_p`` to the delta position."""
    p = params["position"][slot]
    delta = p - ref_p
    dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-20)
    dist = torch.sqrt(dist2)
    return p, delta / dist[:, None], dist, dist2


def _delta_sample(p, d, dist, uv):
    return DirectionSample(
        p=p, n=-d, uv=uv, d=d, dist=dist, pdf=torch.ones_like(dist),
        delta=torch.ones_like(dist, dtype=torch.bool),
        emitter_index=_zeros_like_batch(dist, dtype=torch.int32))


def spot_sample_direction(scene, params, slot, ref_p, wl, s1, s2, active):
    """spot.cpp: a cone light with a linear falloff between the beam and
    cutoff angles; a delta position."""
    p, d, dist, dist2 = _toward(params, slot, ref_p)
    cos_a = dot(normalize(params["direction"][slot]), -d)
    ccut = params["cos_cutoff"][slot]
    cbeam = params["cos_beam"][slot]
    falloff = torch.clamp((cos_a - ccut) / torch.clamp(cbeam - ccut,
                                                       min=1e-6), 0.0, 1.0)
    value = (texture_eval(scene, params["intensity"][slot], wavelengths=wl)
             * (falloff / dist2)[:, None])
    return _delta_sample(p, d, dist, _zeros_like_batch(dist, 2)), value


def _w2l(params, slot):
    return Transform(m=params["w2l_m"][slot], inv_t=params["w2l_it"][slot])


def projector_sample_direction(scene, params, slot, ref_p, wl, s1, s2,
                               active):
    """projector.cpp: an image projected from a delta position; its uv is
    the direction through the projector's frustum (the perspective
    sensor's mapping, x mirrored)."""
    p, d, dist, dist2 = _toward(params, slot, ref_p)
    d_loc = _w2l(params, slot).transform_vector(-d)
    tan_x = params["tan_half_fov"][slot]
    aspect = params["aspect"][slot]
    z = torch.clamp(d_loc[:, 2], min=1e-6)
    u = 0.5 * (1.0 - d_loc[:, 0] / (z * tan_x))
    v = 0.5 * (1.0 - d_loc[:, 1] / (z * tan_x * aspect))
    inside = (d_loc[:, 2] > 0) & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    uv = torch.stack([u, v], dim=-1)
    value = texture_eval(scene, params["irradiance"][slot], uv,
                         wavelengths=wl)
    value = torch.where((active & inside)[:, None], value / dist2[:, None],
                        0.0)
    return _delta_sample(p, d, dist, uv), value


# --- envmap (envmap.cpp): a lat-long image with hierarchical sampling -------
# The reference's y-up lat-long mapping: u = atan2(x, -z) / 2pi and
# v = acos(y) / pi in the emitter's frame. Texels are bilinear vertex
# samples (row y at theta = y / (H-1) pi, rows 0 and H-1 the poles) and the
# stored image repeats its first column after the last to close the seam.

def _envmap_dir_to_uv(params, slot, d):
    dl = normalize(_w2l(params, slot).transform_vector(d))
    theta = torch.acos(torch.clamp(dl[:, 1], -1.0, 1.0))
    phi = torch.atan2(dl[:, 0], -dl[:, 2])
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
    return torch.stack([phi / (2 * math.pi), theta / math.pi], -1), theta


def _envmap_uv_to_dir(params, slot, uv):
    phi = uv[:, 0] * 2 * math.pi
    theta = uv[:, 1] * math.pi
    st = torch.sin(theta)
    dl = torch.stack([st * torch.sin(phi), torch.cos(theta),
                      -st * torch.cos(phi)], -1)
    return (normalize(_w2l(params, slot).inverse().transform_vector(dl)),
            theta)


def _envmap_bilinear(scene, params, slot, uv, wl):
    """The image's vertex-aligned bilinear value at uv, times its scale;
    the channel mean in mono; in spectral the texels' rgb2spec
    coefficients and scales lerped and evaluated at the wavelengths ``wl``
    (envmap.cpp:69-89)."""
    img = params["image"]  # (S, H, W+1, 3)
    H, W = img.shape[1], img.shape[2]
    u = torch.clamp(uv[:, 0], 0.0, 1.0) * (W - 1)
    v = torch.clamp(uv[:, 1], 0.0, 1.0) * (H - 1)
    x0 = torch.clamp(torch.floor(u).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 2)
    x1 = x0 + 1
    y1 = y0 + 1
    fx = torch.clamp(u - x0, 0.0, 1.0)[:, None]
    fy = torch.clamp(v - y0, 0.0, 1.0)[:, None]
    if scene.config.variant.is_spectral:
        cf, sc = params["spec_coeff"], params["spec_scale"]
        coeff = (cf[slot, y0, x0] * (1 - fx) * (1 - fy)
                 + cf[slot, y0, x1] * fx * (1 - fy)
                 + cf[slot, y1, x0] * (1 - fx) * fy
                 + cf[slot, y1, x1] * fx * fy)
        fx1, fy1 = fx[:, 0], fy[:, 0]
        s = (sc[slot, y0, x0] * (1 - fx1) * (1 - fy1)
             + sc[slot, y0, x1] * fx1 * (1 - fy1)
             + sc[slot, y1, x0] * (1 - fx1) * fy1
             + sc[slot, y1, x1] * fx1 * fy1)
        return (srgb_model_eval(coeff, wl)
                * (s * params["scale"][slot])[:, None])
    c = (img[slot, y0, x0] * (1 - fx) * (1 - fy)
         + img[slot, y0, x1] * fx * (1 - fy)
         + img[slot, y1, x0] * (1 - fx) * fy + img[slot, y1, x1] * fx * fy)
    rgb = c * params["scale"][slot][:, None]
    if scene.config.variant.n_channels == 3:
        return rgb
    return channel_mean(rgb, keepdim=True)


def envmap_eval(scene, params, slot, d, wl, active):
    uv, _theta = _envmap_dir_to_uv(params, slot, d)
    return torch.where(active[:, None],
                       _envmap_bilinear(scene, params, slot, uv, wl), 0.0)


def envmap_pdf_direction(scene, params, slot, d, active):
    """The Hierarchical2D density over the spherical Jacobian,
    2 pi^2 sin theta."""
    uv, theta = _envmap_dir_to_uv(params, slot, d)
    p = h2d_pdf(params, slot, uv, prefix="h2d_")
    st = torch.clamp(torch.sin(theta), min=1e-6)
    return torch.where(active, p / (2.0 * math.pi * math.pi * st), 0.0)


def envmap_sample_direction(scene, params, slot, ref_p, wl, s1, s2, active):
    """uv by the Hierarchical2D warp of the sin-weighted luminance, so
    value / pdf is the colour-to-luminance ratio, bounded even for a
    one-texel sun."""
    uv, p2 = h2d_sample(params, slot, s2, prefix="h2d_")
    d, theta = _envmap_uv_to_dir(params, slot, uv)
    st = torch.clamp(torch.sin(theta), min=1e-6)
    pdf = torch.where(p2 > 0, p2 / (2.0 * math.pi * math.pi * st), 0.0)
    pdf = torch.where(active, pdf, 0.0)
    value = _envmap_bilinear(scene, params, slot, uv, wl)
    value = torch.where((active & (pdf > 0))[:, None],
                        value / torch.clamp(pdf, min=1e-20)[:, None], 0.0)
    r = 2.0 * scene.bsphere_radius
    ds = DirectionSample(
        p=ref_p + d * r, n=-d, uv=uv, d=d, dist=r.expand(pdf.shape[0]),
        pdf=pdf, delta=torch.zeros_like(active),
        emitter_index=_zeros_like_batch(pdf, dtype=torch.int32))
    return ds, value


KIND_SAMPLERS = {"area": area_sample_direction,
                 "constant": constant_sample_direction,
                 "point": point_sample_direction,
                 "directional": directional_sample_direction,
                 "spot": spot_sample_direction,
                 "projector": projector_sample_direction,
                 "envmap": envmap_sample_direction}

# user-registered emitter kinds: name -> module (register_emitter)
CUSTOM = {}


def register_emitter(name, module):
    """Register a user emitter kind ``name`` sampled by next-event
    estimation (the point, spot and directional family; emitters that a
    ray hits or escapes to, as area and envmap, are not registrable).
    ``module`` provides

      build(props, builder) -> row dict    (scene build, numpy; radiometric
                                            values through builder.texture
                                            or builder.spectrum)
      sample_direction(scene, params, slot, ref_p, wavelengths, s1, s2,
                       active) -> (DirectionSample, value)

    with the value's finite pdf already divided out (the
    point_sample_direction contract), ``ds.delta`` set on delta directions
    and ``ds.pdf`` the solid-angle density (0 for a delta)."""
    CUSTOM[name] = module
    KIND_SAMPLERS[name] = module.sample_direction


def sample_emitter_direction(scene, si, s_pick, s1, s2, active,
                             test_visibility=True):
    """Uniform emitter pick, per-kind direction sample, shadow ray.
    Returns (ds, weight) with the pick pmf folded in (weight = value /
    (ds.pdf * pmf) for non-delta kinds). Without ``test_visibility`` (the
    volumetric NEE, which walks the connection itself) no shadow ray is
    traced, and ``si`` needs only ``p`` and ``t``."""
    cfg = scene.config
    n_em = cfg.n_emitters
    dev = si.t.device
    z3 = _zeros_like_batch(si.t, 3)
    z = _zeros_like_batch(si.t)
    ds = DirectionSample(
        p=z3, n=z3, uv=_zeros_like_batch(si.t, 2), d=z3, dist=z, pdf=z,
        delta=torch.zeros_like(active),
        emitter_index=torch.full_like(si.t, -1, dtype=torch.int32))
    zc = _zeros_like_batch(si.t, scene.config.variant.channels(si.wavelengths))
    if n_em == 0:
        return ds, zc

    idx = torch.clamp((s_pick * n_em).to(torch.int32), max=n_em - 1)
    kind_id = scene.emitter_kind[idx]
    slot = scene.emitter_slot[idx]
    value = zc
    for k, kind in enumerate(cfg.emitter_kinds):
        m = active & (kind_id == k)
        # other kinds' lanes read slot 0 (the reference's gathers clamp)
        d_k, v_k = KIND_SAMPLERS[kind](scene, scene.emitters[kind],
                                       torch.where(kind_id == k, slot, 0),
                                       si.p, si.wavelengths, s1, s2, m)
        if kind == "area":  # weight = value / pdf
            v_k = torch.where(d_k.pdf[:, None] > 0,
                              v_k / torch.clamp(d_k.pdf[:, None], min=1e-20),
                              0.0)
        ds = merge(d_k, ds, m)
        value = torch.where(m[:, None], v_k, value)

    ds = dataclasses.replace(ds, pdf=ds.pdf * (1.0 / n_em),
                             emitter_index=idx)
    value = value * n_em
    if not test_visibility:
        return ds, torch.where(active[:, None], value, 0.0)
    shadow_ray, _dist = si.spawn_ray_to(ds.p)
    occluded = ray_test(scene.geo, shadow_ray, active)
    return ds, torch.where((active & ~occluded)[:, None], value, 0.0)


def pdf_emitter_direction(scene, ref_p, si_hit, escaped, active, d=None):
    """Solid-angle pdf of emitter sampling choosing the direction that hit
    ``si_hit`` (an area emitter) or escaped along ``d`` (the environment):
    the MIS weight of BSDF-sampled rays (scene.cpp pdf_emitter_direction).
    Without ``d`` an envmap's escaped lanes take the uniform sphere's pdf,
    as in the reference."""
    cfg = scene.config
    pdf = ref_p.new_zeros(ref_p.shape[0])
    if cfg.n_emitters == 0:
        return pdf
    if "area" in cfg.emitter_kinds:
        em_idx = scene.shape_emitter[torch.clamp(si_hit.shape_index, min=0)]
        has = active & si_hit.is_valid & (em_idx >= 0)
        slot = torch.where(has, scene.emitter_slot[torch.clamp(em_idx, min=0)],
                           0)
        p_area = area_pdf_direction(scene, scene.emitters["area"], slot,
                                    ref_p, si_hit.p, si_hit.n, has)
        pdf = torch.where(has, p_area, pdf)
    if cfg.env_emitter >= 0:
        m = active & escaped
        if "envmap" in cfg.emitter_kinds and d is not None:
            slot = scene.emitter_slot[cfg.env_emitter].expand(m.shape[0])
            pdf = torch.where(m, envmap_pdf_direction(
                scene, scene.emitters["envmap"], slot, d, m), pdf)
        else:
            pdf = torch.where(m, warp.INV_FOUR_PI, pdf)
    return pdf / cfg.n_emitters


def eval_emitter_hit(scene, si, active):
    """Radiance emitted toward the viewer at a surface hit (area
    emitters)."""
    nc = scene.config.variant.channels(si.wavelengths)
    out = _zeros_like_batch(si.t, nc)
    if "area" not in scene.config.emitter_kinds:
        return out
    em_idx = scene.shape_emitter[torch.clamp(si.shape_index, min=0)]
    has = active & si.is_valid & (em_idx >= 0)
    slot = torch.where(has, scene.emitter_slot[torch.clamp(em_idx, min=0)],
                       0)
    v = area_eval(scene, scene.emitters["area"], slot, si, has)
    return torch.where(has[:, None], v, out)


def eval_environment(scene, ray, escaped, active):
    """Radiance of escaped rays (the constant or envmap environment)."""
    cfg = scene.config
    out = _zeros_like_batch(ray.o, cfg.variant.channels(ray.wavelengths))
    if cfg.env_emitter < 0:
        return out
    slot = scene.emitter_slot[cfg.env_emitter].expand(ray.o.shape[0])
    m = active & escaped
    if "envmap" in cfg.emitter_kinds:
        v = envmap_eval(scene, scene.emitters["envmap"], slot, ray.d,
                        ray.wavelengths, m)
    else:
        v = constant_eval(scene, scene.emitters["constant"], slot,
                          ray.wavelengths, m)
    return torch.where(m[:, None], v, out)


# --- Endpoint::sample_ray: rays leaving the emitters -------------------------
# Each kind draws a ray and its importance weight from the same numbers
# (wl_s, s_a, s_b, s_c). In spectral the ray's wavelengths are drawn from
# the emitter's texture spectrum with wl_s and the spectral weight (value /
# pdf) is folded into the ray weight; in rgb and mono the weight is the
# plain texture value and the ray carries no wavelengths.

def _zero_uv(slot):
    return torch.zeros(slot.shape[0], 2, device=slot.device)


def _sample_wl(scene, tex_idx, uv, wl_s, active):
    """(wavelengths (N, nw), spectral weight (N, nc)) of an emitter's
    texture: Texture::sample_spectrum in spectral (the area.cpp:107-113
    branch), else no wavelengths and the texture's value."""
    if scene.config.variant.is_spectral:
        return texture_sample_spectrum(scene, tex_idx, uv, wl_s, active)
    return uv.new_zeros(uv.shape[0], 0), texture_eval(scene, tex_idx, uv)


def area_sample_ray(scene, params, slot, wl_s, s_a, s_b, s_c, time, active):
    """area.cpp:74-119: a position on the shape, a cosine direction;
    weight = radiance pi / p_area."""
    ps = shape_sampling.sample_position(scene, params["shape"][slot], s_a,
                                        s_b)
    wl, spec = _sample_wl(scene, params["radiance"][slot], ps.uv, wl_s,
                          active)
    d = Frame.from_normal(ps.n).to_world(
        warp.square_to_cosine_hemisphere(s_c))
    w = spec * (math.pi / torch.clamp(ps.pdf, min=1e-20))[:, None]
    return Ray.make(ps.p, d, time=time, wavelengths=wl), w


def constant_sample_ray(scene, params, slot, wl_s, s_a, s_b, s_c, time,
                        active):
    """constant.cpp:60-79: a position on the bounding sphere, an inward
    cosine direction; weight = radiance 4 (pi R)^2."""
    wl, spec = _sample_wl(scene, params["radiance"][slot], _zero_uv(slot),
                          wl_s, active)
    v0 = warp.square_to_uniform_sphere(s_b)
    r = scene.bsphere_radius
    o = scene.bsphere_center + v0 * r
    d = Frame.from_normal(-v0).to_world(warp.square_to_cosine_hemisphere(s_c))
    return (Ray.make(o, d, time=time, wavelengths=wl),
            spec * (4.0 * (math.pi * r) ** 2))


def point_sample_ray(scene, params, slot, wl_s, s_a, s_b, s_c, time, active):
    """point.cpp:60-78: a uniform direction; weight = 4 pi intensity."""
    wl, spec = _sample_wl(scene, params["intensity"][slot], _zero_uv(slot),
                          wl_s, active)
    d = warp.square_to_uniform_sphere(s_b)
    o = params["position"][slot].expand(d.shape)
    return Ray.make(o, d, time=time, wavelengths=wl), spec * (4.0 * math.pi)


def directional_sample_ray(scene, params, slot, wl_s, s_a, s_b, s_c, time,
                           active):
    """directional.cpp:80-106: an origin on the bounding sphere's cross
    section upwind of the scene; weight = pi R^2 irradiance."""
    wl, spec = _sample_wl(scene, params["irradiance"][slot], _zero_uv(slot),
                          wl_s, active)
    d = normalize(params["direction"][slot])
    off = warp.square_to_uniform_disk_concentric(s_b)
    fr = Frame.from_normal(d)
    perp = fr.s * off[..., 0:1] + fr.t * off[..., 1:2]
    r = scene.bsphere_radius
    o = scene.bsphere_center + (perp - d) * r
    return (Ray.make(o, d, time=time, wavelengths=wl),
            spec * (math.pi * r ** 2))


def spot_sample_ray(scene, params, slot, wl_s, s_a, s_b, s_c, time, active):
    """spot.cpp:117-137: a uniform direction in the cutoff cone; weight =
    intensity falloff / pdf."""
    wl, spec = _sample_wl(scene, params["intensity"][slot], _zero_uv(slot),
                          wl_s, active)
    axis = normalize(params["direction"][slot])
    ccut = params["cos_cutoff"][slot]
    cbeam = params["cos_beam"][slot]
    local = warp.square_to_uniform_cone(s_b, ccut)
    pdf = warp.square_to_uniform_cone_pdf(local, ccut)
    d = Frame.from_normal(axis).to_world(local)
    falloff = torch.clamp((local[:, 2] - ccut)
                          / torch.clamp(cbeam - ccut, min=1e-6), 0.0, 1.0)
    o = params["position"][slot].expand(d.shape)
    w = spec * (falloff / torch.clamp(pdf, min=1e-20))[:, None]
    return Ray.make(o, d, time=time, wavelengths=wl), w


def projector_sample_ray(scene, params, slot, wl_s, s_a, s_b, s_c, time,
                         active):
    """projector.cpp:117-152: a film uv drawn uniformly, shot through the
    frustum; weight = the irradiance there."""
    uv = s_c
    wl, spec = _sample_wl(scene, params["irradiance"][slot], uv, wl_s,
                          active)
    tan_x = params["tan_half_fov"][slot]
    aspect = params["aspect"][slot]
    d_loc = torch.stack([(1.0 - 2.0 * uv[:, 0]) * tan_x,
                         (1.0 - 2.0 * uv[:, 1]) * tan_x * aspect,
                         torch.ones_like(tan_x)], -1)
    # local to world: the inverse of the stored world-to-local matrix
    l2w = torch.linalg.inv(params["w2l_m"][slot])
    d = normalize(torch.einsum("nij,nj->ni", l2w[:, :3, :3], d_loc))
    o = params["position"][slot].expand(d.shape)
    return Ray.make(o, d, time=time, wavelengths=wl), spec


KIND_RAY_SAMPLERS = {"area": area_sample_ray,
                     "constant": constant_sample_ray,
                     "point": point_sample_ray,
                     "directional": directional_sample_ray,
                     "spot": spot_sample_ray,
                     "projector": projector_sample_ray}


def sample_emitter_ray(scene, sampler, time, active=None):
    """Rays leaving the emitters: a uniform emitter pick, then the kind's
    sample_ray; the pick pmf is folded into the weight. In spectral the
    ray carries the 4 wavelengths drawn from the emitter's spectrum and the
    weight its spectral weight. Returns (ray, weight (N, nc), emitter
    index, sampler). An envmap raises, as the reference's does
    (envmap.cpp:149-154)."""
    cfg = scene.config
    n_em = cfg.n_emitters
    if n_em == 0:
        raise ValueError("sample_emitter_ray: the scene has no emitters")
    for kind in cfg.emitter_kinds:
        if kind not in KIND_RAY_SAMPLERS:
            raise NotImplementedError(
                f"sample_ray for emitter kind {kind!r} (envmap.cpp:149-154 "
                "raises too)")
    sampler, s_pick = sampler.next_1d()
    sampler, wl_s = sampler.next_1d()
    sampler, s_a = sampler.next_1d()
    sampler, s_b = sampler.next_2d()
    sampler, s_c = sampler.next_2d()
    idx = torch.clamp((s_pick * n_em).to(torch.int32), max=n_em - 1)
    kind_id = scene.emitter_kind[idx]
    slot = scene.emitter_slot[idx]
    n = idx.shape[0]
    dev = idx.device
    active = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
              else active)
    time = torch.as_tensor(time, dtype=torch.float32, device=dev).expand(n)
    nw = N_HERO if cfg.variant.is_spectral else 0
    ray = Ray.make(torch.zeros(n, 3, device=dev),
                   torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3),
                   time=time, wavelengths=torch.zeros(n, nw, device=dev))
    weight = torch.zeros(n, cfg.variant.channels(ray.wavelengths), device=dev)
    for k, kind in enumerate(cfg.emitter_kinds):
        m = active & (kind_id == k)
        r_k, w_k = KIND_RAY_SAMPLERS[kind](
            scene, scene.emitters[kind], torch.where(kind_id == k, slot, 0),
            wl_s, s_a, s_b, s_c, time, m)
        ray = dataclasses.replace(
            ray, o=torch.where(m[:, None], r_k.o, ray.o),
            d=torch.where(m[:, None], r_k.d, ray.d),
            mint=torch.where(m, r_k.mint, ray.mint),
            maxt=torch.where(m, r_k.maxt, ray.maxt),
            wavelengths=torch.where(m[:, None], r_k.wavelengths,
                                    ray.wavelengths))
        weight = torch.where(m[:, None], w_k * n_em, weight)
    return ray, torch.where(active[:, None], weight, 0.0), idx, sampler
