"""Sensors (sensors/__init__.py counterpart): perspective, thinlens,
radiancemeter, mradiancemeter, distant, mdistant, distantflux and
irradiancemeter. ``sample_ray(scene, sampler, pos_film, time)`` maps film
positions in [0,1)^2 to a ray and its weight (sensor.cpp:30-80).

The Eradiate sensors (distant, mdistant, mradiancemeter, distantflux)
record the radiance leaving the scene: their rays start outside the
bounding sphere and travel along fixed directions. Every sensor draws
one wavelength sample. In spectral it becomes the ray's 4 hero
wavelengths: stratified over the default range (``sample_wavelength``),
or importance-sampled from the sensor's spectral response function
(``srf``; perspective.cpp:106-180), whose integral is then the spectral
weight, so that the film records the srf-convolved radiance. In mono and
rgb the weight is 1 and the draw keeps the sample streams aligned with
the reference's.
"""

from __future__ import annotations

import math

import torch

from ..core import spectrum as sp
from ..core import warp
from ..core.frame import Frame
from ..core.math import coordinate_system, normalize, widen
from ..core.ray import Ray
from ..render import shape_sampling


def _sample_srf(params, s):
    """Hero wavelengths importance-sampled from a tabulated srf: the
    inverse of its piecewise-linear CDF at the 4 stratified samples.
    Returns (wavelengths (n, 4), weight (n, 4) = the srf's integral)."""
    nodes = params["srf_nodes"]      # (K,)
    cdf = params["srf_cdf"]          # (K,) normalised, 0 ... 1
    ws = sp.sample_shifted(s)
    idx = torch.clamp(torch.searchsorted(cdf, ws, right=True) - 1,
                      0, nodes.shape[0] - 2)
    c0, c1 = cdf[idx], cdf[idx + 1]
    f = (ws - c0) / torch.clamp(c1 - c0, min=1e-12)
    lam = nodes[idx] * (1.0 - f) + nodes[idx + 1] * f
    return lam, params["srf_integral"].expand(lam.shape)


def _sample_srf_lines(params, s):
    """A discrete srf: the hero wavelengths land on its lines (the pmf of
    discrete.cpp); the weight is the sum of the line weights."""
    lines = params["srf_lines"]
    cdf = params["srf_line_cdf"]
    ws = sp.sample_shifted(s)
    idx = torch.clamp(torch.searchsorted(cdf, ws, right=True) - 1,
                      0, lines.shape[0] - 1)
    lam = lines[idx]
    return lam, params["srf_integral"].expand(lam.shape)


def _wavelengths(scene, params, sampler, n):
    """The wavelength draw -> (wavelengths (n, 4) in spectral, else (n, 0);
    weight (n, nc); sampler)."""
    sampler, s = sampler.next_1d()
    if scene.config.variant.is_spectral:
        if "srf_lines" in params:
            wl, weight = _sample_srf_lines(params, s)
        elif "srf_nodes" in params:
            wl, weight = _sample_srf(params, s)
        else:
            wl, weight = sp.sample_wavelength(s)
        return wl, weight, sampler
    return (s.new_zeros(n, 0),
            torch.ones(n, scene.config.variant.n_channels,
                       dtype=scene.config.variant.dtype, device=s.device),
            sampler)


def _static(scene, key, default=None):
    return dict(scene.config.sensor_static).get(key, default)


def _sensor_to_world(params, time):
    """The static to_world, or the keyframes evaluated at each ray's time
    (sensor.cpp evaluates m_to_world at the ray's time)."""
    anim = params.get("to_world_anim")
    return params["to_world"] if anim is None else anim.eval(time)


def _unit(v):
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _film_pinhole(scene, tan_x, pos_film):
    """Camera-space film directions (unnormalised): film u=0 maps to +x
    (the look_at ``left`` axis), v top->bottom maps +y -> -y, the camera
    looks down +z."""
    aspect = scene.config.film_height / scene.config.film_width
    x = widen(1.0 - 2.0 * pos_film[:, 0], tan_x) * tan_x
    y = widen(1.0 - 2.0 * pos_film[:, 1], tan_x) * tan_x * aspect
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def perspective_sample_ray(scene, params, sampler, pos_film, time):
    """Pinhole camera (perspective.cpp)."""
    n = pos_film.shape[0]
    tw = _sensor_to_world(params, time)
    d = _unit(tw.transform_vector(normalize(
        _film_pinhole(scene, params["tan_half_fov"], pos_film))))
    o = tw.translation.expand(n, 3)
    wl, weight, sampler = _wavelengths(scene, params, sampler, n)
    return Ray.make(o, d, time=time, wavelengths=wl), weight, sampler


def thinlens_sample_ray(scene, params, sampler, pos_film, time):
    """Perspective camera with a finite aperture and a focus distance
    (thinlens.cpp)."""
    n = pos_film.shape[0]
    tw = _sensor_to_world(params, time)
    d_cam = _film_pinhole(scene, params["tan_half_fov"], pos_film)
    p_focus = d_cam * (params["focus_distance"] / d_cam[:, 2:3])
    sampler, s_aperture = sampler.next_2d()
    ap = warp.square_to_uniform_disk_concentric(s_aperture) \
        * params["aperture_radius"]
    o_cam = torch.cat([ap, torch.zeros(n, 1, device=ap.device)], dim=-1)
    o = tw.transform_affine_point(o_cam)
    d = _unit(tw.transform_vector(normalize(p_focus - o_cam)))
    wl, weight, sampler = _wavelengths(scene, params, sampler, n)
    return Ray.make(o, d, time=time, wavelengths=wl), weight, sampler


def radiancemeter_sample_ray(scene, params, sampler, pos_film, time):
    """One ray from the origin along +z of to_world (radiancemeter.cpp)."""
    n = pos_film.shape[0]
    tw = _sensor_to_world(params, time)
    o = tw.translation.expand(n, 3)
    z = torch.tensor([0.0, 0.0, 1.0], device=pos_film.device)
    d = normalize(tw.transform_vector(z)).expand(n, 3)
    wl, weight, sampler = _wavelengths(scene, params, sampler, n)
    return Ray.make(o, d, time=time, wavelengths=wl), weight, sampler


def _film_column(scene, pos_film):
    """The film pixel x of each sample of an N x 1 film."""
    W = scene.config.film_width
    return torch.clamp((pos_film[:, 0] * W).to(torch.int64), 0, W - 1)


def mradiancemeter_sample_ray(scene, params, sampler, pos_film, time):
    """N radiance meters, one film pixel each (mradiancemeter.cpp)."""
    idx = _film_column(scene, pos_film)
    o = params["origins"][idx]
    d = normalize(params["directions"][idx])
    wl, weight, sampler = _wavelengths(scene, params, sampler,
                                       pos_film.shape[0])
    return Ray.make(o, d, time=time, wavelengths=wl), weight, sampler


def _distant_origin(scene, sampler, d, params):
    """The ray origins of the distant sensors: upstream of a point target
    by one bounding-sphere diameter, or of a uniform point of the bounding
    sphere's cross-section disk by one radius (distant.cpp:376-384,
    mdistant.cpp:244,258). Returns (origin, sampler)."""
    r = scene.bsphere_radius
    if _static(scene, "target_mode", "none") == "point":
        return params["target"] - d * (2.0 * r), sampler
    s, t = coordinate_system(d)
    sampler, s_aperture = sampler.next_2d()
    offset = warp.square_to_uniform_disk_concentric(s_aperture)
    target = scene.bsphere_center + (s * offset[:, 0:1]
                                     + t * offset[:, 1:2]) * r
    return target - d * r, sampler


def distant_sample_ray(scene, params, sampler, pos_film, time):
    """The radiance leaving the scene along ``direction`` (distant.cpp):
    rays travel along -direction unless ``flip_directions``. The film size
    picks the directions, v0 in the sensor frame: 1x1 +z; Nx1 the arc
    (cos(pi u), 0, sin(pi u)); NxM the uniform hemisphere. A cross-section
    target divides the weight by cos(-d, z_world) (distant.cpp:365) and
    zeroes it for grazing rays; a point target keeps weight 1."""
    n = pos_film.shape[0]
    mode = _static(scene, "direction_mode", "single")
    sgn = 1.0 if _static(scene, "flip_directions", False) else -1.0
    if mode == "single":
        v0 = torch.tensor([0.0, 0.0, 1.0],
                          device=pos_film.device).expand(n, 3)
    elif mode == "plane":
        ang = math.pi * pos_film[:, 0]
        v0 = torch.stack([torch.cos(ang), torch.zeros_like(ang),
                          torch.sin(ang)], dim=-1)
    else:
        v0 = warp.square_to_uniform_hemisphere(pos_film)
    d = normalize(params["to_world"].transform_vector(v0)) * sgn
    o, sampler = _distant_origin(scene, sampler, d, params)
    wl, weight, sampler = _wavelengths(scene, params, sampler, n)
    if _static(scene, "target_mode", "none") == "none":
        den = -d[:, 2:3]
        weight = torch.where(den > 1e-6,
                             weight / torch.clamp(den, min=1e-6), 0.0)
    return Ray.make(o, d, time=time, wavelengths=wl), weight, sampler


def mdistant_sample_ray(scene, params, sampler, pos_film, time):
    """Film pixel x records the radiance along the ray direction
    directions[x] (mdistant.cpp:69-279)."""
    d = normalize(params["directions"][_film_column(scene, pos_film)])
    o, sampler = _distant_origin(scene, sampler, d, params)
    wl, weight, sampler = _wavelengths(scene, params, sampler,
                                       pos_film.shape[0])
    return Ray.make(o, d, time=time, wavelengths=wl), weight, sampler


def distantflux_sample_ray(scene, params, sampler, pos_film, time):
    """Hemispherical exitant flux (distantflux.cpp:208-226): the film
    square warps uniformly over the +z hemisphere of to_world, rays travel
    along -to_world(v0), and the weight cos(-d, normal) * 2 pi / (W H)
    makes the film's sum estimate the flux."""
    tw = params["to_world"]
    d = -normalize(tw.transform_vector(
        warp.square_to_uniform_hemisphere(pos_film)))
    nrm = normalize(tw.transform_vector(
        torch.tensor([0.0, 0.0, 1.0], device=pos_film.device)))
    o, sampler = _distant_origin(scene, sampler, d, params)
    wl, weight, sampler = _wavelengths(scene, params, sampler,
                                       pos_film.shape[0])
    n_pix = scene.config.film_width * scene.config.film_height
    cos_n = torch.sum(-d * nrm, dim=-1)
    return (Ray.make(o, d, time=time, wavelengths=wl),
            weight * (cos_n * 2.0 * math.pi / n_pix)[:, None], sampler)


def irradiancemeter_sample_ray(scene, params, sampler, pos_film, time):
    """Cosine-weighted rays from the surface of the sensor's shape; weight
    pi turns the estimate into irradiance (irradiancemeter.cpp:60-110)."""
    n = pos_film.shape[0]
    shape_idx = params["shape"].expand(n)
    sampler, s_face = sampler.next_1d()
    sampler, s_pos = sampler.next_2d()
    sampler, s_dir = sampler.next_2d()
    ps = shape_sampling.sample_position(scene, shape_idx, s_face, s_pos)
    d = Frame.from_normal(ps.n).to_world(
        warp.square_to_cosine_hemisphere(s_dir))
    wl, weight, sampler = _wavelengths(scene, params, sampler, n)
    return Ray.make(ps.p + ps.n * 1e-4, d, time=time,
                    wavelengths=wl), weight * math.pi, \
        sampler


REGISTRY = {
    "perspective": perspective_sample_ray,
    "thinlens": thinlens_sample_ray,
    "radiancemeter": radiancemeter_sample_ray,
    "mradiancemeter": mradiancemeter_sample_ray,
    "distant": distant_sample_ray,
    "mdistant": mdistant_sample_ray,
    "distantflux": distantflux_sample_ray,
    "irradiancemeter": irradiancemeter_sample_ray,
}


def register_sensor(name, fn):
    """Add a sensor kind: fn(scene, params, sampler, pos_film, time) ->
    (ray, weight, sampler)."""
    REGISTRY[name] = fn


def sample_ray(scene, sampler, pos_film, time):
    """Film positions in [0,1)^2 -> (ray, weight, sampler). A sensor with
    a shutter draws each ray's time uniformly over [shutter_open,
    shutter_close] before anything else (sensor.cpp:58-62)."""
    params = scene.sensor
    if "shutter_open" in params:
        sampler, u = sampler.next_1d()
        time = params["shutter_open"] + u * params["shutter_span"]
    fn = REGISTRY[scene.config.sensor_kind]
    return fn(scene, params, sampler, pos_film, time)


def sample_ray_differential(scene, sampler, pos_film, time, diff_scale=1.0):
    """Sensor::sample_ray_differential (sensor.cpp:59-84): the main ray and
    two rays re-sampled one film pixel over in x and y. The offset calls
    replay the same sampler state as the main ray (the reference passes
    the same samples to all three sample_ray calls), so their aperture,
    wavelength and shutter draws match; only the main call's advanced
    sampler is kept. The differentials are scaled by ``diff_scale``
    (1/sqrt(spp) in the drivers: Ray::scale_differential and
    integrator.cpp:257-261). Returns (ray, RayDifferential, weight,
    sampler)."""
    from ..render.records import RayDifferential

    cfg = scene.config
    ray, weight, sampler_out = sample_ray(scene, sampler, pos_film, time)
    dx = torch.tensor([1.0 / cfg.film_width, 0.0], device=pos_film.device)
    dy = torch.tensor([0.0, 1.0 / cfg.film_height], device=pos_film.device)
    ray_x, _, _ = sample_ray(scene, sampler, pos_film + dx, time)
    ray_y, _, _ = sample_ray(scene, sampler, pos_film + dy, time)
    rd = RayDifferential(
        o_x=ray.o + (ray_x.o - ray.o) * diff_scale,
        d_x=ray.d + (ray_x.d - ray.d) * diff_scale,
        o_y=ray.o + (ray_y.o - ray.o) * diff_scale,
        d_y=ray.d + (ray_y.d - ray.d) * diff_scale)
    return ray, rd, weight, sampler_out
