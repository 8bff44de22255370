"""Spectra and textures (render/texture.py counterpart).

The spectrum registry maps wavelengths to a value per spectrum object. In
the rgb and mono variants every spectrum bakes at scene build into a
'baked' constant of (n, nc), so a spectrum lookup is one gather. In the
spectral variant the kinds survive and are evaluated at the ray's hero
wavelengths (``spectrum_eval``): uniform, regular, irregular, srgb
(Jakob-Hanika sigmoid polynomial), blackbody, d65, srgb_d65 and discrete
(a line spectrum: 0 almost everywhere, read only through sampling);
wavelengths outside a tabulated spectrum's support give 0. Every
continuous kind carries a build-time piecewise-linear sampling table
(``smp_nodes``/``smp_pdf``/``smp_cdf``) for ``spectrum_sample`` and
``spectrum_pdf``.

The texture kinds, dispatched by a masked sweep over the kinds present:

- ``constant``: a spectrum index;
- ``checkerboard``: two spectra, ``floor(uv * 2)`` parity picks one;
- ``bitmap``: bilinear in ``scene.bitmap_data`` (n, H, W, 3), uv clamped
  to [0, 1); mono takes the mean of rgb; spectral interpolates the
  texels' rgb2spec coefficients and scales (``scene.bitmap_coeff``,
  ``bitmap_scale``, fitted at scene build) and evaluates the sigmoid at
  the hero wavelengths;
- ``mesh_attribute``: the barycentric interpolation (through
  ``prim_index`` and ``prim_uv``) of per-vertex data in
  ``scene.mesh_attr_data`` (A, V, 3), times its scale; mono and spectral
  take the mean.

Lanes of another kind read slot 0 of each kind's table (the reference's
gathers clamp their indices; torch's indexing raises).
"""

from __future__ import annotations

import torch

from ..core import spectrum as sp
from ..core.math import channel_mean


# =============================================================================
# the spectrum registry
# =============================================================================
#
# scene.spectra: kind -> params; spectrum i is (spec_kind[i], spec_slot[i]).
# Kind layouts:
#   'baked':     value (n, nc)                           [rgb/mono variants]
#   'uniform':   value (n,)                                   [uniform.cpp]
#   'regular':   values (n, K) padded, lo, hi, count (n,)     [regular.cpp]
#   'irregular': nodes (n, K), values (n, K), count (n,)    [irregular.cpp]
#   'srgb':      coeff (n, 3) sigmoid-polynomial coefficients    [srgb.cpp]
#   'blackbody': temperature (n,), scale (n,)               [blackbody.cpp]
#   'd65':       scale (n,)                                       [d65.cpp]
#   'srgb_d65':  coeff (n, 3), scale (n,)
#   'discrete':  wavelengths (n, K), values (n, K), count (n,) [discrete.cpp]

def _take(a, i):
    return torch.gather(a, -1, i.long())


def spectrum_eval(spectra, spec_kind, spec_slot, kinds, wavelengths,
                  dtype=torch.float32):
    """Spectrum objects (spec_kind/spec_slot (N,) i32) per lane -> (N, nc):
    the baked value (rgb/mono), or the value at ``wavelengths`` (N, nw)
    (spectral), accumulated in ``dtype`` (the scene's). Lanes of another
    kind read slot 0 of each kind's table."""
    if kinds == ("baked",):
        return spectra["baked"]["value"][spec_slot]
    out = torch.zeros(wavelengths.shape, dtype=dtype,
                      device=wavelengths.device)
    for k, kind in enumerate(kinds):
        m = spec_kind == k
        p = spectra[kind]
        s = torch.where(m, spec_slot, 0)
        col = lambda key: p[key][s][..., None]
        if kind == "baked":
            v = p["value"][s].expand(out.shape)
        elif kind == "uniform":
            v = col("value").expand(out.shape)
        elif kind == "regular":
            lo, hi, cnt = col("lo"), col("hi"), col("count")
            vals = p["values"][s]                     # (N, K)
            K = vals.shape[-1]
            t = (wavelengths - lo) / torch.clamp(hi - lo, min=1e-9) \
                * (cnt - 1)
            i0 = torch.clamp(t.to(torch.int32), 0, K - 2)
            i0 = torch.minimum(i0, torch.clamp(cnt - 2, min=0))
            f = torch.clamp(t - i0, 0.0, 1.0)
            v = _take(vals, i0) * (1 - f) + _take(
                vals, torch.clamp(i0 + 1, max=K - 1)) * f
            v = torch.where((wavelengths >= lo) & (wavelengths <= hi), v, 0.0)
        elif kind == "irregular":
            nodes, vals = p["nodes"][s], p["values"][s]
            K = vals.shape[-1]
            cnt = col("count")
            idx = torch.clamp(torch.sum(
                (wavelengths[..., None, :] >= nodes[..., :, None]).to(
                    torch.int32), dim=-2) - 1, 0, K - 2)
            idx = torch.minimum(idx, torch.clamp(cnt - 2, min=0))
            x0, x1 = _take(nodes, idx), _take(nodes, idx + 1)
            y0, y1 = _take(vals, idx), _take(vals, idx + 1)
            f = torch.clamp((wavelengths - x0) / torch.clamp(x1 - x0,
                                                             min=1e-9),
                            0.0, 1.0)
            v = y0 * (1 - f) + y1 * f
            last = _take(nodes, torch.clamp(cnt - 1, min=0))
            v = torch.where((wavelengths >= nodes[..., :1])
                            & (wavelengths <= last), v, 0.0)
        elif kind == "srgb":
            v = srgb_model_eval(p["coeff"][s], wavelengths)
        elif kind == "blackbody":
            v = sp.blackbody_radiance(wavelengths, col("temperature")) \
                * col("scale")
        elif kind == "d65":
            v = d65_approx(wavelengths) * col("scale")
        elif kind == "srgb_d65":
            v = srgb_model_eval(p["coeff"][s], wavelengths) \
                * d65_approx(wavelengths) * col("scale")
        elif kind == "discrete":
            v = torch.zeros_like(wavelengths)  # a line spectrum: 0 a.s.
        else:
            raise ValueError(f"unknown spectrum kind {kind}")
        out = torch.where(m[..., None], v, out)
    return out


def srgb_model_eval(coeff, wavelengths):
    """The sigmoid-polynomial reflectance of rgb2spec coefficients
    (srgb.h:9-21; Jakob and Hanika 2019): coeff (..., 3), wavelengths
    (..., nw) nm."""
    x = (coeff[..., 0:1] * (wavelengths * wavelengths)
         + coeff[..., 1:2] * wavelengths + coeff[..., 2:3])
    return 0.5 * x / torch.sqrt(1.0 + x * x) + 0.5


def scene_spectrum_eval(scene, spec_idx, wavelengths=None):
    """Spectra ``spec_idx`` (N,) of the scene at ``wavelengths`` (N, nw;
    unused by the baked rgb/mono spectra) -> (N, nc)."""
    return spectrum_eval(scene.spectra, scene.spec_kind[spec_idx],
                         scene.spec_slot[spec_idx],
                         scene.config.spectrum_kinds, wavelengths,
                         scene.config.variant.dtype)


def texture_eval(scene, tex_index, uv=None, prim_index=None, prim_uv=None,
                 wavelengths=None):
    """(N, nc) value of texture ``tex_index`` (i32 (N,)) at the lanes'
    ``uv`` (N, 2; None reads uv (0, 0), as the reference's point and
    directional lights pass); ``prim_index`` and ``prim_uv`` feed
    mesh_attribute; ``wavelengths`` (N, nw) the spectral variant's hero
    wavelengths. A scene whose textures are all constant reads no uv."""
    kinds = scene.config.texture_kinds
    slot = scene.tex_slot[tex_index]
    spec = lambda i: scene_spectrum_eval(scene, i, wavelengths)
    if kinds == ("constant",):
        return spec(scene.textures["constant"]["spec"][slot])
    mode = scene.config.variant.mode
    if uv is None:
        uv = torch.zeros(tex_index.shape[0], 2, device=tex_index.device)
    kind_id = scene.tex_kind[tex_index]
    out = None
    for k, kind in enumerate(kinds):
        m = kind_id == k
        p = scene.textures[kind]
        s = torch.where(m, slot, 0)
        if kind == "constant":
            v = spec(p["spec"][s])
        elif kind == "checkerboard":
            iu = torch.floor(uv[..., 0] * 2.0).to(torch.int32)
            iv = torch.floor(uv[..., 1] * 2.0).to(torch.int32)
            odd = ((iu + iv) & 1) == 1
            v = torch.where(odd[..., None], spec(p["spec1"][s]),
                            spec(p["spec0"][s]))
        elif kind == "bitmap":
            img = p["image"][s].long()
            if mode == "spectral":
                v = _bitmap_spectral(scene, img, uv, wavelengths)
            else:
                v = _bitmap(scene.bitmap_data, img, uv, mode == "mono")
        elif kind == "mesh_attribute":
            v = _mesh_attribute(scene, p, s, prim_index, prim_uv, mode,
                                wavelengths)
        else:
            raise ValueError(f"unknown texture kind {kind}")
        out = v if out is None else torch.where(m[..., None], v, out)
    return out


def _bilinear_setup(H, W, uv):
    """(x0, y0, x1, y1, fx, fy) of the bilinear lookup at uv clamped to
    [0, 1)."""
    u = torch.clamp(uv[..., 0], 0.0, 1.0 - 1e-6) * (W - 1)
    v = torch.clamp(uv[..., 1], 0.0, 1.0 - 1e-6) * (H - 1)
    x0 = u.to(torch.int32)
    y0 = v.to(torch.int32)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    return (x0, y0, torch.clamp(x0 + 1, max=W - 1),
            torch.clamp(y0 + 1, max=H - 1), fx, fy)


def _bitmap_spectral(scene, img, uv, wavelengths):
    """The spectral bitmap: the texels' rgb2spec coefficients and
    brightness scales (fitted at scene build, the envmap.cpp:69-89 scheme)
    interpolated bilinearly, the sigmoid evaluated at the hero
    wavelengths, times the scale."""
    cf, sc = scene.bitmap_coeff, scene.bitmap_scale
    x0, y0, x1, y1, fx, fy = _bilinear_setup(cf.shape[1], cf.shape[2], uv)
    coeff = (cf[img, y0, x0] * (1 - fx) * (1 - fy)
             + cf[img, y0, x1] * fx * (1 - fy)
             + cf[img, y1, x0] * (1 - fx) * fy
             + cf[img, y1, x1] * fx * fy)
    fx, fy = fx[..., 0], fy[..., 0]
    scale = (sc[img, y0, x0] * (1 - fx) * (1 - fy)
             + sc[img, y0, x1] * fx * (1 - fy)
             + sc[img, y1, x0] * (1 - fx) * fy
             + sc[img, y1, x1] * fx * fy)
    return srgb_model_eval(coeff, wavelengths) * scale[..., None]


def _bitmap(data, img, uv, mono):
    """Bilinear lookup of images ``img`` (N,) of ``data`` (n, H, W, 3)."""
    x0, y0, x1, y1, fx, fy = _bilinear_setup(data.shape[1], data.shape[2],
                                             uv)
    rgb = (data[img, y0, x0] * (1 - fx) * (1 - fy)
           + data[img, y0, x1] * fx * (1 - fy)
           + data[img, y1, x0] * (1 - fx) * fy
           + data[img, y1, x1] * fx * fy)
    return channel_mean(rgb, keepdim=True) if mono else rgb


def _mesh_attribute(scene, p, s, prim_index, prim_uv, mode, wavelengths):
    faces = scene.geo.faces
    n = s.shape[0]
    nc = (wavelengths.shape[-1] if mode == "spectral"
          else scene.config.variant.n_channels)
    if prim_index is None or faces.shape[0] == 0:
        return torch.zeros(n, nc, device=s.device)
    data = scene.mesh_attr_data
    attr = p["attr"][s].long()
    f = faces[torch.clamp(prim_index, 0, faces.shape[0] - 1)].long()
    u = prim_uv[..., 0:1]
    v = prim_uv[..., 1:2]
    w = 1.0 - u - v
    rgb = (data[attr, f[:, 0]] * w + data[attr, f[:, 1]] * u
           + data[attr, f[:, 2]] * v) * p["scale"][s][..., None]
    if mode == "rgb":
        return rgb
    return channel_mean(rgb, keepdim=True).expand(n, nc)


def d65_approx(wavelengths):
    """The CIE D65 illuminant, approximated as a blackbody at 6504 K scaled
    to 1 at 560 nm (float32, as the reference approximates it)."""
    bb = sp.blackbody_radiance(wavelengths, 6504.0)
    bb_mean = sp.blackbody_radiance(
        torch.tensor(560.0, device=wavelengths.device), 6504.0)
    return bb / bb_mean


# =============================================================================
# spectral importance sampling (Texture::sample_spectrum / pdf_spectrum,
# texture.h:23-201): a continuous kind inverts its build-time sampling
# table's CDF (quadratic within a segment) and reports that table's density
# as the pdf; a discrete kind picks its lines
# =============================================================================

def _segment(x, knots):
    """(N, nw) index of the segment of ``knots`` (N, P) holding each x,
    clamped to [0, P - 2]."""
    P = knots.shape[-1]
    return torch.clamp(torch.sum((x[..., None, :] >= knots[..., :, None])
                                 .to(torch.int32), dim=-2) - 1, 0, P - 2)


def _table_invert_cdf(nodes, pdfv, cdf, u):
    """Wavelengths (N, nw) at uniforms u (N, nw) of the piecewise-linear
    density (nodes, pdfv, cdf (N, P))."""
    seg = _segment(u, cdf)
    c0 = _take(cdf, seg)
    x0, x1 = _take(nodes, seg), _take(nodes, seg + 1)
    y0, y1 = _take(pdfv, seg), _take(pdfv, seg + 1)
    dx = torch.clamp(x1 - x0, min=1e-9)
    du = u - c0
    slope = (y1 - y0) / dx
    disc = torch.clamp(y0 * y0 + 2.0 * slope * du, min=0.0)
    t_quad = 2.0 * du / torch.clamp(y0 + torch.sqrt(disc), min=1e-12)
    t_lin = du / torch.clamp(y0, min=1e-12)
    t = torch.where(torch.abs(slope) * dx
                    < 1e-9 * torch.clamp(y0, min=1e-9), t_lin, t_quad)
    return x0 + torch.minimum(torch.clamp(t, min=0.0), dx)


def _table_pdf(nodes, pdfv, lam):
    """The sampling table's density at wavelengths lam (N, nw)."""
    P = nodes.shape[-1]
    seg = _segment(lam, nodes)
    x0, x1 = _take(nodes, seg), _take(nodes, seg + 1)
    y0, y1 = _take(pdfv, seg), _take(pdfv, seg + 1)
    f = torch.clamp((lam - x0) / torch.clamp(x1 - x0, min=1e-9), 0.0, 1.0)
    p = y0 * (1 - f) + y1 * f
    inside = (lam >= nodes[..., 0:1]) & (lam <= nodes[..., P - 1:P])
    return torch.where(inside, p, 0.0)


def _uniform_range(shape, like, dtype=torch.float32):
    lo, hi = sp.WAVELENGTH_MIN, sp.WAVELENGTH_MAX
    return torch.full(shape, 1.0 / (hi - lo), dtype=dtype,
                      device=like.device)


def spectrum_sample(spectra, spec_kind, spec_slot, kinds, sample,
                    dtype=torch.float32):
    """Hero wavelengths importance-sampled from spectrum objects: sample
    (N,) uniform -> (wavelengths (N, nw), weight (N, nw) = eval / pdf,
    the regular.cpp:87-97 contract). A discrete spectrum returns its lines
    with weight the sum of its values."""
    ws = sp.sample_shifted(sample)                       # (N, nw)
    lo, hi = sp.WAVELENGTH_MIN, sp.WAVELENGTH_MAX
    lam = lo + ws * (hi - lo)
    pdf = _uniform_range(lam.shape, lam)
    w_discrete = torch.zeros_like(lam)
    is_discrete = torch.zeros(spec_kind.shape + (1,), dtype=torch.bool,
                              device=lam.device)
    for k, kind in enumerate(kinds):
        if kind == "baked":
            continue  # rgb/mono spectra are never sampled
        m = (spec_kind == k)[..., None]
        p = spectra[kind]
        s = torch.where(spec_kind == k, spec_slot, 0)
        if kind == "discrete":
            lines, vals = p["wavelengths"][s], p["values"][s]
            K = lines.shape[-1]
            valid = torch.arange(K, device=lam.device) < p["count"][s][
                ..., None]
            vv = torch.where(valid, vals, 0.0)
            total = torch.sum(vv, -1, keepdim=True)
            cdf = torch.cumsum(vv, -1) / torch.clamp(total, min=1e-20)
            idx = torch.clamp(torch.sum((ws[..., None, :] >= cdf[..., :, None])
                                        .to(torch.int32), dim=-2), 0, K - 1)
            l_k = _take(lines, idx)
            lam = torch.where(m, l_k, lam)
            w_discrete = torch.where(m, total.expand(l_k.shape), w_discrete)
            is_discrete = is_discrete | m
        else:
            nodes, pdfv = p["smp_nodes"][s], p["smp_pdf"][s]
            l_k = _table_invert_cdf(nodes, pdfv, p["smp_cdf"][s], ws)
            lam = torch.where(m, l_k, lam)
            pdf = torch.where(m, _table_pdf(nodes, pdfv, l_k), pdf)
    val = spectrum_eval(spectra, spec_kind, spec_slot, kinds, lam, dtype)
    weight = torch.where(is_discrete, w_discrete,
                         val / torch.clamp(pdf, min=1e-20))
    return lam, weight


def spectrum_pdf(spectra, spec_kind, spec_slot, kinds, wavelengths,
                 dtype=torch.float32):
    """The density of spectrum_sample at ``wavelengths`` (N, nw), in
    ``dtype`` (the scene's); 0 for a discrete spectrum, whose measure has
    atoms."""
    pdf = _uniform_range(wavelengths.shape, wavelengths, dtype)
    for k, kind in enumerate(kinds):
        if kind == "baked":
            continue
        m = (spec_kind == k)[..., None]
        p = spectra[kind]
        s = torch.where(spec_kind == k, spec_slot, 0)
        if kind == "discrete":
            pdf = torch.where(m, 0.0, pdf)
        else:
            pdf = torch.where(m, _table_pdf(p["smp_nodes"][s],
                                            p["smp_pdf"][s], wavelengths),
                              pdf)
    return pdf


def scene_spectrum_sample(scene, spec_idx, sample):
    return spectrum_sample(scene.spectra, scene.spec_kind[spec_idx],
                           scene.spec_slot[spec_idx],
                           scene.config.spectrum_kinds, sample,
                           scene.config.variant.dtype)


def scene_spectrum_pdf(scene, spec_idx, wavelengths):
    return spectrum_pdf(scene.spectra, scene.spec_kind[spec_idx],
                        scene.spec_slot[spec_idx],
                        scene.config.spectrum_kinds, wavelengths,
                        scene.config.variant.dtype)


def texture_sample_spectrum(scene, tex_index, uv, sample, active=None):
    """Texture::sample_spectrum: a 'constant' texture importance-samples
    its spectrum; the spatially varying kinds sample uniformly over the
    global range with weight eval x the range's width. Returns
    (wavelengths (N, nw), weight (N, nw)), zero weight off ``active``."""
    cfg = scene.config
    tex_kind = scene.tex_kind[tex_index]
    tex_slot = scene.tex_slot[tex_index]
    width = sp.WAVELENGTH_MAX - sp.WAVELENGTH_MIN
    lam = sp.WAVELENGTH_MIN + sp.sample_shifted(sample) * width
    weight = None
    const = (cfg.texture_kinds.index("constant")
             if "constant" in cfg.texture_kinds else -1)
    if const >= 0:
        m = (tex_kind == const)[..., None]
        spec = scene.textures["constant"]["spec"][torch.where(
            tex_kind == const, tex_slot, 0)]
        l_k, w_k = scene_spectrum_sample(scene, spec, sample)
        lam = torch.where(m, l_k, lam)
        weight = torch.where(m, w_k, 0.0)
    uni = texture_eval(scene, tex_index, uv, wavelengths=lam) * width
    if weight is None:
        weight = uni
    else:
        weight = torch.where((tex_kind == const)[..., None], weight, uni)
    if active is not None:
        weight = torch.where(active[..., None], weight, 0.0)
    return lam, weight


def texture_pdf_spectrum(scene, tex_index, uv, wavelengths):
    """The density of texture_sample_spectrum at ``wavelengths``."""
    cfg = scene.config
    tex_kind = scene.tex_kind[tex_index]
    pdf = _uniform_range(wavelengths.shape, wavelengths, cfg.variant.dtype)
    if "constant" in cfg.texture_kinds:
        k = cfg.texture_kinds.index("constant")
        spec = scene.textures["constant"]["spec"][torch.where(
            tex_kind == k, scene.tex_slot[tex_index], 0)]
        pdf = torch.where((tex_kind == k)[..., None],
                          scene_spectrum_pdf(scene, spec, wavelengths), pdf)
    return pdf
