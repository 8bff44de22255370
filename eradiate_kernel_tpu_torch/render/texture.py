"""Texture evaluation (the texture half of render/texture.py).

In the rgb and mono variants every spectrum bakes at scene build into a
'baked' constant of (n, nc), so a spectrum lookup is one gather. The
texture kinds, dispatched by a masked sweep over the kinds present:

- ``constant``: a spectrum index;
- ``checkerboard``: two spectra, ``floor(uv * 2)`` parity picks one;
- ``bitmap``: bilinear in ``scene.bitmap_data`` (n, H, W, 3), uv clamped
  to [0, 1); mono takes the mean of rgb;
- ``mesh_attribute``: the barycentric interpolation (through
  ``prim_index`` and ``prim_uv``) of per-vertex data in
  ``scene.mesh_attr_data`` (A, V, 3), times its scale; mono takes the
  mean.

Lanes of another kind read slot 0 of each kind's table (the reference's
gathers clamp their indices; torch's indexing raises).
"""

from __future__ import annotations

import torch

from ..core import spectrum as sp
from ..core.math import channel_mean


def _spectrum(scene, spec):
    return scene.spectra["baked"]["value"][scene.spec_slot[spec]]


def texture_eval(scene, tex_index, uv=None, prim_index=None, prim_uv=None):
    """(N, nc) value of texture ``tex_index`` (i32 (N,)) at the lanes'
    ``uv`` (N, 2; None reads uv (0, 0), as the reference's point and
    directional lights pass); ``prim_index`` and ``prim_uv`` feed
    mesh_attribute. A scene whose textures are all constant reads no
    uv."""
    kinds = scene.config.texture_kinds
    slot = scene.tex_slot[tex_index]
    if kinds == ("constant",):
        return _spectrum(scene, scene.textures["constant"]["spec"][slot])
    mono = scene.config.variant.is_monochromatic
    if uv is None:
        uv = torch.zeros(tex_index.shape[0], 2, device=tex_index.device)
    kind_id = scene.tex_kind[tex_index]
    out = None
    for k, kind in enumerate(kinds):
        m = kind_id == k
        p = scene.textures[kind]
        s = torch.where(m, slot, 0)
        if kind == "constant":
            v = _spectrum(scene, p["spec"][s])
        elif kind == "checkerboard":
            iu = torch.floor(uv[..., 0] * 2.0).to(torch.int32)
            iv = torch.floor(uv[..., 1] * 2.0).to(torch.int32)
            odd = ((iu + iv) & 1) == 1
            v = torch.where(odd[..., None], _spectrum(scene, p["spec1"][s]),
                            _spectrum(scene, p["spec0"][s]))
        elif kind == "bitmap":
            v = _bitmap(scene.bitmap_data, p["image"][s].long(), uv, mono)
        elif kind == "mesh_attribute":
            v = _mesh_attribute(scene, p, s, prim_index, prim_uv, mono)
        else:
            raise ValueError(f"unknown texture kind {kind}")
        out = v if out is None else torch.where(m[..., None], v, out)
    return out


def _bitmap(data, img, uv, mono):
    """Bilinear lookup of images ``img`` (N,) of ``data`` (n, H, W, 3)."""
    H, W = data.shape[1], data.shape[2]
    u = torch.clamp(uv[..., 0], 0.0, 1.0 - 1e-6) * (W - 1)
    v = torch.clamp(uv[..., 1], 0.0, 1.0 - 1e-6) * (H - 1)
    x0 = u.to(torch.int32)
    y0 = v.to(torch.int32)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    rgb = (data[img, y0, x0] * (1 - fx) * (1 - fy)
           + data[img, y0, x1] * fx * (1 - fy)
           + data[img, y1, x0] * (1 - fx) * fy
           + data[img, y1, x1] * fx * fy)
    return channel_mean(rgb, keepdim=True) if mono else rgb


def _mesh_attribute(scene, p, s, prim_index, prim_uv, mono):
    faces = scene.geo.faces
    n = s.shape[0]
    nc = scene.config.variant.n_channels
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
    return channel_mean(rgb, keepdim=True) if mono else rgb


def d65_approx(wavelengths):
    """The CIE D65 illuminant, approximated as a blackbody at 6504 K scaled
    to 1 at 560 nm (float32, as the reference approximates it)."""
    bb = sp.blackbody_radiance(wavelengths, 6504.0)
    bb_mean = sp.blackbody_radiance(
        torch.tensor(560.0, device=wavelengths.device), 6504.0)
    return bb / bb_mean
