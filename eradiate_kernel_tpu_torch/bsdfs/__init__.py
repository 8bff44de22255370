"""BSDF registry and wavefront dispatch (bsdfs/__init__.py counterpart):
a masked sweep over the BSDF kinds present in the scene; each kind
evaluates the whole wavefront and the results are selected by kind mask.
Lanes of other kinds read slot 0 of each kind's table (the reference's
gathers clamp their indices; torch's indexing raises), in the nested
dispatch too.

Wrapper kinds (mask, blendbsdf, normalmap, bumpmap) hold a nested global
BSDF index and dispatch it over the non-wrapper kinds: one nesting
level, as in the reference.

Every dispatcher takes the transport ``mode`` (common.RADIANCE by
default, as every integrator calls them; common.IMPORTANCE) and hands it
to the kinds, as the reference's do. The polarized sample's wo comes
from the scalar sampler in RADIANCE, its Mueller weight in ``mode``
(the reference's bsdf_sample_mueller).

The polarized dispatch (``bsdf_eval_mueller``, ``bsdf_sample_mueller``)
returns per-channel (N, nc, 4, 4) Mueller stacks in the implicit
world-space Stokes bases: the kinds with ``eval_mueller`` or
``sample_mueller_weight`` give full matrices (pplastic, measured_polarized,
the conductors and dielectrics), the optical elements (polarizer,
retarder, circular) their element matrices, null the identity, and every
other kind a depolarizer carrying its scalar value (the approximation
Mitsuba's unpolarized-only plugins make through unpolarized<Spectrum>)."""

from __future__ import annotations

import torch

from ..core import mueller as mu
from ..core.math import dot
from ..utils.runtime import scoped_phase
from . import (bilambertian, blendbsdf, bumpmap, circular, common,
               conductor, dielectric, diffuse, mask, measured,
               measured_polarized, normalmap, null, plastic, polarizer,
               pplastic, retarder, roughconductor, roughdielectric,
               roughplastic, rpv, thindielectric)
from .common import BSDFSample, zero_bsdf_sample

REGISTRY = {
    "diffuse": diffuse,
    "null": null,
    "rpv": rpv,
    "bilambertian": bilambertian,
    "conductor": conductor,
    "roughconductor": roughconductor,
    "dielectric": dielectric,
    "roughdielectric": roughdielectric,
    "thindielectric": thindielectric,
    "plastic": plastic,
    "roughplastic": roughplastic,
    "pplastic": pplastic,
    "measured": measured,
    "measured_polarized": measured_polarized,
    "mask": mask,
    "blendbsdf": blendbsdf,
    "normalmap": normalmap,
    "bumpmap": bumpmap,
    "polarizer": polarizer,
    "retarder": retarder,
    "circular": circular,
}

POLARIZED_ELEMENT_KINDS = tuple(
    k for k, v in REGISTRY.items()
    if getattr(v, "IS_POLARIZED_ELEMENT", False))

WRAPPER_KINDS = tuple(k for k, v in REGISTRY.items()
                      if getattr(v, "IS_WRAPPER", False))


def register_bsdf(name, module):
    """Register a user BSDF kind ``name``: ``module`` is any namespace
    with a built-in kind's ``build(props, builder) -> row dict``, ``FLAGS``
    and ``sample`` and ``eval_pdf`` (the signatures of bsdfs/diffuse.py,
    the transport mode their last argument)."""
    REGISTRY[name] = module


def bsdf_flags(scene, bsdf_index):
    """The lobe flags (N,) of each lane's BSDF."""
    return scene.bsdf_flags[bsdf_index]


def _kinds(scene, nested):
    """(k, kind) of the scene's kinds; the non-wrapper ones if
    ``nested``."""
    return [(k, kind) for k, kind in enumerate(scene.config.bsdf_kinds)
            if not (nested and kind in WRAPPER_KINDS)]


def _kind_slot(scene, bsdf_index, k):
    """(mask, slot) of kind k; other kinds' lanes read slot 0."""
    kind_id = scene.bsdf_kind[bsdf_index]
    return kind_id == k, torch.where(kind_id == k,
                                     scene.bsdf_slot[bsdf_index], 0)


def _sample(scene, bsdf_index, si, s1, s2, active, mode, nested):
    nc = scene.config.variant.channels(si.wavelengths)
    bs, weight = zero_bsdf_sample(si.t.shape[0], nc, si.t.device,
                                  si.t.dtype)
    for k, kind in _kinds(scene, nested):
        is_k, slot = _kind_slot(scene, bsdf_index, k)
        m = active & is_k
        b, w = REGISTRY[kind].sample(scene, scene.bsdfs[kind], slot, si, s1,
                                     s2, m, mode)
        bs = BSDFSample(
            wo=torch.where(m[..., None], b.wo, bs.wo),
            pdf=torch.where(m, b.pdf, bs.pdf),
            eta=torch.where(m, b.eta, bs.eta),
            sampled_type=torch.where(m, b.sampled_type, bs.sampled_type))
        weight = torch.where(m[..., None], w, weight)
    return bs, weight


def _eval_pdf(scene, bsdf_index, si, wo, active, mode, nested):
    nc = scene.config.variant.channels(si.wavelengths)
    value = si.t.new_zeros(si.t.shape[0], nc)
    pdf = torch.zeros_like(si.t)
    for k, kind in _kinds(scene, nested):
        is_k, slot = _kind_slot(scene, bsdf_index, k)
        m = active & is_k
        v, p = REGISTRY[kind].eval_pdf(scene, scene.bsdfs[kind], slot, si,
                                       wo, m, mode)
        value = torch.where(m[..., None], v, value)
        pdf = torch.where(m, p, pdf)
    return value, pdf


@scoped_phase("ert::bsdf")
def bsdf_sample(scene, bsdf_index, si, s1, s2, active, mode=common.RADIANCE):
    """Dispatch sample() over the kinds present -> (BSDFSample, weight)."""
    return _sample(scene, bsdf_index, si, s1, s2, active, mode, False)


@scoped_phase("ert::bsdf")
def bsdf_eval_pdf(scene, bsdf_index, si, wo, active, mode=common.RADIANCE):
    """Dispatch eval_pdf() -> (value incl. cosine (N, nc), pdf (N,))."""
    return _eval_pdf(scene, bsdf_index, si, wo, active, mode, False)


def dispatch_sample_nested(scene, bsdf_index, si, s1, s2, active,
                           mode=common.RADIANCE):
    """sample() over the non-wrapper kinds: a wrapper's nested BSDF."""
    return _sample(scene, bsdf_index, si, s1, s2, active, mode, True)


def dispatch_eval_pdf_nested(scene, bsdf_index, si, wo, active,
                             mode=common.RADIANCE):
    return _eval_pdf(scene, bsdf_index, si, wo, active, mode, True)


def eval_null_transmission(scene, bsdf_index, si, active):
    """The unscattered straight-through transmittance (N, nc) of the kinds
    that have one (bsdf.h eval_null_transmission)."""
    nc = scene.config.variant.channels(si.wavelengths)
    out = torch.zeros(si.t.shape[0], nc, device=si.t.device)
    for k, kind in enumerate(scene.config.bsdf_kinds):
        fn = getattr(REGISTRY[kind], "eval_null_transmission", None)
        if fn is not None:
            is_k, slot = _kind_slot(scene, bsdf_index, k)
            m = active & is_k
            out = torch.where(m[..., None], fn(
                scene, scene.bsdfs[kind], slot, si, m), out)
    return out


def _depolarizer_stack(value):
    """(N, nc) scalar values -> (N, nc, 4, 4) depolarizers."""
    return mu.depolarizer(value)


def bsdf_eval_mueller(scene, bsdf_index, si, wo, active,
                      mode=common.RADIANCE):
    """The polarized eval: the (N, nc, 4, 4) stack in the implicit
    world-space Stokes bases (to_world_mueller applied) and the scalar
    pdf, what ``bsdf->eval`` returns in Mitsuba's polarized variants
    (interaction.h:275, path.cpp:165)."""
    nc = scene.config.variant.channels(si.wavelengths)
    out = si.t.new_zeros(si.t.shape[0], nc, 4, 4)
    pdf = torch.zeros_like(si.t)
    for k, kind in enumerate(scene.config.bsdf_kinds):
        mod = REGISTRY[kind]
        is_k, slot = _kind_slot(scene, bsdf_index, k)
        m = active & is_k
        v, p = mod.eval_pdf(scene, scene.bsdfs[kind], slot, si, wo, m, mode)
        if hasattr(mod, "eval_mueller"):
            mm = mu.to_world_mueller(si.sh_frame, mod.eval_mueller(
                scene, scene.bsdfs[kind], slot, si, wo, m, mode), -wo, si.wi)
        else:
            mm = _depolarizer_stack(v)
        out = torch.where(m[..., None, None, None], mm, out)
        pdf = torch.where(m, p, pdf)
    return out, pdf


def _element_weight(mod, scene, params, slot, si, w, m):
    """A delta-transmissive element's Mueller weight: its own-frame matrix
    (horizontal axis: dp_du projected perpendicular to the propagation
    direction), rescaled per channel to the scalar weight ``w``, in the
    implicit world-space Stokes frames (the light goes on along wi: wo =
    -wi)."""
    m_elem = mod.mueller(scene, params, slot, si, m)
    f = si.wi
    h = si.sh_frame.to_local(si.dp_du)
    h = h - f * dot(h, f, keepdims=True)
    h_len = torch.linalg.norm(h, dim=-1, keepdim=True)
    basis = mu.stokes_basis(f)
    h = torch.where(h_len > 1e-8, h / torch.clamp(h_len, min=1e-12), basis)
    m_elem = mu.rotate_stokes_basis(f, h, basis) @ m_elem \
        @ mu.rotate_stokes_basis(f, basis, h)
    m00 = m_elem[..., 0, 0]
    scale = w / torch.clamp(m00, min=1e-12)[..., None]
    mm = torch.where((m00 > 1e-12)[..., None, None, None],
                     scale[..., None, None] * m_elem[..., None, :, :],
                     _depolarizer_stack(w))
    return mu.to_world_mueller(si.sh_frame, mm, si.wi, si.wi)


def bsdf_sample_mueller(scene, bsdf_index, si, s1, s2, active,
                        mode=common.RADIANCE):
    """The polarized bsdf_sample: wo from the scalar sampler, and the
    Mueller importance weight (value / pdf as an (N, nc, 4, 4) stack in
    the world Stokes bases)."""
    bs, w = bsdf_sample(scene, bsdf_index, si, s1, s2, active)
    weight_m = _depolarizer_stack(w)
    for k, kind in enumerate(scene.config.bsdf_kinds):
        mod = REGISTRY[kind]
        is_k, slot = _kind_slot(scene, bsdf_index, k)
        m = active & is_k
        params = scene.bsdfs[kind]
        if kind == "null":
            # straight through: the whole Stokes state goes on
            mm = w[..., None, None] * torch.eye(4, dtype=w.dtype,
                                                device=w.device)
        elif kind in POLARIZED_ELEMENT_KINDS:
            mm = _element_weight(mod, scene, params, slot, si, w, m)
        elif hasattr(mod, "sample_mueller_weight"):
            mm = mu.to_world_mueller(si.sh_frame, mod.sample_mueller_weight(
                scene, params, slot, si, bs, w, m, mode), -bs.wo, si.wi)
        elif hasattr(mod, "eval_mueller"):
            mm = mu.to_world_mueller(si.sh_frame, mod.eval_mueller(
                scene, params, slot, si, bs.wo, m, mode), -bs.wo, si.wi)
            mm = torch.where(
                (bs.pdf > 0)[..., None, None, None],
                mm / torch.clamp(bs.pdf, min=1e-20)[..., None, None, None],
                0.0)
        else:
            continue
        weight_m = torch.where(m[..., None, None, None], mm, weight_m)
    return bs, weight_m


__all__ = ["REGISTRY", "WRAPPER_KINDS", "POLARIZED_ELEMENT_KINDS",
           "bsdf_sample", "bsdf_eval_pdf", "bsdf_eval_mueller",
           "bsdf_sample_mueller", "dispatch_sample_nested",
           "dispatch_eval_pdf_nested", "eval_null_transmission",
           "register_bsdf", "bsdf_flags", "common"]
