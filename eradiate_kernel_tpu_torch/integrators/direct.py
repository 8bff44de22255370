"""One-bounce direct illumination with MIS (integrators/direct.py
counterpart; direct.cpp). Scan driver only, as in the reference."""

from __future__ import annotations

import torch

from .. import bsdfs, emitters
from ..bsdfs import common as bsdf_flags
from ..render.geometry import ray_intersect
from .common import mis_weight


def sample(scene, sampler, ray, active=None):
    """Incident radiance along ``ray`` (on the ``active`` lanes, default
    all) -> (spec (N, nc), valid, sampler)."""
    if active is None:
        active = torch.ones(ray.o.shape[0], dtype=torch.bool,
                            device=ray.o.device)
    si = ray_intersect(scene.geo, ray)
    valid = si.is_valid
    result = (emitters.eval_emitter_hit(scene, si, active)
              + emitters.eval_environment(scene, ray, ~si.is_valid, active))
    active = active & si.is_valid
    bsdf_idx = scene.shape_bsdf[torch.clamp(si.shape_index, min=0)]

    # emitter sampling
    sampler, s_pick = sampler.next_1d()
    sampler, s1 = sampler.next_1d()
    sampler, s2 = sampler.next_2d()
    ds, emitter_weight = emitters.sample_emitter_direction(
        scene, si, s_pick, s1, s2, active)
    bsdf_val, bsdf_pdf = bsdfs.bsdf_eval_pdf(scene, bsdf_idx, si,
                                             si.to_local(ds.d), active)
    mis_pdf = torch.where(ds.delta, 0.0, bsdf_pdf)
    mis = torch.where(ds.pdf > 0, mis_weight(ds.pdf, mis_pdf), 0.0)
    result = result + torch.where(active[:, None],
                                  mis[:, None] * bsdf_val * emitter_weight,
                                  0.0)

    # bsdf sampling
    sampler, sb1 = sampler.next_1d()
    sampler, sb2 = sampler.next_2d()
    bs, bsdf_weight = bsdfs.bsdf_sample(scene, bsdf_idx, si, sb1, sb2, active)
    ray2 = si.spawn_ray(si.to_world(bs.wo))
    si2 = ray_intersect(scene.geo, ray2)
    emit = (emitters.eval_emitter_hit(scene, si2, active)
            + emitters.eval_environment(scene, ray2, ~si2.is_valid, active))
    delta_lobe = (bs.sampled_type & bsdf_flags.Delta) != 0
    em_pdf = emitters.pdf_emitter_direction(scene, si.p, si2, ~si2.is_valid,
                                            active & ~delta_lobe, d=ray2.d)
    em_pdf = torch.where(delta_lobe, 0.0, em_pdf)
    mis2 = mis_weight(bs.pdf, em_pdf)
    result = result + torch.where(active[:, None],
                                  mis2[:, None] * bsdf_weight * emit, 0.0)
    return result, valid, sampler
