"""Shared integrator utilities (integrators/common.py counterpart)."""

from __future__ import annotations

import torch

from ..core.spectrum import srgb_to_xyz


def mis_weight(pdf_a, pdf_b):
    """Power heuristic, beta = 2 (path.cpp:223-227)."""
    pdf_a = pdf_a * pdf_a
    pdf_b = pdf_b * pdf_b
    return torch.where(pdf_a > 0,
                       pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-30), 0.0)


def spec_to_xyz(spec):
    """The film's X, Y, Z of splatted values: rgb (N, 3) converts to XYZ,
    mono (N, 1) repeats into all three (the reference's layout)."""
    return spec.expand(-1, 3) if spec.shape[1] == 1 else srgb_to_xyz(spec)


# host syncs in this process: ``host_syncs`` the integrators' any_lane
# gates (one a call), ``pool_syncs`` the lane pool's own (its dead-lane
# count and refill nonzero); chip_smoke.py reads both
counters = {"host_syncs": 0, "pool_syncs": 0}


def any_lane(mask):
    """Whether any lane of ``mask`` is set: the eager counterpart of the
    reference's ``lax.cond(jnp.any(mask), ...)`` predicates, one host sync
    each (counted)."""
    counters["host_syncs"] += 1
    return bool(mask.any())
