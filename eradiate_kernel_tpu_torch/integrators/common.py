"""Shared integrator utilities (integrators/common.py counterpart)."""

from __future__ import annotations

import torch


def mis_weight(pdf_a, pdf_b):
    """Power heuristic, beta = 2 (path.cpp:223-227)."""
    pdf_a = pdf_a * pdf_a
    pdf_b = pdf_b * pdf_b
    return torch.where(pdf_a > 0,
                       pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-30), 0.0)


# host syncs of the volumetric integrator and the lane pool in this process
# (one per any_lane call); chip_smoke.py reads it
counters = {"host_syncs": 0}


def any_lane(mask):
    """Whether any lane of ``mask`` is set: the eager counterpart of the
    reference's ``lax.cond(jnp.any(mask), ...)`` predicates, one host sync
    each (counted)."""
    counters["host_syncs"] += 1
    return bool(mask.any())
