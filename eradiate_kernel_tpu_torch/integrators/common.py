"""Shared integrator utilities (integrators/common.py counterpart)."""

from __future__ import annotations

import torch


def mis_weight(pdf_a, pdf_b):
    """Power heuristic, beta = 2 (path.cpp:223-227)."""
    pdf_a = pdf_a * pdf_a
    pdf_b = pdf_b * pdf_b
    return torch.where(pdf_a > 0,
                       pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-30), 0.0)
