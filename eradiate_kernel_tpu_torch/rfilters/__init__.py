"""Reconstruction filters (rfilters/__init__.py counterpart): the box."""

from __future__ import annotations

DEFAULTS = {"box": {"radius": 0.5}}


def filter_radius(kind: str, params=None) -> float:
    if kind not in DEFAULTS:
        raise NotImplementedError(
            f"rfilter {kind!r}: the port carries only 'box' so far")
    return {**DEFAULTS[kind], **(params or {})}["radius"]
