"""Variant configuration and device policy.

Counterpart of eradiate_kernel_tpu/core/types.py. The port so far carries
only the ``rgb`` variant in float32; the other modes raise.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Variant:
    """Rendering mode: 3 sRGB radiance channels, float32."""

    mode: str = "rgb"

    def __post_init__(self):
        if self.mode != "rgb":
            raise NotImplementedError(
                f"variant {self.mode!r}: the port carries only 'rgb' so far")

    n_channels = 3
    dtype = torch.float32


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (explicitly or by default) and the process has none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return device
