"""Variant configuration and device policy.

Counterpart of eradiate_kernel_tpu/core/types.py. The port carries the
``mono`` (1 channel, no wavelength sampling) and ``rgb`` (3 sRGB channels)
variants in float32; the spectral, double-precision and polarized ones
raise.
"""

from __future__ import annotations

import dataclasses

import torch

_MODE_CHANNELS = {"mono": 1, "rgb": 3}


@dataclasses.dataclass(frozen=True)
class Variant:
    """Rendering mode in float32: 'mono' (1 radiance channel) or 'rgb'
    (3 sRGB radiance channels)."""

    mode: str = "rgb"
    polarized: bool = False

    def __post_init__(self):
        if self.mode not in _MODE_CHANNELS or self.polarized:
            raise NotImplementedError(
                f"variant {self.mode!r}"
                f"{' (polarized)' if self.polarized else ''}: the port "
                "carries 'mono' and 'rgb' in float32; spectral, double "
                "precision and polarized variants come with slice 6")

    dtype = torch.float32

    @property
    def n_channels(self) -> int:
        return _MODE_CHANNELS[self.mode]

    @property
    def is_monochromatic(self) -> bool:
        return self.mode == "mono"


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (explicitly or by default) and the process has none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return device
