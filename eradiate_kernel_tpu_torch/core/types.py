"""Variant configuration and device policy.

Counterpart of eradiate_kernel_tpu/core/types.py. The port carries the
``mono`` (1 channel, no wavelength sampling), ``rgb`` (3 sRGB channels)
and ``spectral`` (4 hero wavelengths a ray, ``N_HERO``) variants in
float32; the double-precision (slice 6d) and polarized (slice 6e) ones
raise.
"""

from __future__ import annotations

import dataclasses

import torch

_MODE_CHANNELS = {"mono": 1, "rgb": 3, "spectral": 4}


@dataclasses.dataclass(frozen=True)
class Variant:
    """Rendering mode in float32: 'mono' (1 radiance channel), 'rgb' (3
    sRGB radiance channels) or 'spectral' (4 hero wavelengths carried per
    ray, mitsuba.conf.template:139-142)."""

    mode: str = "rgb"
    polarized: bool = False

    def __post_init__(self):
        if self.mode.endswith("_double"):
            raise NotImplementedError(
                f"variant {self.mode!r}: double precision comes with "
                "slice 6d")
        if self.polarized:
            raise NotImplementedError(
                f"variant {self.mode!r} (polarized): comes with slice 6e")
        if self.mode not in _MODE_CHANNELS:
            raise ValueError(f"unknown mode {self.mode!r}")

    dtype = torch.float32

    @property
    def n_channels(self) -> int:
        return _MODE_CHANNELS[self.mode]

    @property
    def is_spectral(self) -> bool:
        return self.mode == "spectral"

    def channels(self, wavelengths) -> int:
        """The radiance channels of lanes carrying ``wavelengths`` (N, nw):
        nw hero wavelengths in spectral, the variant's channels otherwise
        (the reference's spec_channels)."""
        return wavelengths.shape[-1] if self.is_spectral else self.n_channels

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
