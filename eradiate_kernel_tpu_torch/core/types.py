"""Variant configuration and device policy.

Counterpart of eradiate_kernel_tpu/core/types.py. The port carries the
``mono`` (1 channel, no wavelength sampling), ``rgb`` (3 sRGB channels)
and ``spectral`` (4 hero wavelengths a ray, ``N_HERO``) variants, each in
float32 and in float64 (the ``_double`` suffix, mitsuba.conf.template
:57-63), unpolarized or polarized.
"""

from __future__ import annotations

import dataclasses

import torch

_MODE_CHANNELS = {"mono": 1, "rgb": 3, "spectral": 4}


@dataclasses.dataclass(frozen=True)
class Variant:
    """Rendering mode: 'mono' (1 radiance channel), 'rgb' (3 sRGB radiance
    channels) or 'spectral' (4 hero wavelengths carried per ray,
    mitsuba.conf.template:139-142), in ``dtype`` (float32 or float64).

    The precision suffix parses as in the reference: ``Variant("rgb_double")
    == Variant("rgb", dtype=torch.float64)``. A scene's floating tensors
    take the variant's dtype, and everything a render computes from them
    follows; the sampler's draws stay float32 in both (core/rng.py).

    ``polarized`` is stored and read nowhere, as in the reference: what
    carries polarization is the ``stokes`` integrator, whose Mueller
    transport (integrators/polarized.py, polarized_vol.py) runs in every
    variant."""

    mode: str = "rgb"
    dtype: torch.dtype = torch.float32
    polarized: bool = False

    def __post_init__(self):
        if self.mode.endswith("_double"):
            object.__setattr__(self, "mode", self.mode[:-len("_double")])
            object.__setattr__(self, "dtype", torch.float64)
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"variant dtype {self.dtype}: float32 or "
                             "float64")
        if self.mode not in _MODE_CHANNELS:
            raise ValueError(f"unknown mode {self.mode!r}")

    @property
    def is_double(self) -> bool:
        return self.dtype == torch.float64

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


DEFAULT_VARIANT = Variant("rgb")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (explicitly or by default) and the process has none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return device
