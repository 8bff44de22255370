"""Core types, RNG, math, frames, warps, transforms, rays and color."""
