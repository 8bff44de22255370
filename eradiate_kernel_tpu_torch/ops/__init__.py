"""Acceleration structures and the ray/triangle intersection kernels."""
