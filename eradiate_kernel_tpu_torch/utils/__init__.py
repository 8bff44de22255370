"""Canned scenes and helpers (utils/ counterpart)."""
