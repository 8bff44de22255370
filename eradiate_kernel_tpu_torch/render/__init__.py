"""Interaction records, geometry and ray intersection, textures."""
