"""Texture evaluation (the rgb constant-texture part of render/texture.py).

In the rgb variant every spectrum bakes at scene build into a 'baked'
(n, 3) constant, and the slice's textures are all 'constant' (a spectrum
index), so a texture lookup is two table gathers.
"""

from __future__ import annotations


def texture_eval(scene, tex_index):
    """(..., 3) value of texture ``tex_index`` (i32 tensor) per lane."""
    spec = scene.textures["constant"]["spec"][scene.tex_slot[tex_index]]
    return scene.spectra["baked"]["value"][scene.spec_slot[spec]]
