"""Volume textures (textures/ counterpart)."""
