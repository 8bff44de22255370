"""Scene parameters by name (utils/params.py counterpart; the reference's
``traverse`` and ParameterMap).

A Scene's tensors have dotted names (``Scene.tensors``), the reference's
names for the same scene: ``volumes.gridvolume.grid``,
``spectra.baked.value``, ... A ParameterMap holds a value per name and a
trainable subset; ``with_trainable`` builds the scene with new values for
that subset (sharing every other tensor, rebuilding the gridvolume's
packed corner table from a new grid), which is what a gradient is taken
through:

    pm = traverse(scene).keep(["volumes.gridvolume.grid"])
    params = pm.trainable()          # leaf tensors that require grad
    img = autodiff.render(pm, params, regen=True)
    img.mean().backward()            # params[k].grad
"""

from __future__ import annotations

import torch


class ParameterMap:
    """Dict-like view of a Scene's tensors by dotted name."""

    def __init__(self, scene, keys=None):
        self._scene = scene
        self._base = scene.tensors()
        self._values = dict(self._base)
        self._kept = set(keys) if keys is not None else set(self._values)

    def keys(self):
        return [k for k in self._values if k in self._kept]

    def items(self):
        return [(k, self._values[k]) for k in self.keys()]

    def __contains__(self, key):
        return key in self._values

    def __getitem__(self, key):
        return self._values[key]

    def __setitem__(self, key, value):
        old = self._values[key]
        self._values[key] = torch.as_tensor(
            value, dtype=old.dtype, device=old.device).reshape(old.shape)

    def keep(self, keys):
        """Restrict the trainable set to ``keys`` (a list of names, or a
        string: every name containing it)."""
        if isinstance(keys, str):
            keys = [k for k in self._values if keys in k]
        missing = [k for k in keys if k not in self._values]
        if missing:
            raise KeyError(f"unknown parameter(s): {missing}; "
                           f"available: {list(self._values)[:20]}...")
        self._kept = set(keys)
        return self

    def scene(self):
        """The Scene with the map's current values."""
        return self.with_trainable({})

    def trainable(self):
        """The kept subset as a dict of fresh leaf tensors that require a
        gradient (copies of the map's values)."""
        return {k: v.detach().clone().requires_grad_(v.is_floating_point())
                for k, v in self.items()}

    def with_trainable(self, values: dict):
        """The Scene with the map's values and ``values`` (name -> tensor)
        in place of theirs; a new gridvolume grid rebuilds the packed corner
        table. The tensors are used as given, so a gradient reaches them."""
        merged = dict(self._values)
        merged.update(values)
        return self._scene.with_tensors(
            {k: v for k, v in merged.items() if v is not self._base[k]})


def traverse(scene) -> ParameterMap:
    return ParameterMap(scene)
