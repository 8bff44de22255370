"""Scene construction: ``load_dict`` and ``from_numpy``."""

from .build import load_dict
from .scene import IntegratorConfig, Scene, SceneConfig, from_numpy

__all__ = ["IntegratorConfig", "Scene", "SceneConfig", "from_numpy",
           "load_dict"]
