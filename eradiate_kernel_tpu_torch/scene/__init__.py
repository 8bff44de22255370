"""Scene construction: ``load_dict``, ``from_numpy`` and the Mitsuba-XML
loaders ``load_file`` and ``load_string``."""

from .build import load_dict
from .scene import IntegratorConfig, Scene, SceneConfig, from_numpy
from .xml import load_file, load_string

__all__ = ["IntegratorConfig", "Scene", "SceneConfig", "from_numpy",
           "load_dict", "load_file", "load_string"]
