"""The Scene: flat registries of tensors plus a hashable static config
(scene/scene.py counterpart).

A Scene's arrays have dotted names that follow the reference Scene's
attribute paths (``geo.tiles_v0``, ``bsdfs.rpv.rho_0``,
``sensor.to_world.m``, ...). ``Scene.arrays`` flattens a scene to numpy
under those names and ``from_numpy`` builds one from them, so a scene can
be carried over from the reference (or compared with it) leaf by leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.transform import Transform
from ..core.types import Variant, resolve_device
from ..render.geometry import Geometry

# what this slice of the port carries
SUPPORTED = {
    "bsdf_kinds": {"diffuse", "rpv"},
    "emitter_kinds": {"directional"},
    "texture_kinds": {"constant"},
    "spectrum_kinds": {"baked"},
    "sensor_kind": {"perspective"},
    "rfilter": {"box"},
    "sampler_kind": {"independent"},
}


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    kind: str = "path"
    max_depth: int = 8
    rr_depth: int = 5
    hide_emitters: bool = False
    extra: tuple = ()


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    variant: Variant
    bsdf_kinds: tuple
    emitter_kinds: tuple
    texture_kinds: tuple
    spectrum_kinds: tuple
    sensor_kind: str
    n_emitters: int
    env_emitter: int  # index of the environment emitter, -1 if none
    film_width: int
    film_height: int
    rfilter: str
    rfilter_params: tuple  # ((key, value), ...)
    integrator: IntegratorConfig
    spp: int
    sampler_kind: str = "independent"
    pixel_format: str = "rgb"
    crop_offset: tuple = (0, 0)
    crop_size: tuple = ()  # () = full film

    def __post_init__(self):
        for name, allowed in SUPPORTED.items():
            value = getattr(self, name)
            bad = [v for v in (value if isinstance(value, tuple)
                               else (value,)) if v not in allowed]
            if bad:
                raise NotImplementedError(
                    f"{name} {bad}: not carried by this slice of the port "
                    f"(it has {sorted(allowed)})")
        if self.integrator.kind != "path":
            raise NotImplementedError(
                f"integrator {self.integrator.kind!r}: this slice of the "
                "port carries only 'path'")


def bounding_sphere(points):
    """(center (3,) f32, radius) of the AABB-centered sphere around
    ``points`` (P, 3), as the reference builds it; (0, 1) for no points."""
    if len(points) == 0:
        return np.zeros(3, np.float32), 1.0
    center = 0.5 * (points.min(0) + points.max(0))
    return center, float(np.linalg.norm(points - center, axis=-1).max())


@dataclasses.dataclass(frozen=True)
class Scene:
    geo: Geometry
    shape_bsdf: torch.Tensor      # (n_shapes,) i32
    shape_emitter: torch.Tensor   # (n_shapes,) i32 (-1)
    bsdfs: dict                   # kind -> param -> tensor
    bsdf_kind: torch.Tensor
    bsdf_slot: torch.Tensor
    bsdf_flags: torch.Tensor
    emitters: dict
    emitter_kind: torch.Tensor
    emitter_slot: torch.Tensor
    textures: dict
    tex_kind: torch.Tensor
    tex_slot: torch.Tensor
    spectra: dict
    spec_kind: torch.Tensor
    spec_slot: torch.Tensor
    sensor: dict                  # to_world Transform, tan_half_fov
    bsphere_center: torch.Tensor  # (3,)
    bsphere_radius: torch.Tensor  # ()
    config: SceneConfig

    def arrays(self) -> dict:
        """Every array of the scene as numpy, by dotted name."""
        out = {}

        def walk(prefix, obj):
            if dataclasses.is_dataclass(obj):
                for f in dataclasses.fields(obj):
                    if f.name != "config":
                        walk(f"{prefix}{f.name}.", getattr(obj, f.name))
            elif isinstance(obj, dict):
                for k, v in obj.items():
                    walk(f"{prefix}{k}.", v)
            else:
                out[prefix[:-1]] = obj.detach().cpu().numpy()

        walk("", self)
        return out


def _tensor(a, device):
    a = np.array(a)  # a writable copy (reference arrays may be read-only)
    if a.dtype == np.uint32:  # bsdf flags fit in i32; torch's u32 is thin
        a = a.astype(np.int32)
    return torch.as_tensor(a, device=device)


def from_numpy(arrays: dict, config: SceneConfig, device=None) -> Scene:
    """Build a Scene on ``device`` (cuda by default) from numpy arrays named
    as ``Scene.arrays`` names them. Names the scene does not use are
    ignored, so the flattened leaves of a reference Scene are accepted."""
    device = resolve_device(device)
    tree = {}
    for name, a in arrays.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a

    def tensors(d):
        return {k: tensors(v) if isinstance(v, dict) else _tensor(v, device)
                for k, v in d.items()}

    def transform(d):
        return Transform(m=_tensor(d["m"], device),
                         inv_t=_tensor(d["inv_t"], device))

    g = tree["geo"]
    geo = Geometry(**{
        f.name: (transform(g[f.name]) if isinstance(g[f.name], dict)
                 else _tensor(g[f.name], device))
        for f in dataclasses.fields(Geometry)})
    registry = lambda name, kinds: {k: tensors(tree[name][k]) for k in kinds}
    top = lambda name: _tensor(tree[name], device)
    return Scene(
        geo=geo, shape_bsdf=top("shape_bsdf"),
        shape_emitter=top("shape_emitter"),
        bsdfs=registry("bsdfs", config.bsdf_kinds),
        bsdf_kind=top("bsdf_kind"), bsdf_slot=top("bsdf_slot"),
        bsdf_flags=top("bsdf_flags"),
        emitters=registry("emitters", config.emitter_kinds),
        emitter_kind=top("emitter_kind"), emitter_slot=top("emitter_slot"),
        textures=registry("textures", config.texture_kinds),
        tex_kind=top("tex_kind"), tex_slot=top("tex_slot"),
        spectra=registry("spectra", config.spectrum_kinds),
        spec_kind=top("spec_kind"), spec_slot=top("spec_slot"),
        sensor={"to_world": transform(tree["sensor"]["to_world"]),
                "tan_half_fov": _tensor(tree["sensor"]["tan_half_fov"],
                                        device)},
        bsphere_center=top("bsphere_center"),
        bsphere_radius=top("bsphere_radius"),
        config=config)
