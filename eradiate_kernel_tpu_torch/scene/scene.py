"""The Scene: flat registries of tensors plus a hashable static config
(scene/scene.py counterpart).

A Scene's arrays have dotted names that follow the reference Scene's
attribute paths (``geo.tiles_v0``, ``bsdfs.rpv.rho_0``,
``sensor.to_world.m``, ...). ``Scene.arrays`` flattens a scene to numpy
under those names and ``from_numpy`` builds one from them, so a scene can
be carried over from the reference (or compared with it) leaf by leaf.
``Scene.tensors`` gives the same leaves as tensors and
``Scene.with_tensors`` builds a scene with some of them replaced (the
ParameterMap and the path-replay backward build scenes that way).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bsdfs import REGISTRY as BSDF_REGISTRY
from ..core.rng import SAMPLER_KINDS
from ..core.transform import AnimatedTransform, Transform
from ..core.types import Variant, resolve_device
from ..render.geometry import Geometry
from ..textures.volumes import packed_corners_of, spectral_packed_of

# what the port carries: the built-in kinds (the kinds registered by a
# user's register_bsdf, register_emitter, register_phasefunction and
# register_integrator join them, _registered)
SUPPORTED = {
    "bsdf_kinds": set(BSDF_REGISTRY),
    "emitter_kinds": {"directional", "area", "constant", "point", "spot",
                      "projector", "envmap"},
    "texture_kinds": {"constant", "checkerboard", "bitmap",
                      "mesh_attribute"},
    "spectrum_kinds": {"baked", "uniform", "regular", "irregular", "srgb",
                       "blackbody", "d65", "srgb_d65", "discrete"},
    "sensor_kind": {"perspective", "thinlens", "radiancemeter",
                    "mradiancemeter", "distant", "mdistant", "distantflux",
                    "irradiancemeter"},
    "rfilter": {"box", "tent", "gaussian", "mitchell", "catmullrom",
                "lanczos"},
    "sampler_kind": set(SAMPLER_KINDS),
    "medium_kinds": {"homogeneous", "heterogeneous"},
    "phase_kinds": {"isotropic", "hg", "rayleigh", "tabphase",
                    "blendphase"},
    "volume_kinds": {"constvolume", "gridvolume", "gridvolume_nearest",
                     "gridvolume_srgb", "gridvolume_spectral"},
}
INTEGRATORS = ("path", "direct", "depth", "volpath", "volpathmis", "aov",
               "moment", "bins", "nbins", "stokes")
# volpath's transmittance estimators and free-flight majorants, the default
# first
NEE_MODES = {"nee_transmittance": ("residual", "track", "quadrature"),
             "ff_majorant": ("profile", "segment")}


def _registered(name):
    """The kinds of config field ``name`` that users registered."""
    if name == "bsdf_kinds":
        return set(BSDF_REGISTRY)
    if name == "emitter_kinds":
        from ..emitters import CUSTOM
        return set(CUSTOM)
    if name == "phase_kinds":
        from ..phase import CUSTOM
        return set(CUSTOM)
    if name == "integrator":
        from ..integrators import REGISTRY
        return set(REGISTRY)
    return set()


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
    medium_kinds: tuple = ()
    phase_kinds: tuple = ()
    volume_kinds: tuple = ()
    sensor_medium: int = -1  # medium the sensor is embedded in
    # the sensor's static choices, sorted (key, value) pairs: distant's
    # direction_mode and flip_directions, the target_mode of the distant
    # sensors
    sensor_static: tuple = ()
    # every heterogeneous medium is a vertical profile sigma(z): its
    # optical depth has a closed form (media.medium_tau_segment)
    het_profile1d: bool = False
    # per-slot table sizes of data-driven BSDFs (the measured BSDF):
    # ((kind, (slot 0's, slot 1's, ...)), ...)
    bsdf_static: tuple = ()

    def __post_init__(self):
        for name, allowed in SUPPORTED.items():
            allowed = allowed | _registered(name)
            value = getattr(self, name)
            bad = [v for v in (value if isinstance(value, tuple)
                               else (value,)) if v not in allowed]
            if bad:
                raise NotImplementedError(
                    f"{name} {bad}: the port carries {sorted(allowed)}")
        kind = self.integrator.kind
        if kind not in set(INTEGRATORS) | _registered("integrator"):
            raise NotImplementedError(
                f"integrator {kind!r}: the port carries {INTEGRATORS} and "
                "the registered integrators")
        if kind in ("bins", "nbins") and not self.variant.is_spectral:
            raise NotImplementedError(
                f"integrator {kind!r} runs in the spectral variant only, as "
                "in the reference (bins.cpp throws elsewhere; the port "
                "carries it there since slice 6c-1)")
        extra = dict(self.integrator.extra)
        for key, allowed in NEE_MODES.items():
            if extra.get(key, allowed[0]) not in allowed:
                raise ValueError(f"{key} {extra[key]!r}: one of {allowed}")


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
    shape_interior: torch.Tensor  # (n_shapes,) i32 medium (-1)
    shape_exterior: torch.Tensor  # (n_shapes,) i32 medium (-1)
    shape_prim_slot: torch.Tensor  # (n_shapes,) i32 row in its family pool
    shape_area: torch.Tensor      # (n_shapes,) surface area
    shape_face_offset: torch.Tensor  # (n_shapes,) i32 first face (meshes)
    shape_face_count: torch.Tensor   # (n_shapes,) i32
    face_area_cumsum: torch.Tensor   # (F,) strictly increasing
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
    media: dict
    medium_kind: torch.Tensor
    medium_slot: torch.Tensor
    medium_phase: torch.Tensor    # (n_media,) i32 phase index per medium
    phases: dict
    phase_kind: torch.Tensor
    phase_slot: torch.Tensor
    volumes: dict
    vol_kind: torch.Tensor
    vol_slot: torch.Tensor
    bitmap_data: torch.Tensor     # (n, H, W, 3) images of bitmap textures
    bitmap_coeff: torch.Tensor    # (n, H, W, 3) their rgb2spec fits
    bitmap_scale: torch.Tensor    # (n, H, W) (spectral; else 1-texel)
    mesh_attr_data: torch.Tensor  # (A, V, 3) per-vertex mesh attributes
    sensor: dict                  # the sensor's params (build_sensors)
    bsphere_center: torch.Tensor  # (3,)
    bsphere_radius: torch.Tensor  # ()
    config: SceneConfig
    # the gridvolume rows' packed 8-corner table (textures.volumes.
    # packed_corners), built once at load for grids on the gather path;
    # derived from volumes.gridvolume.grid, so not one of arrays()
    vol_packed: torch.Tensor | None = None
    # the same for the spectral grids on the gather path: {kind: table} of
    # gridvolume_srgb (always) and gridvolume_spectral (above
    # EINSUM_MAX_VOXELS)
    vol_packed_spectral: dict = dataclasses.field(default_factory=dict)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def arrays(self) -> dict:
        """Every array of the scene as numpy, by dotted name."""
        return {k: v.detach().cpu().numpy()
                for k, v in self.tensors().items()}

    def tensors(self) -> dict:
        """Every tensor of the scene by dotted name (the names of arrays();
        the derived vol_packed is not one of them)."""
        out = {}

        def walk(prefix, obj):
            if dataclasses.is_dataclass(obj):
                for f in _fields(obj):
                    walk(f"{prefix}{f.name}.", getattr(obj, f.name))
            elif isinstance(obj, dict):
                for k, v in obj.items():
                    walk(f"{prefix}{k}.", v)
            else:
                out[prefix[:-1]] = obj

        walk("", self)
        return out

    def with_tensors(self, values: dict) -> "Scene":
        """The scene with the tensors named in ``values`` (dotted names of
        tensors()) replaced, the others shared; a subtree with no new
        tensor is kept as it is (a Geometry is rebuilt only if one of its
        tensors is new). A new gridvolume grid comes with its own packed
        corner table vol_packed (built with autograd off: the grid's
        gradient comes through volumes.GridTrilinear)."""
        unknown = set(values) - set(self.tensors())
        if unknown:
            raise KeyError(f"not tensors of the scene: {sorted(unknown)}")

        def build(prefix, obj):
            if dataclasses.is_dataclass(obj):
                new = {f.name: build(f"{prefix}{f.name}.",
                                     getattr(obj, f.name))
                       for f in _fields(obj)}
                new = {k: v for k, v in new.items()
                       if v is not getattr(obj, k)}
                return dataclasses.replace(obj, **new) if new else obj
            if isinstance(obj, dict):
                new = {k: build(f"{prefix}{k}.", v) for k, v in obj.items()}
                same = all(new[k] is obj[k] for k in obj)
                return obj if same else new
            return values.get(prefix[:-1], obj)

        scene = build("", self)
        if "volumes.gridvolume.grid" in values:
            scene = dataclasses.replace(
                scene, vol_packed=packed_corners_of(scene.volumes))
        if any(k.startswith(("volumes.gridvolume_srgb.",
                             "volumes.gridvolume_spectral."))
               for k in values):
            scene = dataclasses.replace(
                scene, vol_packed_spectral=spectral_packed_of(scene.volumes))
        return scene


def _fields(obj):
    """The fields of a scene record that hold tensors (a Scene's config and
    its derived packed tables do not)."""
    return [f for f in dataclasses.fields(obj)
            if f.name not in ("config", "vol_packed",
                              "vol_packed_spectral")]


def _tensor(a, device, double=False):
    """A tensor copy of array ``a`` on ``device``; ``double`` widens a
    floating array to float64 (the reference builds every scene in float32
    and widens its floating leaves to the variant's dtype, scene/build.py
    :1081-1095, so a double scene holds float32-rounded values)."""
    a = np.array(a)  # a writable copy (reference arrays may be read-only)
    if a.dtype == np.uint32:  # bsdf flags fit in i32; torch's u32 is thin
        a = a.astype(np.int32)
    elif double and np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float64)
    return torch.as_tensor(a, device=device)


def from_numpy(arrays: dict, config: SceneConfig, device=None) -> Scene:
    """Build a Scene on ``device`` (cuda by default) from numpy arrays named
    as ``Scene.arrays`` names them. Names the scene does not use are
    ignored, so the flattened leaves of a reference Scene are accepted.
    A double variant's scene holds its floating arrays in float64."""
    device = resolve_device(device)
    double = config.variant.is_double
    tree = {}
    for name, a in arrays.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a

    def tensors(d):
        return {k: tensors(v) if isinstance(v, dict)
                else _tensor(v, device, double) for k, v in d.items()}

    def transform(d):
        return Transform(m=_tensor(d["m"], device, double),
                         inv_t=_tensor(d["inv_t"], device, double))

    def sensor_param(name, v):
        if name == "to_world_anim":
            return AnimatedTransform(**{k: _tensor(a, device, double)
                                        for k, a in v.items()})
        return (transform(v) if isinstance(v, dict)
                else _tensor(v, device, double))

    g = tree["geo"]
    geo = Geometry(**{
        f.name: (transform(g[f.name]) if isinstance(g[f.name], dict)
                 else _tensor(g[f.name], device, double))
        for f in dataclasses.fields(Geometry)})
    registry = lambda name, kinds: {k: tensors(tree[name][k]) for k in kinds}
    top = lambda name: _tensor(tree[name], device, double)
    volumes = registry("volumes", config.volume_kinds)
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
        shape_interior=top("shape_interior"),
        shape_exterior=top("shape_exterior"),
        shape_prim_slot=top("shape_prim_slot"),
        shape_area=top("shape_area"),
        shape_face_offset=top("shape_face_offset"),
        shape_face_count=top("shape_face_count"),
        face_area_cumsum=top("face_area_cumsum"),
        media=registry("media", config.medium_kinds),
        medium_kind=top("medium_kind"), medium_slot=top("medium_slot"),
        medium_phase=top("medium_phase"),
        phases=registry("phases", config.phase_kinds),
        phase_kind=top("phase_kind"), phase_slot=top("phase_slot"),
        volumes=volumes,
        vol_kind=top("vol_kind"), vol_slot=top("vol_slot"),
        vol_packed=packed_corners_of(volumes),
        vol_packed_spectral=spectral_packed_of(volumes),
        bitmap_data=top("bitmap_data"), bitmap_coeff=top("bitmap_coeff"),
        bitmap_scale=top("bitmap_scale"),
        mesh_attr_data=top("mesh_attr_data"),
        sensor={k: sensor_param(k, v) for k, v in tree["sensor"].items()},
        bsphere_center=top("bsphere_center"),
        bsphere_radius=top("bsphere_radius"),
        config=config)
