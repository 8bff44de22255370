"""Dict-based scene construction: ``load_dict`` (scene/build.py counterpart).

Construction is host-side numpy in the reference's order (so every
registry index and array equals the reference's); ``finalize`` returns the
scene's arrays by dotted name plus its config, and ``from_numpy`` moves
them onto the device in one step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bsdfs import REGISTRY as BSDF_REGISTRY
from ..core.spectrum import blackbody_radiance, luminance
from ..core.transform import AnimatedTransform, Transform, as_transform
from ..core.types import Variant, resolve_device
from ..ops.accel import TILE_K, pack_tiles
from ..ops.bvh import build_tile_bvh, collapse_to_bvh8
from ..render.geometry import (FAMILY_CONE, FAMILY_CYLINDER, FAMILY_DISK,
                               FAMILY_IMESH, FAMILY_MESH, FAMILY_RECT,
                               FAMILY_SPHERE)
from ..render.texture import d65_approx
from ..utils.rgb2spec import fit_srgb_coeff, fit_srgb_coeff_batch
from ..utils.volfile import read_vol
from .build_emitters import (_EMITTER_SCENE_TYPES, _build_bsdf,
                             _build_scene_emitter)
from .build_sensors import _SENSOR_TYPES, _build_sensor
from .build_shapes import (_SHAPE_TYPES, _build_shape, shape_children,
                           triangle_areas)
from .build_spectra import (_axis_majorant_profiles, _cie_rgb_of_spectrum,
                            _control_and_residual_profiles, _image_data,
                            _spectrum_sampling_table)
from .scene import (IntegratorConfig, Scene, SceneConfig, bounding_sphere,
                    from_numpy)

_MEDIUM_TYPES = ("homogeneous", "heterogeneous")
_INTEGRATOR_TYPES = ("path", "direct", "depth", "volpath", "volpathmis",
                     "aov", "moment", "bins", "nbins", "stokes")
# the wrappers: their child integrator's settings are the config's
_WRAPPER_TYPES = ("aov", "moment", "bins", "nbins", "stokes")
# the integrator's extra properties load_dict keeps (the reference's, and
# replay_lanes: the lane count of the path-replay adjoint, which the
# reference reads from the extras but its load_dict drops); a wrapper adds
# ("child", kind) and its own "aovs"
_INTEGRATOR_EXTRAS = ("max_iterations", "nee_steps", "nee_transmittance",
                      "nee_quad_points", "ff_majorant", "replay_lanes")
_WRAP_CODES = {"clamp": 0, "repeat": 1, "mirror": 2}


def _integrator_config(kind, val):
    """The IntegratorConfig of an integrator entry. A wrapper (aov,
    moment, bins, nbins, stokes) takes its nested child integrator's
    settings (the first dict entry whose type is an integrator; none: path
    with the defaults) and adds ("child", its kind) and its "aovs", "bins"
    and "tolerance" to the extras (reference scene/build.py:1036-1060)."""
    props, extra = val, []
    if kind in _WRAPPER_TYPES:
        children = [v for v in val.values() if isinstance(v, dict)
                    and v.get("type") in _INTEGRATOR_TYPES
                    and v["type"] not in _WRAPPER_TYPES]
        props = children[0] if children else {}
        extra.append(("child", props.get("type", "path")))
        extra += [(k, val[k]) for k in ("aovs", "bins", "tolerance")
                  if k in val]
    extra += [(k, v) for k, v in props.items() if k in _INTEGRATOR_EXTRAS]
    return IntegratorConfig(
        kind=kind, max_depth=int(props.get("max_depth", 8)),
        rr_depth=int(props.get("rr_depth", 5)),
        hide_emitters=bool(props.get("hide_emitters", False)),
        extra=tuple(sorted(extra)))


class SceneBuilder:
    def __init__(self, variant: Variant):
        self.variant = variant
        self.nc = variant.n_channels
        self.spectra = {}       # kind -> list of row dicts
        self.textures = {}
        self.bsdf_rows = {}
        self.emitter_rows = {}
        self.spec_table = []    # (kind, slot)
        self.tex_table = []
        self.bsdf_table = []
        self.bsdf_static = {}   # kind -> per-slot hashable table sizes
        self.bsdf_flag_list = []
        self.emitter_table = []
        self.media_rows = {}
        self.phase_rows = {}
        self.volume_rows = {}
        self.medium_table = []
        self.phase_table = []
        self.volume_table = []
        self.medium_phase_list = []
        self.sensor_medium = -1  # medium the sensor is embedded in
        self.sensor_static = ()  # the sensor's hashable build-time fields
        self.named = {}
        self.bitmaps = []           # (H, W, 3) f32 images of bitmap textures
        self.mesh_attr_names = []   # attribute name per slot
        self.mesh_attr_chunks = {}  # name -> list of (v_offset, (V_i, C))
        self.vertices = []
        self.normals = []
        self.uvs = []
        self.faces = []
        self.face_shape = []
        self.face_areas = []    # per mesh: (F,) f64 triangle areas
        self.spheres = []       # (center, radius, flip)
        self.rects = []
        self.disks = []
        self.cyls = []          # (to_world, length, radius)
        self.cones = []         # (to_world, length, radius)
        self.shape_rows = []
        self.env_emitter = -1   # emitter index of the environment
        # two-level instancing: shared group-local mesh pools + instances
        self.ig_vertices = []
        self.ig_normals = []
        self.ig_uvs = []
        self.ig_faces = []
        self.ig_face_sub = []
        self.group_records = {}   # key -> dict(f_off, f_count, subs, lo, hi)
        self.instances = []       # dicts(l2w, w2l, f_off, f_count,
        #                           shape_base, lo, hi)

    # --- registries ------------------------------------------------------------
    def _add(self, rows_dict, table, kind, row):
        rows = rows_dict.setdefault(kind, [])
        table.append((kind, len(rows)))
        rows.append(row)
        return len(table) - 1

    def add_bsdf_row(self, kind, row, flags):
        # a row's "_static" (table resolutions) goes to the config's
        # bsdf_static, not to the arrays
        static = row.pop("_static", None)
        if static is not None:
            self.bsdf_static.setdefault(kind, []).append(static)
        self.bsdf_flag_list.append(flags)
        return self._add(self.bsdf_rows, self.bsdf_table, kind, row)

    def add_emitter_row(self, kind, row):
        return self._add(self.emitter_rows, self.emitter_table, kind, row)

    def add_medium_row(self, kind, row, phase_idx):
        self.medium_phase_list.append(phase_idx)
        return self._add(self.media_rows, self.medium_table, kind, row)

    def add_phase_row(self, kind, row):
        return self._add(self.phase_rows, self.phase_table, kind, row)

    def add_volume_row(self, kind, row):
        return self._add(self.volume_rows, self.volume_table, kind, row)

    # --- phase functions, volumes and media -----------------------------------
    def phase(self, d):
        t = (d or {"type": "isotropic"})["type"]
        if t in ("isotropic", "rayleigh"):
            return self.add_phase_row(t, {"_pad": np.float32(0)})
        if t == "hg":
            return self.add_phase_row("hg", {"g": np.float32(d.get("g", 0.8))})
        if t == "blendphase":
            children = [v for v in d.values()
                        if isinstance(v, dict) and "type" in v]
            if len(children) != 2:
                raise ValueError("blendphase needs two nested phases")
            p0 = self.phase(children[0])
            p1 = self.phase(children[1])
            return self.add_phase_row("blendphase", {
                "weight": np.float32(d.get("weight", 0.5)),
                "phase0": np.int32(p0), "phase1": np.int32(p1)})
        if t == "tabphase":
            # the table in float64, stored as float32
            values = np.asarray(d["values"], np.float64)
            nodes = np.asarray(d.get("nodes", np.linspace(-1, 1, len(values))),
                               np.float64)
            cdf = np.cumsum(0.5 * (values[1:] + values[:-1]) * np.diff(nodes))
            return self.add_phase_row("tabphase", {
                "nodes": nodes.astype(np.float32),
                "values": values.astype(np.float32),
                "cdf": cdf.astype(np.float32),
                "integral": np.float32(cdf[-1]),
                "count": np.int32(len(values))})
        from ..phase import CUSTOM
        if t in CUSTOM:
            return self.add_phase_row(t, CUSTOM[t].build(d, self))
        raise ValueError(f"unknown phase type {t!r}: register it with "
                         "phase.register_phasefunction")

    def volume(self, v):
        """A number, a list or a volume dict -> volume index."""
        if isinstance(v, (int, float)):
            return self.add_volume_row("constvolume", {
                "value": np.asarray([float(v)], np.float32)})
        if isinstance(v, (list, tuple, np.ndarray)):
            return self.add_volume_row("constvolume", {
                "value": np.asarray(v, np.float32)})
        t = v["type"]
        if t == "constvolume":
            val = np.atleast_1d(np.asarray(v.get("value", 1.0), np.float32))
            return self.add_volume_row("constvolume", {"value": val})
        if t == "gridvolume_spectral":
            # a wavelength-indexed grid (gridvolume_spectral.cpp): data
            # (D, H, W, S) sampled at S wavelengths over [lambda_min,
            # lambda_max]
            data = (np.asarray(v["data"], np.float32) if "data" in v
                    else read_vol(v["filename"])[0])
            if data.ndim != 4:
                raise ValueError("gridvolume_spectral wants (D, H, W, S)")
            w2l = as_transform(v.get("to_world")).inverse()
            return self.add_volume_row("gridvolume_spectral", {
                "grid": data,
                "wl_lo": np.float32(v.get("lambda_min", 360.0)),
                "wl_hi": np.float32(v.get("lambda_max", 830.0)),
                "w2l_m": np.asarray(w2l.m, np.float32),
                "w2l_it": np.asarray(w2l.inv_t, np.float32),
                "vmax": np.float32(data.max())})
        if t != "gridvolume":
            raise ValueError(f"unknown volume type {t!r}")
        data, w2l = self._grid_data(v)
        wrap = v.get("wrap_mode", "clamp")
        if wrap not in _WRAP_CODES:
            raise ValueError(f'invalid wrap mode "{wrap}", must be one of: '
                             '"repeat", "mirror", or "clamp"')
        if data.shape[-1] not in (1, 3):
            raise ValueError(f"gridvolume wants 1 or 3 channels, got "
                             f"{data.shape[-1]}")
        filt = v.get("filter_type", "trilinear")
        if filt not in ("trilinear", "nearest"):
            raise ValueError(f"gridvolume filter_type {filt!r}: 'trilinear' "
                             "or 'nearest'")
        grid, vmax = self._maybe_srgb_pack(data, v)
        # nearest filtering (grid3d.cpp FilterType::Nearest) is a kind of
        # its own, so trilinear grids never pay for its branch; a packed
        # trilinear grid is 'gridvolume_srgb' (a nearest one is marked by
        # its 4 channels)
        if filt == "nearest":
            kind = "gridvolume_nearest"
        else:
            kind = "gridvolume_srgb" if grid.shape[-1] == 4 else "gridvolume"
        return self.add_volume_row(kind, {
            "wrap": np.int32(_WRAP_CODES[wrap]),
            "w2l_m": np.asarray(w2l.m, np.float32),
            "w2l_it": np.asarray(w2l.inv_t, np.float32),
            "grid": grid, "vmax": np.float32(vmax)})

    def _maybe_srgb_pack(self, data, v):
        """The spectral variant's rgb grids (grid3d.cpp:69-89): each voxel
        becomes [rgb2spec coeff (3), scale] with scale = 2 max(rgb); the
        grid's max (the majorant's source) is the max scale, since the
        sigmoid is below 1. ``raw=True`` keeps the rgb data. Returns (grid,
        vmax)."""
        if (self.variant.is_spectral and data.shape[-1] == 3
                and not v.get("raw", False)):
            scale = np.maximum(2.0 * data.max(-1), 1e-8)  # (D, H, W)
            coeff = fit_srgb_coeff_batch(
                (data / scale[..., None]).reshape(-1, 3)
            ).reshape(data.shape).astype(np.float32)
            packed = np.concatenate(
                [coeff, scale[..., None].astype(np.float32)], axis=-1)
            return packed, float(scale.max())
        return data, float(data.max())

    def _grid_data(self, v):
        """Grid data (D, H, W, C) from inline ``data`` or a ``.vol``
        ``filename`` (volume_data.h:44-104), and its world_to_local. With
        ``use_grid_bbox`` the file's bbox -> unit-cube transform
        premultiplies world_to_local (grid3d.cpp:152-154)."""
        bbox = None
        if "data" in v:
            data = np.asarray(v["data"], np.float32)
        else:
            data, bbox = read_vol(v["filename"])
        if data.ndim == 3:
            data = data[..., None]
        w2l = as_transform(v.get("to_world")).inverse()
        if v.get("use_grid_bbox", False) and bbox is not None:
            lo, hi = bbox
            w2l = (Transform.scale(1.0 / np.maximum(hi - lo, 1e-20))
                   @ Transform.translate(-lo)) @ w2l
        return data, w2l

    def medium(self, d):
        """A medium dict (or a ref to a named one) -> medium index."""
        if d is None:
            return -1
        if d.get("type") == "ref":
            kind, idx = self.named[d["id"]]
            if kind != "medium":
                raise ValueError(f"ref {d['id']!r} names a {kind}")
            return idx
        t = d["type"]
        if t not in _MEDIUM_TYPES:
            raise NotImplementedError(f"medium {t!r}: the port carries "
                                      f"{_MEDIUM_TYPES}")
        phase_idx = self.phase(d.get("phase"))
        if t == "homogeneous":
            return self.add_medium_row("homogeneous", {
                "sigma_t": np.int32(self.spectrum(d.get("sigma_t", 1.0))),
                "albedo": np.int32(self.spectrum(d.get("albedo", 0.75))),
                "scale": np.float32(d.get("scale", 1.0))}, phase_idx)
        st_vol = self.volume(d.get("sigma_t", 1.0))
        al_vol = self.volume(d.get("albedo", 0.75))
        scale = float(d.get("scale", 1.0))
        # majorant = scale * max sigma_t (heterogeneous.cpp:29)
        kind, slot = self.volume_table[st_vol]
        rows = self.volume_rows[kind][slot]
        vmax = (float(rows["vmax"]) if "vmax" in rows
                else float(np.max(rows["value"])))
        # bounds: the sigma_t grid's unit cube; a constvolume's own to_world
        if kind != "constvolume":
            w2l_m, w2l_it = rows["w2l_m"], rows["w2l_it"]
        else:
            w2l = as_transform(d.get("to_world")).inverse()
            w2l_m = np.asarray(w2l.m, np.float32)
            w2l_it = np.asarray(w2l.inv_t, np.float32)
        # plane-parallel: a 1-channel clamp grid constant over (y, x) is a
        # vertical profile sigma(z) with a closed-form optical depth
        zok = False
        zprof = np.zeros(1, np.float32)
        if (kind == "gridvolume" and int(rows["wrap"]) == 0
                and rows["grid"].shape[-1] == 1
                and np.array_equal(rows["grid"], np.broadcast_to(
                    rows["grid"][:, :1, :1], rows["grid"].shape))):
            zok = True
            zprof = rows["grid"][:, 0, 0, 0].astype(np.float32)
        D = len(zprof)
        if D > 1:
            dz = 1.0 / (D - 1)
            zcum = np.concatenate(
                [[0.0], np.cumsum(0.5 * (zprof[:-1] + zprof[1:]) * dz)]
            ).astype(np.float32)
        else:
            zcum = np.zeros(1, np.float32)
        # an srgb-packed grid's profiles bound its value, sigmoid x scale
        # < scale: they read the scale channel, never the coefficients
        prof_rows = rows
        if (kind in ("gridvolume_srgb", "gridvolume_nearest")
                and rows["grid"].shape[-1] == 4 and self.variant.is_spectral):
            prof_rows = {"grid": rows["grid"][..., 3:4]}
        cprof, ccum, resprof = _control_and_residual_profiles(
            kind, prof_rows, vmax)
        return self.add_medium_row("heterogeneous", {
            "sigma_t_vol": np.int32(st_vol), "albedo_vol": np.int32(al_vol),
            "scale": np.float32(scale),
            "majorant": np.float32(scale * vmax),
            "axprof": _axis_majorant_profiles(prof_rows, vmax),
            "w2l_m": w2l_m, "w2l_it": w2l_it,
            "zok": np.bool_(zok), "zprof": zprof, "zcum": zcum,
            "zD": np.int32(D), "cprof": cprof, "ccum": ccum,
            "cD": np.int32(len(cprof)), "resprof": resprof}, phase_idx)

    def add_spectrum_row(self, kind, row):
        """A spectrum row; in spectral every continuous kind carries its
        wavelength sampling table."""
        if self.variant.is_spectral and kind not in ("baked", "discrete"):
            row = dict(row, **_spectrum_sampling_table(kind, row))
        return self._add(self.spectra, self.spec_table, kind, row)

    def spectrum(self, value, emitter=False):
        """A python value / plugin dict -> spectrum index. In rgb and mono
        every spectrum bakes into a constant: (3,) rgb, or in mono (1,) its
        luminance; measured and analytic spectra bake by CIE integration
        (build_spectra._cie_rgb_of_spectrum): an ``emitter`` spectrum as
        radiance, any other as a reflectance under D65. In spectral the
        kind survives, evaluated at the hero wavelengths: numbers become
        'uniform', rgb triples 'srgb' through the rgb2spec fit (an
        emitter's 'srgb_d65', scaled by its luminance)."""
        spectral = self.variant.is_spectral

        def baked(rgb):
            rgb = np.asarray(rgb, np.float32)
            if self.variant.is_monochromatic:
                rgb = np.asarray([float(luminance(torch.as_tensor(rgb)))],
                                 np.float32)
            return self.add_spectrum_row("baked", {"value": rgb})

        def d65_rgb():
            return np.asarray(_cie_rgb_of_spectrum(
                lambda lam: d65_approx(torch.as_tensor(
                    lam, dtype=torch.float32)).numpy(), True))

        def srgb_row(arr, emitter, scale=None):
            coeff = np.asarray(fit_srgb_coeff(*map(float, arr)), np.float32)
            if not emitter:
                return self.add_spectrum_row("srgb", {"coeff": coeff})
            if scale is None:
                scale = max(float(luminance(torch.as_tensor(arr))), 1e-6)
            return self.add_spectrum_row("srgb_d65", {
                "coeff": coeff, "scale": np.float32(scale)})

        if isinstance(value, (int, float)):
            if spectral:
                return self.add_spectrum_row("uniform",
                                             {"value": np.float32(value)})
            return baked([value] * 3)
        if isinstance(value, (list, tuple, np.ndarray)):
            arr = np.asarray(value, np.float32)
            return srgb_row(arr, emitter) if spectral else baked(arr)
        t = value["type"]
        if t in ("rgb", "srgb"):
            # an 'srgb' dict is a reflectance even on an emitter
            return self.spectrum(np.asarray(value["value"], np.float32),
                                 emitter and t == "rgb")
        if t == "uniform":
            val = float(value.get("value", 1.0))
            if spectral:
                return self.add_spectrum_row("uniform",
                                             {"value": np.float32(val)})
            return baked([val] * 3)
        if t == "d65":
            scale = float(value.get("scale", 1.0))
            if spectral:
                return self.add_spectrum_row("d65",
                                             {"scale": np.float32(scale)})
            return baked(d65_rgb() * scale)
        if t == "regular":
            lo, hi = value["lambda_min"], value["lambda_max"]
            vals = np.asarray(value["values"], np.float32)
            if spectral:
                return self.add_spectrum_row("regular", {
                    "values": vals, "lo": np.float32(lo),
                    "hi": np.float32(hi), "count": np.int32(len(vals))})
            return baked(_cie_rgb_of_spectrum(
                lambda lam: np.interp(lam, np.linspace(lo, hi, len(vals)),
                                      vals, left=0, right=0), emitter))
        if t == "irregular":
            nodes = np.asarray(value["wavelengths"], np.float32)
            vals = np.asarray(value["values"], np.float32)
            if spectral:
                return self.add_spectrum_row("irregular", {
                    "nodes": nodes, "values": vals,
                    "count": np.int32(len(vals))})
            return baked(_cie_rgb_of_spectrum(
                lambda lam: np.interp(lam, nodes, vals, left=0, right=0),
                emitter))
        if t == "blackbody":
            T = float(value["temperature"])
            scale = float(value.get("scale", 1.0))
            if spectral:
                return self.add_spectrum_row("blackbody", {
                    "temperature": np.float32(T), "scale": np.float32(scale)})
            return baked(_cie_rgb_of_spectrum(
                lambda lam: blackbody_radiance(torch.as_tensor(
                    lam, dtype=torch.float32), T).numpy() * scale, True))
        if t == "srgb_d65":
            arr = np.asarray(value["value"], np.float32)
            if spectral:
                return srgb_row(arr, True, value.get("scale"))
            return baked(arr * d65_rgb())
        if t == "discrete":
            # a line spectrum (discrete.cpp:39-84): read only through
            # sampling (an srf, nbins); its rgb/mono bake is the sum of its
            # values
            wav = np.asarray(value["wavelengths"], np.float32)
            vals = np.asarray(value.get("values", np.ones_like(wav)),
                              np.float32)
            if spectral:
                return self.add_spectrum_row("discrete", {
                    "wavelengths": wav, "values": vals,
                    "count": np.int32(len(wav))})
            return baked([float(vals.sum())] * 3)
        raise ValueError(f"unknown spectrum type {t!r}")

    def add_texture_row(self, kind, row):
        return self._add(self.textures, self.tex_table, kind, row)

    def texture(self, value, emitter=False):
        """A value / texture dict -> texture index: constant (a spectrum),
        checkerboard, bitmap (inline ``data`` or an image ``filename``) or
        mesh_attribute; an ``emitter`` texture bakes its spectra as
        radiance."""
        t = value.get("type") if isinstance(value, dict) else None
        if t == "mesh_attribute":
            name = value["name"]
            if name not in self.mesh_attr_names:
                self.mesh_attr_names.append(name)
            return self._add(self.textures, self.tex_table, "mesh_attribute",
                             {"attr": np.int32(
                                 self.mesh_attr_names.index(name)),
                              "scale": np.float32(value.get("scale", 1.0))})
        if t == "checkerboard":
            s0 = self.spectrum(value.get("color0", 0.4), emitter)
            s1 = self.spectrum(value.get("color1", 0.2), emitter)
            return self._add(self.textures, self.tex_table, "checkerboard",
                             {"spec0": np.int32(s0), "spec1": np.int32(s1)})
        if t == "bitmap":
            data = _image_data(value)
            if data.ndim == 2:
                data = data[..., None].repeat(3, -1)
            self.bitmaps.append(data)
            return self._add(self.textures, self.tex_table, "bitmap",
                             {"image": np.int32(len(self.bitmaps) - 1)})
        spec = self.spectrum(value, emitter)
        return self._add(self.textures, self.tex_table, "constant",
                         {"spec": np.int32(spec)})

    def twosided_flag(self, props):
        return np.bool_(props.get("_twosided", False))

    # --- geometry ----------------------------------------------------------------
    def _new_shape(self, family, prim_slot, area, face_offset=0,
                   face_count=0):
        self.shape_rows.append(dict(family=family, prim_slot=prim_slot,
                                    bsdf=-1, emitter=-1, interior=-1,
                                    exterior=-1, area=area,
                                    face_offset=face_offset,
                                    face_count=face_count))
        return len(self.shape_rows) - 1

    def add_mesh(self, verts, faces, normals=None, uvs=None,
                 attributes=None):
        verts = np.asarray(verts, np.float32)
        faces = np.asarray(faces, np.int32)
        v_off = sum(len(v) for v in self.vertices)
        for name, arr in (attributes or {}).items():
            arr = np.atleast_2d(np.asarray(arr, np.float32))
            if arr.shape[0] != len(verts):
                arr = arr.T
            if arr.shape[0] != len(verts):
                raise ValueError(f"attribute {name!r}: {arr.shape[0]} "
                                 f"values for {len(verts)} vertices")
            self.mesh_attr_chunks.setdefault(name, []).append((v_off, arr))
            if name not in self.mesh_attr_names:
                self.mesh_attr_names.append(name)
        self.vertices.append(verts)
        self.normals.append(np.zeros_like(verts) if normals is None
                            else np.asarray(normals, np.float32))
        self.uvs.append(np.zeros((len(verts), 2), np.float32) if uvs is None
                        else np.asarray(uvs, np.float32))
        f_off = sum(len(f) for f in self.faces)
        self.faces.append(faces + v_off)
        areas = triangle_areas(verts, faces)
        shape_idx = self._new_shape(FAMILY_MESH, 0, float(areas.sum()),
                                    f_off, len(faces))
        self.face_shape.append(np.full(len(faces), shape_idx, np.int32))
        self.face_areas.append(areas.astype(np.float64))
        return shape_idx

    def add_sphere(self, center, radius, flip=False):
        self.spheres.append((np.asarray(center, np.float32),
                             np.float32(radius), bool(flip)))
        return self._new_shape(FAMILY_SPHERE, len(self.spheres) - 1,
                               float(4 * np.pi * radius ** 2))

    def add_rectangle(self, to_world: Transform):
        m = np.asarray(to_world.m)
        area = 4.0 * float(np.linalg.norm(np.cross(m[:3, 0], m[:3, 1])))
        self.rects.append(to_world)
        return self._new_shape(FAMILY_RECT, len(self.rects) - 1, area)

    def add_disk(self, to_world: Transform):
        m = np.asarray(to_world.m)
        area = float(np.pi * np.linalg.norm(np.cross(m[:3, 0], m[:3, 1])))
        self.disks.append(to_world)
        return self._new_shape(FAMILY_DISK, len(self.disks) - 1, area)

    def add_cylinder(self, to_world: Transform, length, radius):
        scale = float(np.linalg.norm(np.asarray(to_world.m)[:3, 0]))
        area = float(2 * np.pi * radius * length) * scale
        self.cyls.append((to_world, np.float32(length), np.float32(radius)))
        return self._new_shape(FAMILY_CYLINDER, len(self.cyls) - 1, area)

    def add_cone(self, to_world: Transform, length, radius):
        scale = float(np.linalg.norm(np.asarray(to_world.m)[:3, 0]))
        slant = float(np.hypot(radius, length))
        area = float(np.pi * radius * slant) * scale
        self.cones.append((to_world, np.float32(length), np.float32(radius)))
        return self._new_shape(FAMILY_CONE, len(self.cones) - 1, area)

    def _instancing_arrays(self):
        """The geometry's instancing pools; empty without instances."""
        f32, i32 = np.float32, np.int32
        if not self.instances:
            z = lambda *s: np.zeros(s, f32)
            zi = lambda *s: np.zeros(s, i32)
            return {"ig_vertices": z(0, 3), "ig_normals": z(0, 3),
                    "ig_uvs": z(0, 2), "ig_faces": zi(0, 3),
                    "ig_face_sub": zi(0), "inst_l2w.m": z(0, 4, 4),
                    "inst_l2w.inv_t": z(0, 4, 4), "inst_w2l.m": z(0, 4, 4),
                    "inst_w2l.inv_t": z(0, 4, 4), "inst_f_off": zi(0),
                    "inst_f_count": zi(0), "inst_shape_base": zi(0),
                    "inst_lo": z(0, 3), "inst_hi": z(0, 3),
                    "shape_inst": zi(0)}
        inst = lambda key: [i[key] for i in self.instances]
        return {
            "ig_vertices": np.concatenate(self.ig_vertices),
            "ig_normals": np.concatenate(self.ig_normals),
            "ig_uvs": np.concatenate(self.ig_uvs),
            "ig_faces": np.concatenate(self.ig_faces),
            "ig_face_sub": np.concatenate(self.ig_face_sub),
            "inst_l2w.m": np.stack([t.m for t in inst("l2w")]),
            "inst_l2w.inv_t": np.stack([t.inv_t for t in inst("l2w")]),
            "inst_w2l.m": np.stack([t.m for t in inst("w2l")]),
            "inst_w2l.inv_t": np.stack([t.inv_t for t in inst("w2l")]),
            "inst_f_off": np.asarray(inst("f_off"), i32),
            "inst_f_count": np.asarray(inst("f_count"), i32),
            "inst_shape_base": np.asarray(inst("shape_base"), i32),
            "inst_lo": np.stack(inst("lo")),
            "inst_hi": np.stack(inst("hi")),
            "shape_inst": np.asarray(
                [r["prim_slot"] if r["family"] == FAMILY_IMESH else -1
                 for r in self.shape_rows], i32)}

    def _accel_arrays(self, V, F, FS):
        """The tile and BVH arrays. Instanced groups pack their tiles once
        in local space; the BVH gets one leaf per (group tile, instance)
        with a world-space AABB and the instance id in nmeta[:, 3]."""
        f32, i32 = np.float32, np.int32
        z = lambda *s: np.zeros(s, f32)
        zi = lambda *s: np.zeros(s, i32)
        out = {"bvh8_box": z(0, 8, 8), "bvh8_meta": zi(0, 8, 4),
               "tiles_xf": np.asarray([[1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]],
                                      f32),
               "tiles_sbase": zi(1)}
        if len(F) == 0 and not self.instances:
            out.update(tiles_v0=z(0, TILE_K, 3), tiles_e1=z(0, TILE_K, 3),
                       tiles_e2=z(0, TILE_K, 3), tiles_prim=zi(0, TILE_K),
                       tiles_shape=zi(0, TILE_K), tiles_lo=z(0, 3),
                       tiles_hi=z(0, 3), bvh_box=z(0, 1, 8),
                       bvh_meta=zi(0, 4))
            return out
        parts = []
        leaf_lo, leaf_hi, leaf_tile, leaf_inst = [], [], [], []
        t_off = 0
        if len(F) > 0:
            t0 = pack_tiles(V, None, F, FS)
            T0 = len(t0["lo"])
            parts.append(t0)
            leaf_lo.append(t0["lo"])
            leaf_hi.append(t0["hi"])
            leaf_tile.append(np.arange(T0, dtype=i32))
            leaf_inst.append(np.full(T0, -1, i32))
            t_off = T0
        if self.instances:
            IGV = np.concatenate(self.ig_vertices)
            IGF = np.concatenate(self.ig_faces)
            IGS = np.concatenate(self.ig_face_sub)
            group_tiles = {}  # f_off -> (first tile, count, lo, hi)
            for rec in self.group_records.values():
                if rec["f_count"] == 0:
                    continue
                fsl = slice(rec["f_off"], rec["f_off"] + rec["f_count"])
                tg = pack_tiles(IGV, None, IGF[fsl], IGS[fsl])
                tg["prim"] = np.where(tg["prim"] >= 0,
                                      tg["prim"] + rec["f_off"], tg["prim"])
                group_tiles[rec["f_off"]] = (t_off, len(tg["lo"]),
                                             tg["lo"], tg["hi"])
                parts.append(tg)
                t_off += len(tg["lo"])
            for i, inst in enumerate(self.instances):
                t_start, t_cnt, glo, ghi = group_tiles[inst["f_off"]]
                m = np.asarray(inst["l2w"].m)
                A, bvec = m[:3, :3], m[:3, 3]
                wc = 0.5 * (glo + ghi) @ A.T + bvec
                we = 0.5 * (ghi - glo) @ np.abs(A).T
                leaf_lo.append((wc - we).astype(f32))
                leaf_hi.append((wc + we).astype(f32))
                leaf_tile.append(np.arange(t_start, t_start + t_cnt,
                                           dtype=i32))
                leaf_inst.append(np.full(t_cnt, i, i32))
        for k in parts[0]:
            out[f"tiles_{k}"] = np.concatenate([p[k] for p in parts])
        nbox, nmeta, _depth = build_tile_bvh(
            np.concatenate(leaf_lo), np.concatenate(leaf_hi),
            np.concatenate(leaf_tile), np.concatenate(leaf_inst))
        out["bvh_box"], out["bvh_meta"] = nbox, nmeta
        # a BVH8 leaf entry packs (tile << 12) | (inst + 1) into one i32
        # (ops/intersect.py): beyond these ranges only the binary BVH exists
        n_leaves = sum(len(t) for t in leaf_tile)
        if n_leaves < (1 << 18) and len(self.instances) < 4095:
            out["bvh8_box"], out["bvh8_meta"] = collapse_to_bvh8(nbox, nmeta)
        out["tiles_xf"] = np.stack([out["tiles_xf"][0]] + [
            np.asarray(i["w2l"].m, f32)[:3, :4].reshape(12)
            for i in self.instances])
        out["tiles_sbase"] = np.asarray(
            [0] + [i["shape_base"] for i in self.instances], i32)
        return out

    def _mesh_attr_data(self, n_vertices):
        """(A, V, 3) per-vertex data of the mesh attributes (1-channel
        ones repeated into 3); a (1, 1, 3) zero without any."""
        if not self.mesh_attr_names:
            return np.zeros((1, 1, 3), np.float32)
        data = np.zeros((len(self.mesh_attr_names), max(n_vertices, 1), 3),
                        np.float32)
        for a, name in enumerate(self.mesh_attr_names):
            for off, arr in self.mesh_attr_chunks.get(name, []):
                c = min(arr.shape[1], 3)
                data[a, off:off + len(arr), :c] = arr[:, :c]
                if c == 1:
                    data[a, off:off + len(arr), 1:3] = arr[:, :1]
        return data

    # --- finalize ------------------------------------------------------------------
    def finalize(self, sensor_kind, sensor_params, film_cfg, integrator_cfg,
                 spp):
        """-> (arrays by dotted name, SceneConfig)."""
        if not self.spec_table:
            # a default spectrum slot 0, so texture and bsdf fallbacks
            # resolve
            if self.variant.is_spectral:
                self.add_spectrum_row("uniform", {"value": np.float32(0.5)})
            else:
                self.add_spectrum_row("baked", {
                    "value": np.full(self.nc, 0.5, np.float32)})
        if not self.tex_table:
            self._add(self.textures, self.tex_table, "constant",
                      {"spec": np.int32(0)})
        if not self.bsdf_rows:
            self.bsdf_rows["diffuse"] = [{"reflectance": np.int32(0),
                                          "twosided": np.bool_(False)}]
            self.bsdf_table.append(("diffuse", 0))
            self.bsdf_flag_list.append(0)
        if not self.shape_rows:
            # pad row so per-shape gathers are well formed; family -1
            # matches no intersection family
            self.shape_rows.append(dict(family=-1, prim_slot=0, bsdf=0,
                                        emitter=-1, interior=-1,
                                        exterior=-1, area=1.0,
                                        face_offset=0, face_count=0))
        arrays = {}

        def registry(name, rows_dict, table, kind_name, slot_name):
            kinds = list(rows_dict)
            for kind, rows in rows_dict.items():
                for key in rows[0]:
                    vals = [np.asarray(r[key]) for r in rows]
                    if vals[0].ndim and len({v.shape for v in vals}) > 1:
                        # pad variable-shape rows (grids) in every dim
                        tgt = np.max([v.shape for v in vals], axis=0)
                        vals = [np.pad(v, [(0, n - m) for n, m in
                                           zip(tgt, v.shape)])
                                for v in vals]
                    arrays[f"{name}.{kind}.{key}"] = np.stack(vals)
            arrays[kind_name] = np.asarray([kinds.index(k) for k, _ in table],
                                           np.int32).reshape(-1)
            arrays[slot_name] = np.asarray([s for _, s in table],
                                           np.int32).reshape(-1)
            return tuple(kinds)

        bsdf_kinds = registry("bsdfs", self.bsdf_rows, self.bsdf_table,
                              "bsdf_kind", "bsdf_slot")
        emitter_kinds = registry("emitters", self.emitter_rows,
                                 self.emitter_table, "emitter_kind",
                                 "emitter_slot")
        tex_kinds = registry("textures", self.textures, self.tex_table,
                             "tex_kind", "tex_slot")
        spec_kinds = registry("spectra", self.spectra, self.spec_table,
                              "spec_kind", "spec_slot")
        # plane-parallel closed-form optical depth needs EVERY heterogeneous
        # medium to be a vertical profile; profile rows pad to one length
        het_rows = self.media_rows.get("heterogeneous", [])
        het_profile1d = bool(het_rows) and all(bool(r["zok"])
                                               for r in het_rows)
        for prof, cum in (("zprof", "zcum"), ("cprof", "ccum")):
            n = max((len(r[prof]) for r in het_rows), default=0)
            for r in het_rows:
                if len(r[prof]) < n:
                    pad = (0, n - len(r[prof]))
                    r[prof] = np.pad(r[prof], pad, mode="edge")
                    r[cum] = np.pad(r[cum], pad, mode="edge")
        medium_kinds = registry("media", self.media_rows, self.medium_table,
                                "medium_kind", "medium_slot")
        phase_kinds = registry("phases", self.phase_rows, self.phase_table,
                               "phase_kind", "phase_slot")
        volume_kinds = registry("volumes", self.volume_rows,
                                self.volume_table, "vol_kind", "vol_slot")
        arrays["medium_phase"] = np.asarray(self.medium_phase_list, np.int32)
        arrays["bsdf_flags"] = np.asarray(self.bsdf_flag_list, np.int32)
        shape_col = lambda key: np.asarray([r[key] for r in self.shape_rows],
                                           np.int32)
        arrays["shape_bsdf"] = shape_col("bsdf")
        arrays["shape_emitter"] = shape_col("emitter")
        arrays["shape_interior"] = shape_col("interior")
        arrays["shape_exterior"] = shape_col("exterior")
        arrays["shape_prim_slot"] = shape_col("prim_slot")
        arrays["shape_face_offset"] = shape_col("face_offset")
        arrays["shape_face_count"] = shape_col("face_count")
        arrays["shape_area"] = np.asarray(
            [r["area"] for r in self.shape_rows], np.float32)
        # strictly increasing global cumsum: one searchsorted picks a face
        # of any mesh (render/shape_sampling.py)
        face_areas = (np.concatenate(self.face_areas) if self.face_areas
                      else np.zeros(0))
        arrays["face_area_cumsum"] = np.cumsum(
            np.maximum(face_areas, 1e-12)).astype(np.float32)

        cat = lambda parts, shape, dtype: (np.concatenate(parts) if parts
                                           else np.zeros(shape, dtype))
        V = cat(self.vertices, (0, 3), np.float32)
        F = cat(self.faces, (0, 3), np.int32)
        FS = cat(self.face_shape, (0,), np.int32)
        of_family = lambda fam: np.asarray(
            [i for i, r in enumerate(self.shape_rows) if r["family"] == fam],
            np.int32)
        geo = {"vertices": V,
               "normals": cat(self.normals, (0, 3), np.float32),
               "uvs": cat(self.uvs, (0, 2), np.float32),
               "faces": F, "face_shape": FS,
               "sph_center": (np.stack([c for c, _r, _f in self.spheres])
                              if self.spheres
                              else np.zeros((0, 3), np.float32)),
               "sph_radius": np.asarray([r for _c, r, _f in self.spheres],
                                        np.float32),
               "sph_shape": of_family(FAMILY_SPHERE),
               "sph_flip": np.asarray([f for _c, _r, f in self.spheres],
                                      bool),
               "rect_shape": of_family(FAMILY_RECT),
               "disk_shape": of_family(FAMILY_DISK),
               "cyl_shape": of_family(FAMILY_CYLINDER),
               "cone_shape": of_family(FAMILY_CONE),
               "shape_family": shape_col("family")}
        for pool, rows in (("cyl", self.cyls), ("cone", self.cones)):
            geo[f"{pool}_length"] = np.asarray([r[1] for r in rows],
                                               np.float32)
            geo[f"{pool}_radius"] = np.asarray([r[2] for r in rows],
                                               np.float32)
        for name, tfs in (("rect_to_world", self.rects),
                          ("disk_to_world", self.disks),
                          ("cyl_to_world", [r[0] for r in self.cyls]),
                          ("cone_to_world", [r[0] for r in self.cones])):
            for part in ("m", "inv_t"):
                geo[f"{name}.{part}"] = (
                    np.stack([getattr(t, part) for t in tfs]) if tfs
                    else np.zeros((0, 4, 4), np.float32))
        geo.update(self._accel_arrays(V, F, FS))
        geo.update(self._instancing_arrays())
        arrays.update({f"geo.{k}": v for k, v in geo.items()})
        bitmaps = (np.stack(self.bitmaps) if self.bitmaps
                   else np.zeros((1, 1, 1, 3), np.float32))
        arrays["bitmap_data"] = bitmaps
        # spectral: every texel's rgb2spec coefficients and brightness scale
        # (the envmap.cpp:69-89 scheme), evaluated at the hero wavelengths
        if self.variant.is_spectral and self.bitmaps:
            bm_scale = np.maximum(2.0 * bitmaps.max(-1), 1e-8)
            arrays["bitmap_coeff"] = fit_srgb_coeff_batch(
                (bitmaps / bm_scale[..., None]).reshape(-1, 3)
            ).reshape(bitmaps.shape)
            arrays["bitmap_scale"] = bm_scale.astype(np.float32)
        else:
            arrays["bitmap_coeff"] = np.zeros((1, 1, 1, 3), np.float32)
            arrays["bitmap_scale"] = np.ones((1, 1, 1), np.float32)
        arrays["mesh_attr_data"] = self._mesh_attr_data(len(V))

        pts = [V] if len(V) else []
        for inst in self.instances:
            pts.append(np.stack([inst["lo"], inst["hi"]]))
        for c, r, _flip in self.spheres:
            pts.append(c[None] + np.array([[r, r, r], [-r, -r, -r]],
                                          np.float32))
        for t in self.rects + self.disks:
            corners = np.array([[x, y, 0, 1] for x in (-1, 1)
                                for y in (-1, 1)], np.float32) @ t.m.T
            pts.append(corners[:, :3])
        center, radius = bounding_sphere(
            np.concatenate(pts) if pts else np.zeros((0, 3), np.float32))
        arrays["bsphere_center"] = np.asarray(center)
        arrays["bsphere_radius"] = np.float32(max(radius, 1e-3))
        for key, v in sensor_params.items():
            if isinstance(v, (Transform, AnimatedTransform)):
                for f in dataclasses.fields(v):
                    arrays[f"sensor.{key}.{f.name}"] = np.asarray(
                        getattr(v, f.name))
            else:
                arrays[f"sensor.{key}"] = v

        cfg = SceneConfig(
            variant=self.variant,
            bsdf_kinds=bsdf_kinds, emitter_kinds=emitter_kinds,
            texture_kinds=tex_kinds, spectrum_kinds=spec_kinds,
            medium_kinds=medium_kinds, phase_kinds=phase_kinds,
            volume_kinds=volume_kinds, het_profile1d=het_profile1d,
            sensor_medium=self.sensor_medium,
            sensor_kind=sensor_kind, sensor_static=self.sensor_static,
            n_emitters=len(self.emitter_table),
            env_emitter=self.env_emitter,
            film_width=film_cfg["width"], film_height=film_cfg["height"],
            rfilter=film_cfg.get("rfilter", "gaussian"),
            rfilter_params=tuple(sorted(
                film_cfg.get("rfilter_params", {}).items())),
            integrator=integrator_cfg, spp=spp,
            sampler_kind=getattr(self, "sampler_kind", "independent"),
            pixel_format=film_cfg.get("pixel_format", "rgb"),
            crop_offset=tuple(film_cfg.get("crop_offset", (0, 0))),
            crop_size=tuple(film_cfg.get("crop_size", ())),
            bsdf_static=tuple(sorted((k, tuple(v))
                                     for k, v in self.bsdf_static.items())))
        return arrays, cfg


def load_dict(d: dict, variant: Variant | None = None,
              device=None) -> Scene:
    """Build a Scene from a Mitsuba-style dict onto ``device`` (cuda by
    default; pass device='cpu' for the CPU). Types outside this slice of
    the port raise."""
    if d.get("type") != "scene":
        raise ValueError("top-level dict must have type='scene'")
    device = resolve_device(device)
    b = SceneBuilder(variant or Variant("rgb"))
    integrator_cfg = IntegratorConfig()
    sensor_kind = "perspective"
    pending_sensor = None
    film_cfg = {"width": 64, "height": 64, "rfilter": "gaussian"}
    spp = 16

    # the registered kinds join the built-in ones (register_bsdf,
    # register_emitter, register_integrator)
    from ..emitters import CUSTOM as custom_emitters
    from ..integrators import REGISTRY as integrator_registry

    def is_bsdf(t):
        return t in BSDF_REGISTRY or t == "twosided"

    # pass 1: named top-level bsdfs (so refs resolve)
    for key, val in d.items():
        if isinstance(val, dict) and is_bsdf(val.get("type")):
            b.named[key] = ("bsdf", _build_bsdf(b, val))

    for key, val in d.items():
        if key == "type" or not isinstance(val, dict):
            continue
        t = val.get("type")
        if t == "shapegroup":
            # registered before use: its instances must follow it in d
            b.named[key] = ("shapegroup", shape_children(val))
        elif t in _SHAPE_TYPES:
            b.named[key] = ("shape", _build_shape(b, val))
        elif t in _EMITTER_SCENE_TYPES or t in custom_emitters:
            _build_scene_emitter(b, val)
        elif t in _SENSOR_TYPES:
            sensor_kind = t
            pending_sensor = val
            # the film's size, format and filter, whatever its type (the
            # reference reads any film dict so; a specfilm renders as an
            # hdrfilm)
            film = val.get("film", {})
            film_cfg["width"] = int(film.get("width", 64))
            film_cfg["height"] = int(film.get("height", 64))
            film_cfg["pixel_format"] = str(film.get("pixel_format", "rgb"))
            film_cfg["crop_offset"] = (int(film.get("crop_offset_x", 0)),
                                       int(film.get("crop_offset_y", 0)))
            if "crop_width" in film or "crop_height" in film:
                film_cfg["crop_size"] = (
                    int(film.get("crop_width", film_cfg["width"])),
                    int(film.get("crop_height", film_cfg["height"])))
            rf = film.get("rfilter", {"type": "gaussian"})
            if isinstance(rf, dict):  # else the default gaussian, as in ref
                film_cfg["rfilter"] = rf.get("type", "gaussian")
                film_cfg["rfilter_params"] = {k: v for k, v in rf.items()
                                              if k != "type"}
            sampler = val.get("sampler", {})
            spp = int(sampler.get("sample_count", 16))
            b.sampler_kind = sampler.get("type", "independent")
            if "medium" in val:
                b.sensor_medium = b.medium(val["medium"])
        elif t in _INTEGRATOR_TYPES or t in integrator_registry:
            integrator_cfg = _integrator_config(t, val)
        elif t in _MEDIUM_TYPES:
            b.named[key] = ("medium", b.medium(val))
        elif not is_bsdf(t):
            raise NotImplementedError(
                f"scene entry {key!r} of type {t!r}: not carried by the "
                "port")

    if pending_sensor is not None:
        # built after every shape (irradiancemeter's shape ref); its film
        # overrides (mdistant, mradiancemeter) reach finalize in film_cfg
        sensor_params, b.sensor_static = _build_sensor(
            b, sensor_kind, pending_sensor, film_cfg)
    else:
        sensor_params = {
            "to_world": Transform.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]),
            "tan_half_fov": np.float32(np.tan(np.deg2rad(34.0) / 2))}
    arrays, cfg = b.finalize(sensor_kind, sensor_params, film_cfg,
                             integrator_cfg, spp)
    return from_numpy(arrays, cfg, device)
