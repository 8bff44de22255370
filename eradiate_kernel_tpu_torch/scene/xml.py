"""Mitsuba-XML scene loader and writer (scene/xml.py counterpart; Mitsuba's
src/libcore/xml.cpp and mitsuba.python.xml).

The XML tree is translated into the dict-loader schema and handed to
``load_dict`` on the device the caller names (cuda by default), as the
reference's XML loader hands its tree to its dict loader.

Supported property tags: float, integer, boolean, string, point, vector,
rgb, spectrum (inline "l0:v0, l1:v1" pairs or a uniform value), ref,
default, transform (translate/rotate/scale/lookat/matrix), animation and
include; ``$name`` parameters are substituted from ``parameters`` and the
scene's ``<default>`` tags. ``dict_to_xml`` writes the reference's text
character for character: a plugin's tag comes from the reference's tables
of plugin type strings, copied here as static data, so kinds the port
does not carry yet get the same tag.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np
import torch

from ..core.transform import Transform
from .build import load_dict

__all__ = ["load_file", "load_string", "dict_to_xml", "write_file"]

_PLUGIN_TAGS = ("bsdf", "emitter", "sensor", "integrator", "shape", "medium",
                "phase", "texture", "spectrum", "volume", "film", "sampler",
                "rfilter")


def _subst(value: str, params: dict) -> str:
    """$name command-line substitution (xml.cpp:616-633)."""
    def repl(m):
        key = m.group(1)
        if key not in params:
            raise KeyError(f"undefined parameter ${key}")
        return str(params[key])
    return re.sub(r"\$(\w+)", repl, value)


def _floats(s):
    return [float(x) for x in re.split(r"[,\s]+", s.strip()) if x]


def _parse_transform(node, params):
    ops = []
    for child in node:
        tag = child.tag
        a = {k: _subst(v, params) for k, v in child.attrib.items()}
        if tag == "translate":
            ops.append({"type": "translate",
                        "value": [float(a.get("x", 0)), float(a.get("y", 0)),
                                  float(a.get("z", 0))]
                        if "value" not in a else _floats(a["value"])})
        elif tag == "scale":
            if "value" in a:
                v = _floats(a["value"])
                ops.append({"type": "scale",
                            "value": v[0] if len(v) == 1 else v})
            else:
                ops.append({"type": "scale",
                            "value": [float(a.get("x", 1)),
                                      float(a.get("y", 1)),
                                      float(a.get("z", 1))]})
        elif tag == "rotate":
            axis = [float(a.get("x", 0)), float(a.get("y", 0)),
                    float(a.get("z", 0))]
            ops.append({"type": "rotate", "axis": axis,
                        "angle": float(a.get("angle", 0))})
        elif tag in ("lookat", "look_at"):
            ops.append({"type": "look_at",
                        "origin": _floats(a["origin"]),
                        "target": _floats(a["target"]),
                        "up": _floats(a.get("up", "0 0 1"))})
        elif tag == "matrix":
            ops.append({"type": "matrix", "value": _floats(a["value"])})
        else:
            raise ValueError(f"unknown transform op <{tag}>")
    if len(ops) == 1:
        return ops[0]
    return ops


def _parse_spectrum_value(v: str):
    """'400:0.2, 500:0.4' -> irregular dict; plain number -> float."""
    if ":" in v:
        pairs = [p for p in re.split(r"[,\s]+", v.strip()) if p]
        wav, vals = zip(*((float(a), float(b))
                          for a, b in (p.split(":") for p in pairs)))
        return {"type": "irregular", "wavelengths": list(wav),
                "values": list(vals)}
    return float(v)


def _parse_node(node, params, base_dir):
    """Plugin node -> dict."""
    d = {"type": node.attrib.get("type", node.tag)}
    counters = {}
    for child in node:
        tag = child.tag
        a = {k: _subst(v, params) for k, v in child.attrib.items()}
        name = a.get("name")
        if tag == "float":
            d[name] = float(a["value"])
        elif tag == "integer":
            d[name] = int(a["value"])
        elif tag == "boolean":
            d[name] = a["value"].strip().lower() == "true"
        elif tag == "string":
            val = a["value"]
            if name == "filename" and base_dir and not os.path.isabs(val):
                val = os.path.join(base_dir, val)
            d[name] = val
        elif tag in ("point", "vector"):
            if "value" in a:
                d[name] = _floats(a["value"])
            else:
                d[name] = [float(a.get("x", 0)), float(a.get("y", 0)),
                           float(a.get("z", 0))]
        elif tag == "rgb":
            d[name] = {"type": "rgb", "value": _floats(a["value"])}
        elif tag == "spectrum":
            d[name] = _parse_spectrum_value(a["value"])
        elif tag == "transform":
            d[name] = _parse_transform(child, params)
        elif tag == "animation":
            # <animation name="to_world"><transform time="0">...</transform>
            # ... (xml.cpp Tag::Animation) -> animation keyframe dict
            frames = []
            for tr in child:
                if tr.tag != "transform":
                    raise ValueError("<animation> children must be "
                                     "<transform time=...>")
                t_attr = {k: _subst(v, params)
                          for k, v in tr.attrib.items()}
                frames.append([float(t_attr.get("time", len(frames))),
                               _parse_transform(tr, params)])
            d[name] = {"type": "animation", "keyframes": frames}
        elif tag == "ref":
            key = name or f"_ref_{len(d)}"
            d[key] = {"type": "ref", "id": a["id"]}
        elif tag == "default":
            params.setdefault(a["name"], a["value"])
        elif tag in _PLUGIN_TAGS:
            sub = _parse_node(child, params, base_dir)
            key = name or child.attrib.get("id")
            if key is None:
                counters[tag] = counters.get(tag, 0)
                key = tag if counters[tag] == 0 else f"{tag}_{counters[tag]}"
                counters[tag] += 1
            d[key] = sub
        else:
            raise ValueError(f"unhandled tag <{tag}> in <{node.tag}>")
    return d


def load_string(xml_str: str, variant=None, parameters=None, base_dir=None,
                device=None):
    """Parse a Mitsuba XML scene string -> Scene on ``device`` (cuda by
    default; xml.cpp load_string). Relative file names resolve against
    ``base_dir``."""
    params = dict(parameters or {})
    root = ET.fromstring(xml_str)
    if root.tag != "scene":
        raise ValueError(f"expected <scene>, got <{root.tag}>")

    # first pass: collect <default> so $refs resolve in document order too
    for child in root:
        if child.tag == "default":
            params.setdefault(child.attrib["name"], child.attrib["value"])

    scene = {"type": "scene"}
    counters = {}
    for child in root:
        tag = child.tag
        if tag == "default":
            continue
        if tag == "include":
            fname = _subst(child.attrib["filename"], params)
            if base_dir and not os.path.isabs(fname):
                fname = os.path.join(base_dir, fname)
            sub_root = ET.parse(fname).getroot()
            for sub in sub_root:
                key = sub.attrib.get("id", sub.tag)
                scene[key] = _parse_node(sub, params,
                                         os.path.dirname(fname))
            continue
        if tag not in _PLUGIN_TAGS:
            raise ValueError(f"unhandled top-level tag <{tag}>")
        node = _parse_node(child, params, base_dir)
        key = child.attrib.get("id")
        if key is None:
            counters[tag] = counters.get(tag, 0)
            key = tag if counters[tag] == 0 else f"{tag}_{counters[tag]}"
            counters[tag] += 1
        scene[key] = node
    return load_dict(_lift_sensor_children(scene), variant, device=device)


def _lift_sensor_children(scene: dict) -> dict:
    """XML nests film/sampler under <sensor> with their own tags; the dict
    loader expects them as 'film'/'sampler' keys of the sensor dict — the
    parse above already places them by tag name, so nothing to lift unless
    ids were used; normalize those."""
    for v in scene.values():
        if isinstance(v, dict) and v.get("type") in (
                "perspective", "thinlens", "radiancemeter", "mradiancemeter",
                "distant", "mdistant", "distantflux", "irradiancemeter"):
            for key in list(v.keys()):
                sub = v[key]
                if isinstance(sub, dict) and sub.get("type") == "hdrfilm":
                    v.setdefault("film", sub)
                elif isinstance(sub, dict) and sub.get("type") in (
                        "independent", "stratified", "multijitter",
                        "orthogonal", "ldsampler"):
                    v.setdefault("sampler", sub)
    return scene


def load_file(path: str, variant=None, parameters=None, device=None):
    """Parse a Mitsuba XML scene file -> Scene on ``device`` (cuda by
    default; xml.cpp:1214 load_file)."""
    with open(path) as f:
        return load_string(f.read(), variant, parameters,
                           base_dir=os.path.dirname(os.path.abspath(path)),
                           device=device)


# =============================================================================
# dict -> XML writer (mitsuba.python.xml WriteXML analog)
# =============================================================================

def _host(a):
    """A numpy view of an array, a tensor (on any device) or a number."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _prop_to_xml(parent, name, value):
    if isinstance(value, bool):
        ET.SubElement(parent, "boolean", name=name,
                      value="true" if value else "false")
    elif isinstance(value, int):
        ET.SubElement(parent, "integer", name=name, value=str(value))
    elif isinstance(value, float):
        ET.SubElement(parent, "float", name=name, value=repr(value))
    elif isinstance(value, str):
        ET.SubElement(parent, "string", name=name, value=value)
    elif isinstance(value, (list, tuple)) and value \
            and isinstance(value[0], dict):
        t = ET.SubElement(parent, "transform", name=name)
        for op in value:
            _transform_op_to_xml(t, op)
    elif isinstance(value, (list, tuple)):
        ET.SubElement(parent, "vector", name=name,
                      value=" ".join(repr(float(x)) for x in value))
    elif isinstance(value, dict):
        t = value.get("type")
        if t == "rgb":
            ET.SubElement(parent, "rgb", name=name,
                          value=" ".join(repr(float(x))
                                         for x in value["value"]))
        elif t == "ref":
            ET.SubElement(parent, "ref", name=name, id=value["id"])
        elif t in ("look_at", "translate", "rotate", "scale", "matrix"):
            tr = ET.SubElement(parent, "transform", name=name)
            _transform_op_to_xml(tr, value)
        elif t == "irregular":
            pairs = ", ".join(f"{w}:{v}" for w, v in
                              zip(value["wavelengths"], value["values"]))
            ET.SubElement(parent, "spectrum", name=name, value=pairs)
        else:
            _node_to_xml(parent, name, value)
    elif isinstance(value, Transform):
        tr = ET.SubElement(parent, "transform", name=name)
        ET.SubElement(tr, "matrix", value=" ".join(map(
            repr, _host(value.m).ravel().tolist())))
    else:
        arr = _host(value)
        if arr.shape == (4, 4):
            tr = ET.SubElement(parent, "transform", name=name)
            ET.SubElement(tr, "matrix",
                          value=" ".join(map(repr, arr.ravel().tolist())))
        elif arr.ndim <= 1 and arr.dtype.kind in "fiu":
            ET.SubElement(parent, "vector", name=name,
                          value=" ".join(repr(float(x))
                                         for x in np.atleast_1d(arr)))
        else:
            raise ValueError(f"cannot serialize {name}={value!r}")


def _transform_op_to_xml(parent, op):
    t = op["type"]
    if t == "look_at":
        ET.SubElement(parent, "lookat",
                      origin=" ".join(map(repr, map(float, op["origin"]))),
                      target=" ".join(map(repr, map(float, op["target"]))),
                      up=" ".join(map(repr, map(float, op.get("up",
                                                              [0, 0, 1])))))
    elif t == "matrix":
        ET.SubElement(parent, "matrix",
                      value=" ".join(map(repr, np.asarray(
                          op["value"]).ravel().tolist())))
    elif t == "rotate":
        ax = op.get("axis", [0, 0, 1])
        ET.SubElement(parent, "rotate", x=repr(float(ax[0])),
                      y=repr(float(ax[1])), z=repr(float(ax[2])),
                      angle=repr(float(op.get("angle", 0.0))))
    else:
        v = op.get("value", 0.0)
        if isinstance(v, (list, tuple)):
            ET.SubElement(parent, t, value=" ".join(map(repr, map(float, v))))
        else:
            ET.SubElement(parent, t, value=repr(float(v)))


# the reference's plugin type strings by tag (its bsdfs.REGISTRY and
# 'twosided', its build module's shape and scene-emitter tuples and 'area',
# its integrators), whether or not the port carries the kind yet
_BSDF_TAG_TYPES = frozenset((
    "bilambertian", "blendbsdf", "bumpmap", "circular", "conductor",
    "dielectric", "diffuse", "mask", "measured", "measured_polarized",
    "normalmap", "null", "plastic", "polarizer", "pplastic", "retarder",
    "roughconductor", "roughdielectric", "roughplastic", "rpv",
    "thindielectric", "twosided"))
_SHAPE_TAG_TYPES = frozenset((
    "rectangle", "disk", "sphere", "cylinder", "cone", "cube", "mesh", "obj",
    "ply", "serialized", "instance"))
_EMITTER_TAG_TYPES = frozenset((
    "constant", "point", "directional", "spot", "projector", "envmap",
    "area"))
_INTEGRATOR_TAG_TYPES = frozenset((
    "path", "volpath", "volpathmis", "direct", "depth", "aov", "moment",
    "bins", "nbins"))
_TAG_OF_TYPE = {
    "perspective": "sensor", "thinlens": "sensor", "radiancemeter": "sensor",
    "mradiancemeter": "sensor", "distant": "sensor", "mdistant": "sensor",
    "distantflux": "sensor", "irradiancemeter": "sensor",
    "hdrfilm": "film",
    "independent": "sampler", "stratified": "sampler",
    "multijitter": "sampler", "orthogonal": "sampler", "ldsampler": "sampler",
    "homogeneous": "medium", "heterogeneous": "medium",
    "isotropic": "phase", "hg": "phase", "rayleigh": "phase",
    "tabphase": "phase", "blendphase": "phase",
    "bitmap": "texture", "checkerboard": "texture",
    "gridvolume": "volume", "constvolume": "volume",
}


def _node_to_xml(parent, name, d):
    t = d["type"]
    if t in _BSDF_TAG_TYPES:
        tag = "bsdf"
    elif t in _SHAPE_TAG_TYPES:
        tag = "shape"
    elif t in _EMITTER_TAG_TYPES:
        tag = "emitter"
    elif t in _INTEGRATOR_TAG_TYPES:
        tag = "integrator"
    else:
        tag = _TAG_OF_TYPE.get(t, "texture")
    el = ET.SubElement(parent, tag, type=t)
    if name and parent.tag == "scene":
        el.set("id", name)
    elif name and name not in ("film", "sampler") and tag not in (
            "film", "sampler"):
        el.set("name", name)
    for k, v in d.items():
        if k == "type":
            continue
        _prop_to_xml(el, k, v)
    return el


def dict_to_xml(scene_dict: dict) -> str:
    """Serialize a dict-loader scene description to Mitsuba XML
    (mitsuba.python.xml WriteXML analog)."""
    root = ET.Element("scene", version="2.0.0")
    for key, val in scene_dict.items():
        if key == "type":
            continue
        _node_to_xml(root, key, val)
    ET.indent(root)
    return ET.tostring(root, encoding="unicode")


def write_file(path: str, scene_dict: dict):
    with open(path, "w") as f:
        f.write('<?xml version="1.0" encoding="utf-8"?>\n')
        f.write(dict_to_xml(scene_dict))
        f.write("\n")
