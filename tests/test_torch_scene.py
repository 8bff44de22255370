"""The port's scene construction against eradiate_kernel_tpu.scene.load_dict:
every array of the port's Scene equals the reference Scene's leaf of the
same path, bit for bit, and ``from_numpy`` carries a reference Scene
across unchanged."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from bench_mesh import terrain
from test_measured import synth_pbsdf
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.scene import (IntegratorConfig, SceneConfig,
                                             from_numpy, load_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def terrain_scene(n=17, width=16, height=16, spp=4, max_depth=3,
                  ground=False):
    """Terrain heightfield with an RPV BRDF, a directional sun and a
    perspective camera above it looking down the +y axis; ``ground`` adds
    a twosided diffuse rectangle under the terrain."""
    V, F = terrain(n)
    d = {
        "type": "scene",
        "terrain": {"type": "mesh", "vertices": V, "faces": F,
                    "bsdf": {"type": "rpv", "rho_0": 0.2, "g": -0.1,
                             "k": 0.7}},
        "sun": {"type": "directional", "direction": [0.3, 0.0, -0.94],
                "irradiance": 1.0},
        "camera": {
            "type": "perspective", "fov": 58.0,
            "to_world": {"type": "look_at", "origin": [0.0, -1.5, 1.2],
                         "target": [0.0, -0.6, 0.65], "up": [0, 0, 1]},
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
        "integrator": {"type": "path", "max_depth": max_depth},
    }
    if ground:
        d["ground"] = {
            "type": "rectangle",
            "to_world": [{"type": "scale", "value": [3.0, 3.0, 1.0]},
                         {"type": "translate", "value": [0.0, 0.0, -0.6]}],
            "bsdf": {"type": "twosided",
                     "inner": {"type": "diffuse",
                               "reflectance": [0.3, 0.4, 0.5]}}}
    return d


def reference_arrays(scene):
    """The reference Scene's leaves as numpy, by dotted attribute path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(scene)[0]:
        name = ".".join(getattr(k, "name", None) or str(k.key) for k in path)
        out[name] = np.asarray(leaf)
    return out


def port_config(cfg):
    """The port's SceneConfig with the reference config's values."""
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(SceneConfig)}
    kw["variant"] = Variant(cfg.variant.mode)
    kw["integrator"] = IntegratorConfig(
        **dataclasses.asdict(cfg.integrator))
    return SceneConfig(**kw)


@pytest.mark.parametrize("ground", [False, True])
def test_load_dict_matches_reference(ground):
    d = terrain_scene(ground=ground)
    ref_scene = jload_dict(d)
    ref = reference_arrays(ref_scene)
    scene = load_dict(d, device="cpu")
    arrays = scene.arrays()
    assert "geo.tiles_v0" in arrays and "bsdfs.rpv.rho_0" in arrays
    for name, a in arrays.items():
        assert a.shape == ref[name].shape, name
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    assert scene.config == port_config(ref_scene.config)

    # carried across from the reference's leaves, the scene is the same
    carried = from_numpy(ref, port_config(ref_scene.config), device="cpu")
    for name, a in carried.arrays().items():
        np.testing.assert_array_equal(a, arrays[name], err_msg=name)


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    d = terrain_scene()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_dict(d)
    scene = load_dict(d, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_numpy(scene.arrays(), scene.config)
    assert scene.geo.tiles_v0.device.type == "cpu"


@pytest.mark.parametrize("entry", [
    ("bsdf", {"type": "polarizer"}),
    ("bsdf", {"type": "circular"}),
    ("bsdf", {"type": "measured_polarized"}),
    ("integrator", {"type": "bins", "bins": "lo:400:550"}),
    ("integrator", {"type": "nbins", "bins": "l550:550"}),
    ("integrator", {"type": "stokes"}),
    ("bsdf", {"type": "pplastic"}),
])
def test_types_outside_the_slice_raise(entry):
    """Kinds the port does not carry raise, naming the slice that brings
    them. The five polarized BSDFs and stokes are carried since slice 6e:
    they load (measured_polarized with its tables)."""
    kind, val = entry
    d = terrain_scene()
    if val["type"] in ("polarizer", "circular", "measured_polarized",
                       "stokes", "pplastic"):
        if val["type"] == "measured_polarized":
            val = dict(val, fields=synth_pbsdf())
        if kind == "bsdf":
            d["terrain"]["bsdf"] = val
        else:
            d["extra"] = val
        scene = load_dict(d, device="cpu")
        assert val["type"] in (scene.config.bsdf_kinds
                               + (scene.config.integrator.kind,))
        return
    if kind == "bsdf":
        d["terrain"]["bsdf"] = val
    elif kind == "texture":
        d["terrain"]["bsdf"] = {"type": "diffuse", "reflectance": val}
    elif kind == "rfilter":
        d["camera"]["film"]["rfilter"] = val
    elif kind == "film":
        d["camera"]["film"] = val
    else:
        d["extra"] = val
    with pytest.raises(NotImplementedError, match=r"slice (5c|6|7)"):
        load_dict(d, device="cpu")


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax nor the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['eradiate_kernel_tpu'] = None\n"
        "import eradiate_kernel_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert not [m for m in sys.modules if m.startswith('jax')\n"
        "            and sys.modules[m] is not None]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
