"""The port's sphere and disk families and shape sampling against the JAX
package on the same scene (loaded by both packages from one dict, its
arrays bit-equal) and the same numpy rays and samples.

Closest hits: ``t`` within 16 ulps of the reference's (both evaluate the
same float32 expressions, but XLA on the CPU contracts multiply-adds and
eager torch does not: a plane hit divides the ray origin's local z, a
dot product plus a translation that cancel, and there the rounding
difference grows to 11 ulps on these rays), the hit shape and primitive equal wherever the
hit is unique, and the surface interaction's p, n and uv within 1e-5.
Shape sampling (Shape::sample_position over the mesh, rectangle, disk and
sphere families): the same face picked for every sample (one
searchsorted over the same strictly increasing face-area cumsum; a
sample within 1e-6 of a cumsum edge may pick its neighbour, and then the
test allows it), positions, normals and uvs within 1e-5, pdfs within
rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_mesh import terrain
from eradiate_kernel_tpu.core.ray import Ray as JRay
from eradiate_kernel_tpu.render import geometry as jgeometry
from eradiate_kernel_tpu.render import shape_sampling as jshape_sampling
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch.core.ray import Ray
from eradiate_kernel_tpu_torch.render import geometry, shape_sampling
from eradiate_kernel_tpu_torch.scene import load_dict

ATOL = 1e-5


def shapes_dict():
    """Two spheres (one with inward normals), two disks and a rectangle,
    scaled and rotated, and a terrain(9) mesh under them."""
    V, F = terrain(9)
    return {
        "type": "scene",
        "ball": {"type": "sphere", "center": [0.3, -0.2, 0.6],
                 "radius": 0.35},
        "bubble": {"type": "sphere", "radius": 0.5, "flip_normals": True,
                   "to_world": [{"type": "scale", "value": 0.8},
                                {"type": "translate",
                                 "value": [-0.6, 0.4, 0.9]}]},
        "lid": {"type": "disk",
                "to_world": [{"type": "scale", "value": [0.4, 0.3, 1.0]},
                             {"type": "rotate", "axis": [1, 0, 0],
                              "angle": 30.0},
                             {"type": "translate",
                              "value": [0.5, 0.5, 1.2]}]},
        "coin": {"type": "disk",
                 "to_world": [{"type": "scale", "value": 0.25},
                              {"type": "translate",
                               "value": [-0.3, -0.5, 0.4]}]},
        "panel": {"type": "rectangle",
                  "to_world": [{"type": "scale", "value": [0.3, 0.2, 1.0]},
                               {"type": "rotate", "axis": [0, 1, 0],
                                "angle": -20.0},
                               {"type": "translate",
                                "value": [0.0, 0.6, 0.5]}]},
        "ground": {"type": "mesh", "vertices": V * np.float32([1, 1, 0.3]),
                   "faces": F},
        "sun": {"type": "directional"},
        "camera": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}}},
    }


@pytest.fixture(scope="module")
def scenes():
    d = shapes_dict()
    return jload_dict(d), load_dict(d, device="cpu")


def rays(n, seed):
    """Rays from above the shapes toward points spread over them."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.5, -1.5, 1.5], [1.5, 1.5, 2.5], (n, 3))
    tgt = rng.uniform([-1.0, -1.0, 0.0], [1.0, 1.0, 1.2], (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_scene_arrays_bit_equal(scenes):
    from test_torch_scene import reference_arrays

    jscene, scene = scenes
    ref = reference_arrays(jscene)
    arrays = scene.arrays()
    for name in ("geo.sph_center", "geo.sph_radius", "geo.sph_flip",
                 "geo.disk_to_world.m", "geo.disk_shape", "shape_area",
                 "face_area_cumsum", "shape_prim_slot", "bsphere_radius"):
        np.testing.assert_array_equal(arrays[name], ref[name], err_msg=name)
    for name, a in arrays.items():
        np.testing.assert_array_equal(a, ref[name], err_msg=name)


def test_sphere_and_disk_hits_match_reference(scenes):
    jscene, scene = scenes
    o, d = rays(4096, seed=1)
    # the brute-force families only: the mesh takes the tile sweep, whose
    # own tests hold it (tests/test_torch_intersect.py)
    jgeo = jscene.geo.replace(faces=jscene.geo.faces[:0])
    jpi = jgeometry.ray_intersect_preliminary(
        jgeo, JRay.make(jnp.asarray(o), jnp.asarray(d)))
    ray = Ray.make(torch.as_tensor(o), torch.as_tensor(d))
    pi = geometry.PreliminaryIntersection(
        *[torch.tensor(np.asarray(x)) for x in (
            jnp.full(o.shape[0], np.inf), jnp.zeros((o.shape[0], 2)),
            jnp.zeros(o.shape[0], jnp.int32),
            jnp.full(o.shape[0], -1, jnp.int32))])
    best = None
    for fn in (geometry._intersect_spheres, geometry._intersect_rects,
               geometry._intersect_disks):
        t, uv, prim, shape = fn(scene.geo, ray)
        closer = t < pi.t
        pi = geometry.PreliminaryIntersection(
            t=torch.where(closer, t, pi.t),
            prim_uv=torch.where(closer[:, None], uv, pi.prim_uv),
            prim_index=torch.where(closer, prim, pi.prim_index),
            shape_index=torch.where(closer, shape, pi.shape_index))
    rt = np.asarray(jpi.t)
    hit = np.isfinite(rt)
    assert 0.3 < hit.mean() < 0.95
    np.testing.assert_array_equal(np.isfinite(pi.t.numpy()), hit)
    ulp = np.spacing(np.abs(rt[hit]).astype(np.float32))
    n_ulp = np.abs(pi.t.numpy()[hit] - rt[hit]) / ulp
    assert n_ulp.max() <= 16, np.sort(n_ulp)[-10:]
    np.testing.assert_array_equal(pi.shape_index.numpy()[hit],
                                  np.asarray(jpi.shape_index)[hit])
    np.testing.assert_array_equal(pi.prim_index.numpy()[hit],
                                  np.asarray(jpi.prim_index)[hit])
    np.testing.assert_allclose(pi.prim_uv.numpy()[hit],
                               np.asarray(jpi.prim_uv)[hit], atol=ATOL)
    fams = scene.geo.shape_family[pi.shape_index.clamp(min=0)][
        torch.as_tensor(hit)]
    assert {int(f) for f in fams} == {geometry.FAMILY_SPHERE,
                                      geometry.FAMILY_RECT,
                                      geometry.FAMILY_DISK}

    # the surface interaction from the reference's preliminary hit
    jsi = jgeometry.compute_surface_interaction(
        jgeo, JRay.make(jnp.asarray(o), jnp.asarray(d)), jpi)
    si = geometry.compute_surface_interaction(
        scene.geo, ray, geometry.PreliminaryIntersection(
            *[torch.tensor(np.asarray(x)) for x in (
                jpi.t, jpi.prim_uv, jpi.prim_index, jpi.shape_index)]))
    for name in ("t", "p", "n", "uv", "dp_du", "dp_dv", "wi"):
        np.testing.assert_allclose(
            getattr(si, name).numpy()[hit],
            np.asarray(getattr(jsi, name))[hit], rtol=1e-5, atol=ATOL,
            err_msg=name)


def test_shape_sampling_matches_reference(scenes):
    jscene, scene = scenes
    rng = np.random.default_rng(2)
    n = 4096
    n_shapes = scene.shape_area.shape[0]
    idx = rng.integers(0, n_shapes, n).astype(np.int32)
    s1 = rng.random(n, dtype=np.float32)
    s2 = rng.random((n, 2), dtype=np.float32)
    jps = jshape_sampling.sample_position(
        jscene, jnp.asarray(idx), jnp.asarray(s1), jnp.asarray(s2))
    ps = shape_sampling.sample_position(
        scene, torch.as_tensor(idx), torch.as_tensor(s1),
        torch.as_tensor(s2))
    fam = scene.geo.shape_family.numpy()[idx]
    assert set(fam) == {geometry.FAMILY_MESH, geometry.FAMILY_SPHERE,
                        geometry.FAMILY_RECT, geometry.FAMILY_DISK}
    # a sample on a cumsum edge may pick the neighbouring face
    C = scene.face_area_cumsum.numpy()
    off = scene.shape_face_offset.numpy()[idx]
    cnt = scene.shape_face_count.numpy()[idx]
    lo = np.where(off > 0, C[np.maximum(off - 1, 0)], 0.0)
    target = lo + s1 * (C[off + np.maximum(cnt, 1) - 1] - lo)
    edge = np.abs(C[None, :] - target[:, None]).min(1) <= 1e-6 * C[-1]
    ok = ~((fam == geometry.FAMILY_MESH) & edge)
    assert ok.mean() > 0.99
    for name in ("p", "n", "uv"):
        np.testing.assert_allclose(getattr(ps, name).numpy()[ok],
                                   np.asarray(getattr(jps, name))[ok],
                                   rtol=1e-5, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(ps.pdf.numpy(), np.asarray(jps.pdf),
                               rtol=1e-6)
    np.testing.assert_allclose(
        shape_sampling.pdf_position(scene, torch.as_tensor(idx)).numpy(),
        np.asarray(jshape_sampling.pdf_position(jscene, jnp.asarray(idx))),
        rtol=1e-6)
