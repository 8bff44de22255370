"""volpath's other transmittance estimators and majorants in the port
against the JAX package on the same seeded inputs: the Gauss-Legendre
optical depth of a 3D grid, the segment majorant's free flight and
residual collisions, the nearest-filter lookup, the ``.vol`` codec and
``use_grid_bbox``; and an 8x8 atmosphere with an 8x8x8 grid and an
aerosol and a sky under ``nee_transmittance="track"`` (the NEE walk and
the MIS walk ratio-tracked), rendered through both drivers and
differentiated.

The render cases of this file, tests/test_torch_phases.py ("quadrature",
a nearest grid read from a .vol file) and tests/test_torch_spectra.py
(``ff_majorant="segment"``) share ``aerosol_atmosphere`` and
``render_case``: each file renders its own case once (module-scoped
fixture), so that the reference's compiles spread over three workers.
The atmosphere's ground is lowered by 1e-3 (tests/test_torch_volpath.py's
docstring). Films are held to the reference's lane-pool film within
assert_driver_equivalent's budget (4 pixels, as test_torch_volpath's);
gradients of the mean to jax.grad through the reference's scan driver at
rtol 5e-3 and atol 1e-7 (tests/test_torch_replay.py's figure), and the
path replay's to the port's scan driver's. The spectrum is compared on
the sun's row (the RPV rows' gradients are NaN in the reference; see
tests/test_torch_replay.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from test_torch_media import _close as _close_media
from test_torch_media import _rays, _segments
from test_torch_scene import reference_arrays
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu import media as jmedia
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.textures.volumes import volume_eval as jvolume_eval
from eradiate_kernel_tpu.utils import autodiff as jad
from eradiate_kernel_tpu.utils import volfile as jvolfile
from eradiate_kernel_tpu_torch import integrators, media
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.textures.volumes import volume_eval
from eradiate_kernel_tpu_torch.utils import autodiff, volfile
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

SEED, SPP, LANES = 5, 4, 64
RTOL, ATOL = 5e-3, 1e-7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (tests/test_torch_sensors.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hg_table(g, n=181):
    """A Henyey-Greenstein phase function tabulated on n uniform cosines
    of the scattering angle (a tabphase's ``values``)."""
    mu = np.linspace(-1.0, 1.0, n)
    return ((1 - g * g) / (1 + g * g - 2 * g * mu) ** 1.5
            / (4 * np.pi)).tolist()


def aerosol_phase(weight=0.3, g=0.7):
    """Rayleigh mixed with a 181-node tabulated HG aerosol."""
    return {"type": "blendphase", "weight": weight,
            "rayleigh": {"type": "rayleigh"},
            "aerosol": {"type": "tabphase", "values": hg_table(g)}}


def aerosol_atmosphere(integrator=(), sigma_t=None, sun=None, ground=None,
                       phase=None, seed=0):
    """The 8x8 atmosphere (spp 4, max_depth 6) with a seeded 8x8x8 sigma_t
    grid, an aerosol phase, a sun spectrum and ground spectra; ground
    lowered by 1e-3. ``integrator``: extra integrator properties;
    ``sigma_t``: extra gridvolume properties (or a replacement dict)."""
    rng = np.random.default_rng(seed)
    d = atmosphere(8, 8, SPP, 6, grid_res=(8, 8, 8))
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    interior = d["atmo"]["interior"]
    grid = interior["sigma_t"]
    grid["data"] = (grid["data"] * (0.7 + 0.6 * rng.random((8, 8, 8)))
                    ).astype(np.float32)
    if sigma_t is not None:
        grid.update(sigma_t)
    interior["phase"] = phase or aerosol_phase()
    if sun is not None:
        d["sun"]["irradiance"] = sun
    d["surface"]["bsdf"].update(ground or {})
    d["integrator"].update(dict(integrator))
    return d


def _sun_row(scene):
    a = {k: v.detach().numpy() for k, v in scene.tensors().items()}
    return int(a["spec_slot"][a["emitters.directional.irradiance"][0]])


def render_case(d, grid_key):
    """Films and gradients of scene dict ``d``: the reference's lane-pool
    film and its jax.grad through the scan driver; the port's films
    through both drivers and its gradients through the scan driver and
    the path replay. Gradients of the mean by the sigma_t grid, the
    albedo (a constvolume) and the sun's spectrum row."""
    keys = [grid_key, "volumes.constvolume.value", "spectra.baked.value"]
    jscene = jload_dict(d)
    run = jax.jit(jintegrators.render_wavefront_regen,
                  static_argnames=("n_lanes", "spp"))
    ref_film, _ = run(jscene, LANES, SEED, SPP)
    pm = jad.traverse(jscene)
    pm.keep(keys)
    tr0 = pm.trainable()
    g = jax.grad(lambda tr: jnp.mean(jintegrators.render(
        pm.with_trainable(tr), seed=SEED, samples_per_pass=LANES,
        regen=False)))(tr0)

    scene = load_dict(d, device="cpu")
    sun = _sun_row(scene)

    def parts(grads):
        return {"sigma_t grid": grads[keys[0]], "albedo": grads[keys[1]],
                "sun": grads[keys[2]][sun]}

    def port_grads(regen):
        ppm = autodiff.traverse(scene).keep(keys)
        params = ppm.trainable()
        integrators.render(ppm.with_trainable(params), seed=SEED,
                           samples_per_pass=LANES, regen=regen).mean() \
            .backward()
        return parts({k: p.grad.numpy() for k, p in params.items()})

    return {
        "scene": scene, "ref_film": np.asarray(ref_film),
        "scan": integrators.render(scene, seed=SEED, develop_film=False,
                                   samples_per_pass=LANES).numpy(),
        "pool": integrators.render(scene, seed=SEED, develop_film=False,
                                   regen=True,
                                   samples_per_pass=LANES).numpy(),
        "ref_grads": parts({k: np.asarray(g[k]) for k in keys}),
        "scan_grads": port_grads(False), "replay_grads": port_grads(True)}


PARTS = ["sigma_t grid", "albedo", "sun"]


def check_film(case, driver):
    film = case[driver]
    assert film.shape == case["ref_film"].shape == (8, 8, 5)
    assert np.isfinite(film).all() and film[..., :3].mean() > 0.05
    np.testing.assert_array_equal(film[..., 4], SPP)
    assert_driver_equivalent(case["ref_film"], film, max_flips=4)


def check_grad(case, which, part):
    a = case[which + "_grads"][part]
    b = (case["ref_grads"] if which == "scan" else case["scan_grads"])[part]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.abs(b).sum() > 0, part
    assert np.allclose(a, b, rtol=RTOL, atol=ATOL), \
        (part, np.abs(a - b).max(), np.abs(b).max())


# --- the tracked walk's render ---------------------------------------------

@pytest.fixture(scope="module")
def case():
    """nee_transmittance 'track': a blendphase aerosol, a blackbody sun, an
    irregular ground reflectance and a constant sky (so that the MIS walk
    of the BSDF-sampled rays runs too, ratio-tracked)."""
    d = aerosol_atmosphere(
        integrator={"nee_transmittance": "track"},
        sun={"type": "blackbody", "temperature": 5800.0, "scale": 2e-5},
        ground={"rho_0": {"type": "irregular",
                          "wavelengths": [400.0, 480.0, 560.0, 700.0],
                          "values": [0.05, 0.12, 0.2, 0.35]}})
    d["sky"] = {"type": "constant", "radiance": 0.1}
    return render_case(d, "volumes.gridvolume.grid")


@pytest.mark.parametrize("driver", ["scan", "pool"])
def test_track_film_matches_reference(case, driver):
    check_film(case, driver)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("which", ["scan", "replay"])
def test_track_grad_matches_reference(case, which, part):
    check_grad(case, which, part)


# --- unit pieces -----------------------------------------------------------

_SCENES = {}


def _scenes(ff="profile"):
    """(reference, port) scenes of the 8^3 aerosol atmosphere."""
    if ff not in _SCENES:
        d = aerosol_atmosphere(integrator={"ff_majorant": ff})
        _SCENES[ff] = (jload_dict(d), load_dict(d, device="cpu"))
    return _SCENES[ff]


def test_gauss_legendre_tau_of_a_3d_grid():
    """medium_tau_segment of a 3D grid: Gauss-Legendre quadrature with 8
    and 3 nodes, at rtol 1e-6 (XLA contracts the node positions' and the
    weighted sum's multiply-adds)."""
    jscene, scene = _scenes()
    assert not scene.config.het_profile1d
    n = 1024
    jray, pray = _rays(n, 12)
    a, b = _segments(n, 12)
    med = np.zeros(n, np.int32)
    for k in (8, 3):
        ref = np.asarray(jmedia.medium_tau_segment(
            jscene, jnp.asarray(med), jray, jnp.asarray(a), jnp.asarray(b),
            jray.wavelengths, quad_points=k))
        out = media.medium_tau_segment(
            scene, torch.as_tensor(med), pray, torch.as_tensor(a),
            torch.as_tensor(b), pray.wavelengths, quad_points=k).numpy()
        assert ref.max() > 0.01
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_segment_majorant_flight_and_residuals():
    """ff_majorant 'segment': sample_interaction flies against the
    segment's one majorant, and the residual walk's collisions come at the
    segment's one residual rate (medium_residual_rate)."""
    jscene, scene = _scenes("segment")
    n = 1024
    rng = np.random.default_rng(13)
    jray, pray = _rays(n, 13)
    xi = rng.random(n).astype(np.float32)
    ch = rng.integers(0, 3, n).astype(np.int32)
    active = rng.random(n) < 0.9
    med = np.zeros(n, np.int32)
    jm, pm = jnp.asarray(med), torch.as_tensor(med)
    ref = jmedia.sample_interaction(jscene, jm, jray, jnp.asarray(xi),
                                    jnp.asarray(ch), jnp.asarray(active))
    mi = media.sample_interaction(scene, pm, pray, torch.as_tensor(xi),
                                  torch.as_tensor(ch),
                                  torch.as_tensor(active))
    assert not np.asarray(ref.ff_on).any()
    assert np.asarray(ref.is_valid).sum() > n // 4
    for f in dataclasses.fields(mi):
        a, b = getattr(mi, f.name).numpy(), np.asarray(getattr(ref, f.name))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            _close_media(a, b, f.name)
    a, b = _segments(n, 14)
    args = (jray, jnp.asarray(a), jnp.asarray(b))
    pargs = (pray, torch.as_tensor(a), torch.as_tensor(b))
    _close_media(media.medium_residual_rate(scene, pm, *pargs),
                 jmedia.medium_residual_rate(jscene, jm, *args), "rate")
    ref = jmedia.medium_residual_sample(jscene, jm, *args, jnp.asarray(xi))
    out = media.medium_residual_sample(scene, pm, *pargs,
                                       torch.as_tensor(xi))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    assert np.asarray(ref[0]).any()
    for k, name in ((1, "dt"), (2, "rate")):
        _close_media(out[k], ref[k], name)


def _vol_scene(grid):
    """A cube of heterogeneous medium whose sigma_t is ``grid`` (the
    scene of tests/test_volfile_filters.py)."""
    d = {"type": "scene",
         "sensor": {"type": "perspective", "film": {"width": 2,
                                                    "height": 2}},
         "bound": {"type": "cube", "bsdf": {"type": "null"},
                   "interior": {"type": "heterogeneous", "sigma_t": grid,
                                "albedo": 0.5}}}
    return jload_dict(d), load_dict(d, device="cpu")


def _lookup(scenes, kind, pts):
    """volume_eval of both packages at ``pts`` on the first volume of
    ``kind`` -> (port, reference), bit for bit comparable."""
    jscene, scene = scenes
    kinds = scene.config.volume_kinds
    gi = [i for i, k in enumerate(scene.vol_kind.tolist())
          if kinds[k] == kind][0]
    n = len(pts)
    pts = np.asarray(pts, np.float32)
    ref = np.asarray(jvolume_eval(jscene, jnp.full(n, gi, jnp.int32),
                                  jnp.asarray(pts), jnp.zeros((n, 0))))
    out = volume_eval(scene, torch.full((n,), gi, dtype=torch.int32),
                      torch.as_tensor(pts)).numpy()
    return out, ref


def test_nearest_lookup_bit_equal():
    """filter_type 'nearest' (test_volfile_filters.py::test_nearest_filter):
    the voxel values and the hard edge at the voxel boundary, and a seeded
    3-channel 5x6x7 grid at seeded points, bit for bit."""
    data = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    scenes = _vol_scene({"type": "gridvolume", "data": data,
                         "filter_type": "nearest"})
    out, ref = _lookup(scenes, "gridvolume_nearest",
                       [[0.25, 0.25, 0.25], [0.75, 0.25, 0.25],
                        [0.25, 0.75, 0.75], [0.49, 0.25, 0.25],
                        [0.51, 0.25, 0.25]])
    np.testing.assert_array_equal(out[:, 0], [0, 1, 6, 0, 1])
    np.testing.assert_array_equal(out, ref)
    rng = np.random.default_rng(15)
    for wrap in ("clamp", "repeat", "mirror"):
        scenes = _vol_scene({"type": "gridvolume", "filter_type": "nearest",
                             "wrap_mode": wrap,
                             "data": rng.random((5, 6, 7, 3))
                             .astype(np.float32)})
        out, ref = _lookup(scenes, "gridvolume_nearest",
                           rng.uniform(-0.5, 1.5, (2048, 3)))
        np.testing.assert_array_equal(out, ref)
        assert (out > 0).any()


def test_nearest_lookup_gradient():
    """The nearest lookup's gradient with respect to the grid
    (volumes.NearestGather: a scatter-add of the cotangent into the voxels
    read) against jax.grad of the reference's lookup."""
    rng = np.random.default_rng(16)
    grid = rng.random((5, 6, 7)).astype(np.float32)
    jscene, scene = _vol_scene({"type": "gridvolume", "data": grid,
                                "filter_type": "nearest"})
    pts = rng.uniform(0.0, 1.0, (512, 3)).astype(np.float32)
    ct = rng.random((512, 3)).astype(np.float32)
    key = "volumes.gridvolume_nearest.grid"
    pm = jad.traverse(jscene)
    pm.keep([key])
    tr0 = pm.trainable()
    n = len(pts)

    def loss(tr):
        s = pm.with_trainable(tr)
        return jnp.sum(jvolume_eval(s, jnp.zeros(n, jnp.int32),
                                    jnp.asarray(pts), jnp.zeros((n, 0)))
                       * jnp.asarray(ct))

    ref = np.asarray(jax.grad(loss)(tr0)[key])
    ppm = autodiff.traverse(scene).keep([key])
    params = ppm.trainable()
    out = volume_eval(ppm.with_trainable(params),
                      torch.zeros(n, dtype=torch.int32), torch.as_tensor(pts))
    (out * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(params[key].grad.numpy(), ref, rtol=1e-6,
                               atol=1e-6)
    assert np.abs(ref).sum() > 0


def test_vol_roundtrip_and_layout(tmp_path):
    """The port's .vol codec reads and writes the reference's files bit for
    bit (test_volfile_filters.py::test_vol_roundtrip, _layout_x_fastest)."""
    rng = np.random.default_rng(0)
    data = rng.uniform(0, 3, (5, 4, 3, 1)).astype(np.float32)
    bbox = ((-1, 0, 2), (3, 5, 7))
    ours, theirs = str(tmp_path / "p.vol"), str(tmp_path / "j.vol")
    volfile.write_vol(ours, data, bbox=bbox)
    jvolfile.write_vol(theirs, data, bbox=bbox)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back, bb = volfile.read_vol(theirs)
    np.testing.assert_array_equal(back, data)
    np.testing.assert_array_equal(bb, [[-1, 0, 2], [3, 5, 7]])
    with open(ours, "r+b") as f:
        f.seek(3)
        f.write(b"\x02")
    with pytest.raises(ValueError, match="version"):
        volfile.read_vol(ours)
    import struct
    axis = str(tmp_path / "axis.vol")
    with open(axis, "wb") as f:
        f.write(struct.pack("<3sB5i6f", b"VOL", 3, 1, 2, 1, 1, 1,
                            0, 0, 0, 1, 1, 1) + struct.pack("<2f", 10., 20.))
    data, _ = volfile.read_vol(axis)
    assert data.shape == (1, 1, 2, 1)
    assert data[0, 0, 0, 0] == 10.0 and data[0, 0, 1, 0] == 20.0


@pytest.mark.parametrize("filter_type", ["trilinear", "nearest"])
def test_gridvolume_from_file_use_grid_bbox(tmp_path, filter_type):
    """A .vol file with use_grid_bbox (test_volfile_filters.py's case): the
    file's bbox [1, 3]^3 maps onto the unit cube, so world (2, 2, 2) reads
    the grid's centre; the scene arrays and lookups are the reference's,
    bit for bit."""
    z = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    data = np.broadcast_to(z[:, None, None], (5, 5, 5)).copy()
    path = str(tmp_path / "g.vol")
    volfile.write_vol(path, data, bbox=((1, 1, 1), (3, 3, 3)))
    scenes = _vol_scene({"type": "gridvolume", "filename": path,
                         "use_grid_bbox": True, "filter_type": filter_type})
    kind = {"trilinear": "gridvolume",
            "nearest": "gridvolume_nearest"}[filter_type]
    pts = [[2.0, 2.0, 2.0], [2.0, 2.0, 1.0], [2.0, 2.0, 2.9],
           [1.5, 2.5, 2.2]]
    out, ref = _lookup(scenes, kind, pts)
    np.testing.assert_array_equal(out, ref)
    if filter_type == "trilinear":
        np.testing.assert_allclose(out[:3, 0], [0.5, 0.0, 0.95], atol=1e-6)
    jarr = reference_arrays(scenes[0])
    for name, a in scenes[1].arrays().items():
        if name.startswith(("volumes.", "media.")):
            np.testing.assert_array_equal(a, jarr[name], err_msg=name)
