"""The port's spectral variant, function by function, against the JAX
package on the same seeded numpy inputs: hero-wavelength sampling and the
CIE estimators, the rgb2spec fits, the spectrum registry (every kind,
out-of-support wavelengths included) and its importance sampling, the
sensors' srf sampling, the spectral volume lookups, the spectral scene
build, what slice 6c-2 ported (each once refused) and the film-type
repair.

Tolerances. The sampling and estimator functions are bit-equal. The
rgb2spec fits are not: torch's ``exp`` is 1 ulp from XLA's at some of the
95 wavelengths of D65 (Planck's law), so the CIE/D65 projection differs by
1e-8, and the float64 Gauss-Newton, which stops at a residual of 1e-10,
stops at coefficients 3e-6 apart relative to their size (1e-4 in the
batch fit, which stops at the first texel set under its bound). What the
fits are for agrees closely: the sigmoid spectra and the rgb they
reproduce within 1e-5 (the fit's own residual is up to 1e-5, and a
saturated colour's float32 coefficients near 50 round at 4e-6). So each
spectrum kind has its tolerance (``KIND_TOL``): the tabulated and uniform
kinds bit-equal; d65 and blackbody within 6 ulps (Planck's law through
torch's exp, as tests/test_torch_spectra.py finds for the bakes) and their
sampling tables within 2e-6; srgb and srgb_d65, the fitted kinds, within
the fit's tolerance. The volume lookups agree within 1e-6 on the
reference's packed grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nee_modes import one_torch_thread
from test_torch_scene import port_config, reference_arrays
from eradiate_kernel_tpu import sensors as jsensors
from eradiate_kernel_tpu.core import spectrum as jsp
from eradiate_kernel_tpu.core.rng import Sampler as JSampler
from eradiate_kernel_tpu.core.types import Variant as JVariant
from eradiate_kernel_tpu.render import texture as jtex
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.textures import volumes as jvol
from eradiate_kernel_tpu.utils import rgb2spec as jrgb2spec
from eradiate_kernel_tpu_torch import emitters, integrators, sensors
from eradiate_kernel_tpu_torch.core import spectrum as sp
from eradiate_kernel_tpu_torch.core.rng import Sampler
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.render import texture as tex
from eradiate_kernel_tpu_torch.scene import from_numpy, load_dict
from eradiate_kernel_tpu_torch.textures import volumes
from eradiate_kernel_tpu_torch.utils import rgb2spec
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

__all__ = ["one_torch_thread"]  # the module's autouse fixture

SPECTRAL = Variant("spectral")
N = 4096


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _both(d, mode="spectral"):
    return jload_dict(d, JVariant(mode)), load_dict(d, Variant(mode),
                                                     device="cpu")


def _cam(**extra):
    return {"type": "perspective", "film": {"width": 2, "height": 2},
            **extra}


# --- sampling and estimators ---------------------------------------------

def test_hero_sampling_and_estimators_bit_equal():
    rng = np.random.default_rng(40)
    u = rng.random(N).astype(np.float32)
    u[:4] = [0.0, 0.25, 0.75, np.nextafter(np.float32(1), 0)]
    for name in ("sample_shifted", "sample_wavelength",
                 "sample_uniform_spectrum", "sample_rgb_spectrum"):
        ref = getattr(jsp, name)(jnp.asarray(u))
        out = getattr(sp, name)(torch.as_tensor(u))
        for r, o in zip(ref if isinstance(ref, tuple) else (ref,),
                        out if isinstance(out, tuple) else (out,)):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r),
                                          err_msg=name)
    lam = rng.uniform(250, 2450, (N, 4)).astype(np.float32)
    lam[0] = [360.0, 830.0, 280.0, 2400.0]
    val = rng.random((N, 4)).astype(np.float32)
    jl, jv, tl, tv = (jnp.asarray(lam), jnp.asarray(val),
                      torch.as_tensor(lam), torch.as_tensor(val))
    for name in ("cie1931_xyz", "cie1931_y", "pdf_uniform_spectrum",
                 "pdf_uniform_spectrum_cie", "pdf_rgb_spectrum"):
        np.testing.assert_array_equal(getattr(sp, name)(tl).numpy(),
                                      np.asarray(getattr(jsp, name)(jl)),
                                      err_msg=name)
    np.testing.assert_array_equal(sp.spectrum_to_xyz(tv, tl).numpy(),
                                  np.asarray(jsp.spectrum_to_xyz(jv, jl)))
    np.testing.assert_array_equal(sp.luminance(tv, tl).numpy(),
                                  np.asarray(jsp.luminance(jv, jl)))
    assert (sp.WAVELENGTH_MIN, sp.WAVELENGTH_MAX, sp.N_HERO) == (
        jsp.WAVELENGTH_MIN, jsp.WAVELENGTH_MAX, jsp.N_HERO)


# --- rgb2spec --------------------------------------------------------------

def _model(c):
    c = np.asarray(c, np.float64)
    x = c[..., 0:1] * rgb2spec._LAM ** 2 + c[..., 1:2] * rgb2spec._LAM \
        + c[..., 2:3]
    return 0.5 * x / np.sqrt(1.0 + x * x) + 0.5


def _check_fits(out, ref, rtol):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-8)
    np.testing.assert_allclose(_model(out), _model(ref), atol=1e-5)
    P = rgb2spec._projection()
    np.testing.assert_allclose(_model(out) @ P.T, _model(ref) @ P.T,
                               atol=1e-5)


def test_rgb2spec_fits_match_reference():
    np.testing.assert_allclose(rgb2spec._projection(),
                               jrgb2spec._projection(), rtol=0, atol=2e-8)
    rng = np.random.default_rng(41)
    colours = [(0.95, 0.02, 0.02), (0.02, 0.9, 0.1), (0.05, 0.05, 0.95),
               (0.9, 0.9, 0.05), (0.5, 0.5, 0.5), (1e-4, 1e-4, 1e-4)]
    colours += [tuple(c) for c in rng.random((10, 3))]
    for c in colours:
        _check_fits(rgb2spec.fit_srgb_coeff(*c), jrgb2spec.fit_srgb_coeff(*c),
                    rtol=1e-5)
    texels = rng.random((256, 3))
    texels[:16] = [0.95, 0.02, 0.03]  # saturated: _fit_multistart polishes
    _check_fits(rgb2spec.fit_srgb_coeff_batch(texels),
                jrgb2spec.fit_srgb_coeff_batch(texels), rtol=1e-4)


# --- the spectrum registry ---------------------------------------------------

SPECTRA = {
    "uniform": 0.7,
    "regular": {"type": "regular", "lambda_min": 400.0, "lambda_max": 700.0,
                "values": [0.1, 0.9, 0.2, 0.5]},
    "irregular": {"type": "irregular",
                  "wavelengths": [300.0, 450.0, 460.0, 1200.0],
                  "values": [0.0, 2.0, 3.0, 0.1]},
    "srgb": [0.6, 0.3, 0.1],
    "blackbody": {"type": "blackbody", "temperature": 5500.0, "scale": 1e-3},
    "d65": {"type": "d65", "scale": 0.5},
    "srgb_d65": {"type": "srgb_d65", "value": [0.2, 0.4, 0.9]},
    "discrete": {"type": "discrete", "wavelengths": [500.0, 600.0, 700.0],
                 "values": [1.0, 3.0, 6.0]},
}


@pytest.fixture(scope="module")
def spectra_scenes():
    """One point light a spectrum kind (emitter spectra keep every kind)
    and a diffuse rectangle of an rgb reflectance (srgb)."""
    d = {"type": "scene", "sensor": _cam()}
    for i, (kind, v) in enumerate(SPECTRA.items()):
        if kind == "srgb":
            d["rect"] = {"type": "rectangle", "bsdf": {
                "type": "diffuse", "reflectance": v}}
        else:
            d[f"light{i}"] = {"type": "point", "intensity": v,
                              "position": [0, 0, i + 1.0]}
    return _both(d)


# (eval ulps or None, eval rtol, sampled wavelength rtol, weight rtol, pdf
# rtol) by kind; None: within rtol instead of ulps
KIND_TOL = {"uniform": (0, 0, 0, 0, 0), "regular": (0, 0, 0, 0, 0),
            "irregular": (0, 0, 0, 0, 0), "discrete": (0, 0, 0, 0, 0),
            "d65": (6, 0, 2e-6, 2e-6, 2e-6),
            "blackbody": (6, 0, 2e-6, 2e-6, 2e-6),
            "srgb": (None, 1e-3, 2e-6, 5e-4, 1e-4),
            "srgb_d65": (None, 2e-5, 2e-6, 5e-5, 2e-5)}


def _indices(scene, kinds_of):
    kinds = scene.config.spectrum_kinds
    sk = np.asarray(kinds_of)
    return {kinds[k]: i for i, k in reversed(list(enumerate(sk)))}


def test_spectral_scene_arrays_match_reference(spectra_scenes):
    """The spectral build keeps each kind with its sampling table: every
    array equal to the reference's but the srgb coefficients (the fit's
    tolerance) and the tables derived from them, D65 or Planck's law
    (within 2 ulps)."""
    jscene, scene = spectra_scenes
    assert scene.config.spectrum_kinds == jscene.config.spectrum_kinds
    assert set(scene.config.spectrum_kinds) == set(SPECTRA)
    ref = reference_arrays(jscene)
    for name, a in scene.arrays().items():
        if not name.startswith("spectra."):
            continue
        kind = name.split(".")[1]
        if name.endswith("coeff"):
            _check_fits(a, ref[name], rtol=1e-6)
        elif kind in ("srgb", "srgb_d65", "d65", "blackbody") and \
                a.dtype == np.float32:
            assert _ulps(a, ref[name]) <= 2 or np.allclose(
                a, ref[name], rtol=2e-6), name
        else:
            np.testing.assert_array_equal(a, ref[name], err_msg=name)


def test_spectrum_eval_every_kind(spectra_scenes):
    jscene, scene = spectra_scenes
    rng = np.random.default_rng(42)
    lam = rng.uniform(200, 2500, (N, 4)).astype(np.float32)  # out of range
    lam[:8] = [[399.9, 400.0, 700.0, 700.1], [299.0, 300.0, 1200.0, 1201.0],
               [500.0, 600.0, 700.0, 360.0], [280.0, 2400.0, 830.0, 831.0]] * 2
    for kind, i in _indices(scene, scene.spec_kind).items():
        idx = np.full(N, i, np.int32)
        ref = np.asarray(jtex.scene_spectrum_eval(jscene, jnp.asarray(idx),
                                                  jnp.asarray(lam)))
        out = tex.scene_spectrum_eval(scene, torch.as_tensor(idx),
                                      torch.as_tensor(lam)).numpy()
        ulps, rtol = KIND_TOL[kind][:2]
        if ulps is None:  # the fitted coefficients' tolerance
            np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-5,
                                       err_msg=kind)
        else:
            assert _ulps(out, ref) <= ulps, kind
        if kind in ("regular", "irregular", "discrete"):
            assert (out[8:] == 0).any() and (out == 0).sum() == (
                ref == 0).sum(), kind


def test_spectrum_sample_and_pdf(spectra_scenes):
    """spectrum_sample / spectrum_pdf of every kind (twin:
    tests/test_spectrum_sampling.py), and the weight is eval / pdf."""
    jscene, scene = spectra_scenes
    u = np.random.default_rng(43).random(N).astype(np.float32)
    for kind, i in _indices(scene, scene.spec_kind).items():
        idx = np.full(N, i, np.int32)
        jl, jw = jtex.scene_spectrum_sample(jscene, jnp.asarray(idx),
                                            jnp.asarray(u))
        tl, tw = tex.scene_spectrum_sample(scene, torch.as_tensor(idx),
                                           torch.as_tensor(u))
        _, _, rl, rw, rp = KIND_TOL[kind]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rl,
                                   err_msg=kind)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=rw,
                                   err_msg=kind)
        jp = jtex.scene_spectrum_pdf(jscene, jnp.asarray(idx), jl)
        tp = tex.scene_spectrum_pdf(scene, torch.as_tensor(idx),
                                    torch.as_tensor(np.array(jl)))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=rp,
                                   err_msg=kind)
        if kind == "discrete":
            assert set(np.unique(tl.numpy())) <= {500.0, 600.0, 700.0}
            assert np.all(tw.numpy() == 10.0) and np.all(tp.numpy() == 0)
        elif kind == "regular":  # unbiased: E[w] = the integral
            assert float(tw.mean()) == pytest.approx(140.0, rel=1e-3)


def test_texture_sample_spectrum():
    """texture_sample_spectrum / texture_pdf_spectrum over a constant and
    a bitmap texture (uniform sampling, weight = eval x range)."""
    img = np.random.default_rng(44).random((4, 4, 3)).astype(np.float32)
    d = {"type": "scene", "sensor": _cam(),
         "a": {"type": "rectangle", "bsdf": {
             "type": "diffuse", "reflectance": {
                 "type": "regular", "lambda_min": 450.0,
                 "lambda_max": 650.0, "values": [0.2, 1.0, 0.4]}}},
         "b": {"type": "rectangle", "bsdf": {
             "type": "diffuse", "reflectance": {"type": "bitmap",
                                                "data": img}}}}
    jscene, scene = _both(d)
    rng = np.random.default_rng(45)
    u = rng.random(N).astype(np.float32)
    uv = rng.random((N, 2)).astype(np.float32)
    tex_idx = np.arange(N, dtype=np.int32) % 2
    jl, jw = jtex.texture_sample_spectrum(
        jscene, jnp.asarray(tex_idx), jnp.asarray(uv), jnp.asarray(u),
        jnp.ones(N, bool))
    tl, tw = tex.texture_sample_spectrum(
        scene, torch.as_tensor(tex_idx), torch.as_tensor(uv),
        torch.as_tensor(u), torch.ones(N, dtype=torch.bool))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=2e-3)  # the bitmap's fitted texels
    jp = jtex.texture_pdf_spectrum(jscene, jnp.asarray(tex_idx),
                                   jnp.asarray(uv), jl)
    tp = tex.texture_pdf_spectrum(scene, torch.as_tensor(tex_idx),
                                  torch.as_tensor(uv),
                                  torch.as_tensor(np.array(jl)))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-6)


# --- srf sampling ------------------------------------------------------------

@pytest.mark.parametrize("srf", [
    {"type": "regular", "lambda_min": 500.0, "lambda_max": 600.0,
     "values": [1.0, 1.0]},
    {"type": "irregular", "wavelengths": [640.0, 665.0, 690.0],
     "values": [0.0, 1.0, 0.0]},
    {"type": "discrete", "wavelengths": [440.0, 550.0, 660.0],
     "values": [1.0, 2.0, 1.0]},
], ids=["regular", "triangle", "lines"])
def test_srf_sampling(srf):
    """_sample_srf and _sample_srf_lines through sample_ray (twins:
    tests/test_sensors.py:139, tests/test_shapes_spectra.py:134): the same
    wavelengths and weights as the reference's on the same streams."""
    d = {"type": "scene", "sensor": _cam(srf=srf),
         "env": {"type": "constant", "radiance": 1.0}}
    jscene, scene = _both(d)
    n = N
    lanes = np.arange(n)
    jray, jw, _ = jsensors.sample_ray(
        jscene, JSampler.seed(0, jnp.asarray(lanes, jnp.uint32)),
        jnp.full((n, 2), 0.5), jnp.zeros(n))
    ray, w, _ = sensors.sample_ray(
        scene, Sampler.seed(0, torch.as_tensor(lanes)),
        torch.full((n, 2), 0.5), torch.zeros(n))
    assert ray.wavelengths.shape == (n, 4)
    np.testing.assert_allclose(ray.wavelengths.numpy(),
                               np.asarray(jray.wavelengths), rtol=1e-6)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    if srf["type"] == "discrete":
        wl = ray.wavelengths.numpy().ravel()
        assert set(np.unique(wl)) <= {440.0, 550.0, 660.0}
        assert np.all(w.numpy() == 4.0)


# --- spectral volumes --------------------------------------------------------

def _grid_scene(volume, albedo=0.5):
    return {"type": "scene", "sensor": _cam(),
            "bound": {"type": "cube",
                      "to_world": [{"type": "scale", "value": 0.5},
                                   {"type": "translate",
                                    "value": [0.5, 0.5, 0.5]}],
                      "bsdf": {"type": "null"},
                      "interior": {"type": "heterogeneous",
                                   "sigma_t": volume, "albedo": albedo}}}


def _vol_index(scene, kind):
    kinds = scene.config.volume_kinds
    return [i for i, k in enumerate(np.asarray(scene.vol_kind))
            if kinds[k] == kind][0]


@pytest.mark.parametrize("case", ["srgb", "srgb_large", "srgb_nearest",
                                  "spectral", "spectral_large"])
def test_spectral_volume_lookups(case):
    """volume_eval of gridvolume_srgb (8x8 and 17x16x16: the gather entry's
    32-float rows at any size), the srgb-packed nearest grid and
    gridvolume_spectral (einsum and, above 4,096 voxels, the fused
    trilinear entry) at seeded points (twins: tests/
    test_gridvolume_srgb.py, tests/test_volfile_filters.py:134,
    tests/test_regression.py:270)."""
    rng = np.random.default_rng(46)
    shape = (17, 16, 16) if case.endswith("large") else (3, 4, 5)
    if case.startswith("srgb"):
        data = rng.uniform(0.05, 2.5, shape + (3,)).astype(np.float32)
        vol = {"type": "gridvolume", "data": data}
        if case == "srgb_nearest":
            vol["filter_type"] = "nearest"
        kind = ("gridvolume_nearest" if case == "srgb_nearest"
                else "gridvolume_srgb")
    else:
        data = rng.uniform(0.1, 2.0, shape + (6,)).astype(np.float32)
        vol = {"type": "gridvolume_spectral", "data": data,
               "lambda_min": 400.0, "lambda_max": 800.0}
        kind = "gridvolume_spectral"
    jscene, scene = _both(_grid_scene(vol))
    assert kind in scene.config.volume_kinds
    if kind == "gridvolume_srgb":
        assert scene.volumes[kind]["grid"].shape[-1] == 4
        assert "gridvolume_srgb" in scene.vol_packed_spectral
    if case == "spectral_large":
        assert "gridvolume_spectral" in scene.vol_packed_spectral
    # the packed grid's values: coefficients within the fit's tolerance,
    # scales bit-equal
    ref_grid = np.asarray(jscene.volumes[kind]["grid"])
    grid = scene.volumes[kind]["grid"].numpy()
    if case.startswith("srgb"):
        np.testing.assert_array_equal(grid[..., 3], ref_grid[..., 3])
        np.testing.assert_allclose(_model(grid[..., :3]),
                                   _model(ref_grid[..., :3]), atol=1e-5)
        # the reference's packed grid, carried across, checks the lookup
        # itself at 1e-6
        scene = from_numpy(reference_arrays(jscene),
                           port_config(jscene.config), device="cpu")
    n = 2048
    p = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    lam = rng.uniform(350, 850, (n, 4)).astype(np.float32)
    vidx = np.full(n, _vol_index(scene, kind), np.int32)
    ref = np.asarray(jvol.volume_eval(jscene, jnp.asarray(vidx),
                                      jnp.asarray(p), jnp.asarray(lam)))
    out = volumes.volume_eval(scene, torch.as_tensor(vidx),
                              torch.as_tensor(p),
                              torch.as_tensor(lam)).numpy()
    assert out.shape == (n, 4) and np.count_nonzero(ref) > n
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


# --- what slice 6c-2 ported (once refused) and the film repair ------------

def _atmo(**kw):
    d = atmosphere(spp=4, max_depth=4, grid_res=8, sensor="distant")
    d.update(kw)
    return d


@pytest.mark.parametrize("case", ["volpathmis", "aov", "moment", "measured",
                                  "emitter_ray", "grad_scan", "grad_pool"])
def test_spectral_refusals_name_6c2(case):
    """Each case slice 6c-1 refused naming slice 6c-2 now runs in spectral:
    volpathmis, aov and moment render finite films with their AOV columns
    on the lane pool, a measured ground loads and renders, emission rays
    carry 4 wavelengths and a weight a wavelength, and the twin of
    tests/test_autodiff.py:348 (a grid that requires a gradient) takes a
    finite, non-zero gradient on either driver."""
    from test_measured import synth_fields

    d = _atmo()
    d["sensor"]["sampler"]["sample_count"] = 16
    # off the ground's tie with the cube's floor, where the distant sensor
    # aims (ROADMAP Queue 3)
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    if case == "volpathmis":
        d["integrator"] = {"type": "volpathmis", "max_depth": 4}
    elif case in ("aov", "moment"):
        d["integrator"] = {"type": case, "aovs": "dd:depth",
                           "child": {"type": "volpath", "max_depth": 4}}
    elif case == "measured":
        d["surface"]["bsdf"] = {"type": "measured", "fields": synth_fields(
            T=4, L=3, res=9, seed=1)}
    scene = load_dict(d, SPECTRAL, device="cpu")
    if case in ("volpathmis", "aov", "moment", "measured"):
        # the lane pool (both drivers against the reference:
        # tests/test_torch_spectral_wrappers.py)
        film = integrators.render(scene, seed=1, develop_film=False,
                                  regen=True, samples_per_pass=16)
        assert film.shape == (1, 1, 5 + integrators.n_aov(scene.config))
        assert bool(torch.isfinite(film).all()) and float(film[..., 1]) > 0
        return
    if case == "emitter_ray":
        ray, w, idx, _ = emitters.sample_emitter_ray(
            scene, Sampler.seed(0, torch.arange(8)), 0.0)
        assert ray.wavelengths.shape == w.shape == (8, 4)
        assert bool((w > 0).all()) and bool((idx == 0).all())
        return
    # the twin of tests/test_autodiff.py:348 (the reference differentiates)
    grid = scene.volumes["gridvolume"]["grid"].clone().requires_grad_(True)
    sc = scene.with_tensors({"volumes.gridvolume.grid": grid})
    integrators.render(sc, regen=case == "grad_pool",
                       samples_per_pass=16).mean().backward()
    assert bool(torch.isfinite(grid.grad).all())
    assert float(grid.grad.abs().sum()) > 0


def test_bins_outside_spectral_raise():
    d = _atmo(integrator={"type": "bins", "bins": "a:400:500",
                          "child": {"type": "volpath"}})
    with pytest.raises(NotImplementedError, match="spectral"):
        load_dict(d, Variant("rgb"), device="cpu")


def test_film_of_any_type_reads_as_the_reference():
    """A sensor dict's film is read whatever its type, as the reference
    reads it (a specfilm renders as an hdrfilm): the config equals the
    reference's, in rgb and spectral."""
    d = atmosphere(4, 3, spp=2, max_depth=4, grid_res=8)
    d["sensor"]["film"] = {"type": "specfilm", "width": 5, "height": 3,
                           "pixel_format": "rgba",
                           "rfilter": {"type": "tent"}}
    for mode in ("rgb", "spectral"):
        jscene, scene = _both(d, mode)
        assert scene.config == port_config(jscene.config)
        assert (scene.config.film_width, scene.config.film_height,
                scene.config.rfilter, scene.config.pixel_format) == (
            5, 3, "tent", "rgba")
        img = integrators.render(scene, spp=1)
        assert img.shape == (3, 5, 4) and torch.isfinite(img).all()


XML_SPECTRAL = """<scene version="2.0.0">
  <integrator type="bins">
    <string name="bins" value="a:400:500,b:500:700"/>
    <integrator type="path"><integer name="max_depth" value="2"/></integrator>
  </integrator>
  <sensor type="perspective">
    <spectrum name="srf" value="450:0.0, 550:1.0, 650:0.2"/>
    <film type="specfilm">
      <integer name="width" value="3"/><integer name="height" value="2"/>
    </film>
  </sensor>
  <shape type="rectangle">
    <bsdf type="diffuse">
      <spectrum name="reflectance" value="400:0.1, 500:0.6, 700:0.3"/>
    </bsdf>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="0.5, 0.7, 1.0"/>
  </emitter>
</scene>"""


def test_spectral_xml_loads_as_the_reference():
    """An XML scene of the slice (bins, an srf, a spectrum reflectance, an
    rgb sky) in spectral: the reference's config and arrays (XML keeps only
    an hdrfilm as the film, as the reference's parser does)."""
    from eradiate_kernel_tpu.scene.xml import load_string as jload_string
    from eradiate_kernel_tpu_torch.scene.xml import load_string

    jscene = jload_string(XML_SPECTRAL, JVariant("spectral"))
    scene = load_string(XML_SPECTRAL, SPECTRAL, device="cpu")
    assert scene.config == port_config(jscene.config)
    assert scene.config.integrator.kind == "bins"
    ref = reference_arrays(jscene)
    for name, a in scene.arrays().items():
        if "coeff" in name:
            _check_fits(a, ref[name], rtol=1e-5)
        elif name.startswith("spectra.srgb_d65"):
            np.testing.assert_allclose(a, ref[name], rtol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, ref[name], err_msg=name)
    assert "sensor.srf_nodes" in ref
