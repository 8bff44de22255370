"""The port's spectra, colour conversion and film development against the
JAX package's on the same seeded inputs: ``films.develop`` called
positionally, the CIE 1931 table and its lookup, Planck's law, the rgb and
mono bakes of the six measured and analytic spectrum kinds for
reflectances and emitters, the ``emitter`` flag through the texture and
emitter builders; and the 8x8 aerosol atmosphere under
``ff_majorant="segment"`` (the residual walk's collisions and the free
flight at the segment's one rate), rendered through both drivers and
differentiated (tests/test_torch_nee_modes.py's render_case), and its
films in the mono variant.

The bakes are float32 evaluations integrated in float64 and converted to
sRGB in float32, in both packages. They agree to within 6 ulps, not bit
for bit: torch's ``exp`` differs from XLA's by 1 ulp at about one in eight
of the 471 wavelengths (Planck's law, and D65 through it), and the 3x3
float32 XYZ -> sRGB product rounds differently in the two (XLA's CPU
product follows neither a sequential nor a fused order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from test_torch_nee_modes import (LANES, PARTS, SEED, SPP, aerosol_atmosphere,
                                  check_film, check_grad, one_torch_thread,
                                  render_case)
from test_torch_scene import reference_arrays
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.core import spectrum as jspectrum
from eradiate_kernel_tpu.core.types import Variant as JVariant
from eradiate_kernel_tpu.films import develop as jdevelop
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.scene.build import SceneBuilder as JSceneBuilder
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.core import spectrum
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.films import develop
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.scene.build import SceneBuilder

__all__ = ["one_torch_thread"]  # the module's autouse fixture

MAX_ULPS = 6


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("args", [("mono",), ("rgb", "xyz"),
                                  ("rgb", "rgba"), ("rgb", "luminance")],
                         ids=["mono", "xyz", "rgba", "luminance"])
def test_develop_positional_matches_reference(args):
    """develop(image, mode, pixel_format) called positionally, as the
    reference's signature reads, on one seeded film."""
    rng = np.random.default_rng(30)
    img = rng.random((4, 5, 5)).astype(np.float32)
    img[..., 4] += 0.5
    ref = np.asarray(jdevelop(jnp.asarray(img), *args))
    out = develop(torch.as_tensor(img), *args).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=2e-7, atol=0)


def test_cie_table_and_lookup_bit_equal():
    np.testing.assert_array_equal(spectrum.CIE_XYZ_TABLE,
                                  jspectrum.CIE_XYZ_TABLE)
    rng = np.random.default_rng(31)
    lam = np.concatenate([np.linspace(350, 840, 981),
                          rng.uniform(360, 830, 4096)]).astype(np.float32)
    np.testing.assert_array_equal(
        spectrum.cie1931_xyz(torch.as_tensor(lam)).numpy(),
        np.asarray(jspectrum.cie1931_xyz(jnp.asarray(lam))))


@pytest.mark.parametrize("temperature", [3000.0, 5800.0, 6504.0])
def test_blackbody_radiance_within_4_ulps(temperature):
    """Planck's law in float32 over 280-2400 nm: torch's exp is 1 ulp from
    XLA's at about one wavelength in ten, and exp(x) - 1 amplifies that
    ulp up to 4 at long wavelengths (x near 1); the rest of the expression
    rounds as the reference's (x ** 5 as XLA's integer power, divisions
    by tensors)."""
    lam = np.linspace(280, 2400, 4241).astype(np.float32)
    out = spectrum.blackbody_radiance(torch.as_tensor(lam),
                                      temperature).numpy()
    ref = np.asarray(jspectrum.blackbody_radiance(jnp.asarray(lam),
                                                  temperature))
    assert _ulps(out, ref) <= 4


_RNG = np.random.default_rng(32)
SPECTRA = {
    "d65": {"type": "d65", "scale": 1.5},
    "regular": {"type": "regular", "lambda_min": 400.0,
                "lambda_max": 750.0,
                "values": _RNG.uniform(0.1, 0.9, 12).tolist()},
    "irregular": {"type": "irregular",
                  "wavelengths": np.sort(_RNG.uniform(380, 800, 9)).tolist(),
                  "values": _RNG.uniform(0.1, 0.9, 9).tolist()},
    "blackbody": {"type": "blackbody", "temperature": 5800.0, "scale": 2.0},
    "srgb_d65": {"type": "srgb_d65", "value": [0.3, 0.5, 0.7]},
    "discrete": {"type": "discrete", "wavelengths": [450.0, 550.0],
                 "values": [0.3, 0.4]},
}


@pytest.mark.parametrize("emitter", [False, True],
                         ids=["reflectance", "emitter"])
@pytest.mark.parametrize("mode", ["rgb", "mono"])
@pytest.mark.parametrize("kind", list(SPECTRA))
def test_baked_rows_match_reference(kind, mode, emitter):
    ref_b, b = JSceneBuilder(JVariant(mode)), SceneBuilder(Variant(mode))
    assert b.spectrum(SPECTRA[kind], emitter) == ref_b.spectrum(
        SPECTRA[kind], emitter)
    ref = np.asarray(ref_b.spectra["baked"][-1]["value"])
    out = b.spectra["baked"][-1]["value"]
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert _ulps(out, ref) <= MAX_ULPS, (out, ref)
    assert (out > 0).all()


def test_emitter_flag_reaches_the_bakes():
    """A scene whose emitters (the sun, a point light, a constant sky) and
    surfaces take measured spectra: each emitter's spectrum bakes as
    radiance and each reflectance under D65, as in the reference (the
    spectra within the bakes' ulps, every other array bit for bit)."""
    irr = SPECTRA["irregular"]
    d = aerosol_atmosphere(sun=irr, ground={"rho_0": irr})
    d["lamp"] = {"type": "point", "position": [0.5, 0.5, 2.0],
                 "intensity": SPECTRA["regular"]}
    d["sky"] = {"type": "constant", "radiance": SPECTRA["regular"]}
    ref = reference_arrays(jload_dict(d))
    arrays = load_dict(d, device="cpu").arrays()
    for name, a in arrays.items():
        if name == "spectra.baked.value":
            assert _ulps(a, ref[name]) <= MAX_ULPS
        else:
            np.testing.assert_array_equal(a, ref[name], err_msg=name)
    rows = arrays["spectra.baked.value"]
    slot = arrays["spec_slot"]
    sun = rows[slot[arrays["emitters.directional.irradiance"][0]]]
    ground = rows[slot[arrays["textures.constant.spec"][
        arrays["bsdfs.rpv.rho_0"][0]]]]
    assert not np.allclose(sun, ground)  # radiance vs D65-weighted


# --- the segment majorant's render -------------------------------------------

def segment_atmosphere():
    """ff_majorant 'segment' with the residual walk; an srgb_d65 sun and a
    discrete spectrum for the RPV ground's k."""
    return aerosol_atmosphere(
        integrator={"ff_majorant": "segment"},
        sun={"type": "srgb_d65", "value": [1.1, 1.0, 0.8]},
        ground={"k": {"type": "discrete", "wavelengths": [500.0, 600.0],
                      "values": [0.3, 0.4]}}, seed=2)


@pytest.fixture(scope="module")
def case():
    return render_case(segment_atmosphere(), "volumes.gridvolume.grid")


@pytest.mark.parametrize("driver", ["scan", "pool"])
def test_segment_film_matches_reference(case, driver):
    check_film(case, driver)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("which", ["scan", "replay"])
def test_segment_grad_matches_reference(case, which, part):
    check_grad(case, which, part)


@pytest.fixture(scope="module")
def mono_films():
    """The segment scene in the mono variant (its measured spectra baked
    to luminance): the reference's lane-pool film and the port's through
    both drivers."""
    d = segment_atmosphere()
    run = jax.jit(jintegrators.render_wavefront_regen,
                  static_argnames=("n_lanes", "spp"))
    ref, _ = run(jload_dict(d, JVariant("mono")), LANES, SEED, SPP)
    scene = load_dict(d, Variant("mono"), device="cpu")
    return np.asarray(ref), {
        "scan": integrators.render(scene, seed=SEED, develop_film=False,
                                   samples_per_pass=LANES).numpy(),
        "pool": integrators.render(scene, seed=SEED, develop_film=False,
                                   regen=True,
                                   samples_per_pass=LANES).numpy()}


@pytest.mark.parametrize("driver", ["scan", "pool"])
def test_mono_segment_film_matches_reference(mono_films, driver):
    ref, films = mono_films
    film = films[driver]
    assert film.shape == ref.shape == (8, 8, 5)
    assert np.isfinite(film).all() and film[..., 1].mean() > 0.05
    assert_driver_equivalent(ref, film, max_flips=4)
