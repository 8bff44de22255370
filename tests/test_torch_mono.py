"""The mono variant of the port against the JAX package's: one radiance
channel, every spectrum baked to the luminance of its rgb, no hero-channel
draw in volpath, a film developed to its luminance.

- The scene arrays of the mono Cornell box and the mono atmosphere bit for
  bit, and the configs equal.
- The mono Cornell box (8x8) through the scan driver and the lane pool,
  within assert_driver_equivalent of the reference's mono films.
- The mono atmosphere (utils.scenes.atmosphere(sensor="distant"): a 1x1
  distant film) through both drivers against the reference's mono film
  (1e-5). The ground is lowered by 1e-3: as built it is coplanar with the
  atmosphere cube's bottom face, which every distant ray targets (ROADMAP
  Queue 3).
- The variants the port does not carry raise, naming slice 6.
"""

import numpy as np
import pytest
import torch

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu.core.types import Variant as JVariant
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import scenes as jscenes
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import scenes
from test_torch_scene import port_config, reference_arrays
from test_torch_sensors import one_torch_thread  # noqa: F401


def _atmosphere(factory):
    d = factory(spp=256, max_depth=8, grid_res=16, sensor="distant")
    d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
    return d


CASES = {
    "cornell box": (lambda f: f.cornell_box(8, 8, 8, 3), 2),
    "atmosphere": (lambda f: _atmosphere(f.atmosphere), 5),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def mono_case(request):
    make, seed = CASES[request.param]
    jscene = jload_dict(make(jscenes), JVariant("mono"))
    scene = load_dict(make(scenes), Variant("mono"), device="cpu")
    films = {regen: (np.asarray(jintegrators.render(
        jscene, seed=seed, regen=regen, samples_per_pass=64)),
        integrators.render(scene, seed=seed, regen=regen,
                           samples_per_pass=64).numpy())
        for regen in (False, True)}
    return request.param, jscene, scene, films


def test_mono_arrays_match_reference(mono_case):
    _name, jscene, scene, _films = mono_case
    ref = reference_arrays(jscene)
    assert scene.spectra["baked"]["value"].shape[-1] == 1
    for name, a in scene.arrays().items():
        assert a.shape == ref[name].shape, name
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    assert scene.config == port_config(jscene.config)


@pytest.mark.parametrize("regen", [False, True], ids=["scan", "pool"])
def test_mono_film_matches_reference(mono_case, regen):
    name, _jscene, scene, films = mono_case
    ref, img = films[regen]
    cfg = scene.config
    assert img.shape == (cfg.film_height, cfg.film_width, 1)
    assert np.isfinite(img).all() and img.mean() > 0.01
    if name == "atmosphere":
        np.testing.assert_allclose(img, ref, rtol=1e-5)
    else:
        assert_driver_equivalent(ref, img, max_flips=1)


@pytest.mark.parametrize("mode", ["spectral", "mono_double", "rgb_double"])
def test_variants_outside_the_port_raise(mode):
    if mode == "spectral":  # carried since slice 6c-1
        assert Variant(mode).n_channels == 4 and Variant(mode).is_spectral
    else:  # carried since slice 6d (tests/test_torch_double.py)
        assert Variant(mode).dtype == torch.float64
    # every variant is carried since slice 6e, the polarized ones too: the
    # flag is stored and read nowhere, as in the reference
    assert Variant(mode, polarized=True).polarized
    assert Variant("rgb", polarized=True) != Variant("rgb")
