"""The BSDFs' transport mode (slice 7d): both modes of the port's kinds,
wrappers and dispatchers against the JAX package's, on the same numpy
inputs made from a seed.

- (a) the six kinds whose result depends on the mode (conductor,
  dielectric, roughconductor, roughdielectric, pplastic,
  measured_polarized), each in RADIANCE and IMPORTANCE: ``sample``,
  ``eval_pdf``, and ``eval_mueller`` or ``sample_mueller_weight`` where
  the kind has one, against the reference's on 1,024 seeded
  interactions, within tests/test_torch_polarized_bsdfs.py's (b) budget
  (tests/test_torch_measured.py::budget: rtol 1e-5, atol 1e-6, but for
  1 % of the rows, which must agree within 5e-3 but for 0.1 %);
- (b) IMPORTANCE differs from RADIANCE exactly where the reference's
  does: on each output the mode acts on (the reference's 19 sites), a
  row differs between the modes in the port (by more than rtol 1e-5,
  atol 1e-6) if and only if it does in the reference, but for 0.1 % of
  the rows (the budget's decision flips); every other output of these
  kinds, and every output of the other kinds, is bit-equal in both
  modes;
- (c) the wrappers hand the mode to their nested BSDF (blendbsdf, mask,
  normalmap, bumpmap over dielectrics), and the six dispatchers of
  bsdfs/__init__.py take it, against the reference's in IMPORTANCE
  within (a)'s budget.

The reference runs eagerly on small arrays: the file takes ~20 s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu import bsdfs as jbsdfs
from eradiate_kernel_tpu.bsdfs import common as jcommon
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch import bsdfs
from eradiate_kernel_tpu_torch.bsdfs import common
from eradiate_kernel_tpu_torch.scene import load_dict
from test_torch_measured import budget
from test_torch_nee_modes import one_torch_thread  # noqa: F401 (fixture)
from test_torch_polarized_bsdfs import KINDS, _slots, draws, interactions

N = 1024
T = torch.as_tensor
J = jnp.asarray
MODES = (common.RADIANCE, common.IMPORTANCE)
MODE_KINDS = ("conductor", "dielectric", "roughconductor", "roughdielectric",
              "pplastic", "measured_polarized")
GLASS = {"type": "dielectric", "int_ior": 1.33}
ROUGH_GLASS = {"type": "roughdielectric", "alpha": 0.2, "int_ior": 1.5}
WRAPPERS = {
    "blendbsdf": {"type": "blendbsdf", "weight": 0.4, "bsdf_0": GLASS,
                  "bsdf_1": ROUGH_GLASS},
    "mask": {"type": "mask", "opacity": 0.7, "bsdf": ROUGH_GLASS},
    "normalmap": {"type": "normalmap", "bsdf": ROUGH_GLASS},
    "bumpmap": {"type": "bumpmap", "scale": 1.0, "bsdf": GLASS},
}


def modes_dict():
    """One rectangle of each kind (tests/test_torch_polarized_bsdfs.py's)
    and of each wrapper, and an rpv, plastic and bilambertian one."""
    d = {"type": "scene",
         "sensor": {"type": "perspective", "film": {"width": 2,
                                                    "height": 2}},
         "sun": {"type": "directional", "direction": [0, 0, -1]}}
    extra = {"rpv": {"type": "rpv"}, "plastic": {"type": "plastic"},
             "roughplastic": {"type": "roughplastic"},
             "bilambertian": {"type": "bilambertian"}}
    for i, (kind, bsdf) in enumerate({**KINDS, **WRAPPERS,
                                      **extra}.items()):
        d[f"s_{kind}"] = {"type": "rectangle", "bsdf": bsdf, "to_world": {
            "type": "translate", "value": [0.0, 0.0, float(i)]}}
    return d


@pytest.fixture(scope="module")
def scenes():
    d = modes_dict()
    return jload_dict(d), load_dict(d, device="cpu")


def _lanes(scene, kind):
    _idx, slot = _slots(scene, kind)
    return (torch.full((N,), slot, dtype=torch.int32),
            jnp.full((N,), slot, jnp.int32))


_OUTPUTS = {}


def kind_outputs(jscene, scene, kind, mode, seed=1):
    """{output: (port, reference)} of kind's entries in ``mode`` on
    seeded interactions and draws (computed once a module)."""
    key = (id(scene), kind, mode, seed)
    if key not in _OUTPUTS:
        _OUTPUTS[key] = _kind_outputs(jscene, scene, kind, mode, seed)
    return _OUTPUTS[key]


def _kind_outputs(jscene, scene, kind, mode, seed):
    mod, jmod = bsdfs.REGISTRY[kind], jbsdfs.REGISTRY[kind]
    sl, jsl = _lanes(scene, kind)
    si, jsi = interactions(N, seed)
    wo, s1, s2 = draws(N, seed + 1)
    act, jact = torch.ones(N, dtype=torch.bool), jnp.ones(N, bool)
    params, jparams = scene.bsdfs[kind], jscene.bsdfs[kind]
    bs, w = mod.sample(scene, params, sl, si, T(s1), T(s2), act, mode)
    jbs, jw = jmod.sample(jscene, jparams, jsl, jsi, J(s1), J(s2), jact,
                          mode)
    v, p = mod.eval_pdf(scene, params, sl, si, T(wo), act, mode)
    jv, jp = jmod.eval_pdf(jscene, jparams, jsl, jsi, J(wo), jact, mode)
    out = {"sample wo": (bs.wo, jbs.wo), "sample pdf": (bs.pdf, jbs.pdf),
           "sample eta": (bs.eta, jbs.eta), "sample weight": (w, jw),
           "eval value": (v, jv), "eval pdf": (p, jp),
           "sampled_type": (bs.sampled_type, jbs.sampled_type)}
    if hasattr(mod, "eval_mueller"):
        out["eval_mueller"] = (
            mod.eval_mueller(scene, params, sl, si, T(wo), act, mode),
            jmod.eval_mueller(jscene, jparams, jsl, jsi, J(wo), jact, mode))
    if hasattr(mod, "sample_mueller_weight"):
        out["sample_mueller_weight"] = (
            mod.sample_mueller_weight(scene, params, sl, si, bs, w, act,
                                      mode),
            jmod.sample_mueller_weight(jscene, jparams, jsl, jsi, jbs, jw,
                                       jact, mode))
    return out


def test_modes_are_the_reference_constants():
    assert (common.RADIANCE, common.IMPORTANCE) == (jcommon.RADIANCE,
                                                    jcommon.IMPORTANCE)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", MODE_KINDS)
def test_kind_matches_reference_in_both_modes(scenes, kind, mode):
    for what, (got, want) in kind_outputs(*scenes, kind, mode).items():
        if what == "sampled_type":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            assert got.shape == want.shape, what
            budget(got, want, f"{kind} {mode} {what}")


def _differs(a, b):
    """Rows where a and b differ by more than rtol 1e-5, atol 1e-6."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    return ~np.isclose(a, b, rtol=1e-5, atol=1e-6).all(-1)


# the outputs the mode acts on, by the reference's 19 sites
ACTING = {
    "conductor": {"sample_mueller_weight"},
    "dielectric": {"sample weight", "sample_mueller_weight"},
    "roughconductor": {"eval_mueller"},
    "roughdielectric": {"sample weight", "eval value", "eval_mueller"},
    "pplastic": {"eval_mueller"},
    "measured_polarized": {"sample weight", "eval value", "eval_mueller"},
}


@pytest.mark.parametrize("kind", MODE_KINDS + ("rpv", "plastic",
                                               "roughplastic", "diffuse",
                                               "bilambertian", "null"))
def test_importance_differs_where_the_reference_does(scenes, kind):
    """On the outputs the mode acts on, the rows the modes move in the
    port are the reference's; every other output is bit-equal in both
    modes. (A conductor's reflection matrix is the same in either basis
    order, so its modes agree in value in both packages.)"""
    rad = kind_outputs(*scenes, kind, common.RADIANCE)
    imp = kind_outputs(*scenes, kind, common.IMPORTANCE)
    acting = ACTING.get(kind, set())
    for what in rad:
        if what not in acting:
            assert torch.equal(rad[what][0], imp[what][0]), what
            assert not _differs(rad[what][1], imp[what][1]).any(), what
            continue
        port = _differs(rad[what][0], imp[what][0])
        ref = _differs(rad[what][1], imp[what][1])
        assert np.mean(port != ref) <= 0.001, (what, port.sum(), ref.sum())
    moved = {w for w in acting if _differs(rad[w][1], imp[w][1]).any()}
    assert moved == {"dielectric": {"sample weight", "sample_mueller_weight"},
                     "roughconductor": {"eval_mueller"},
                     "roughdielectric": acting, "pplastic": acting,
                     "measured_polarized": {"eval_mueller"}}.get(
        kind, set()), (kind, moved)


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_wrappers_pass_the_mode_on(scenes, wrapper):
    jscene, scene = scenes
    out = kind_outputs(jscene, scene, wrapper, common.IMPORTANCE)
    rad = kind_outputs(jscene, scene, wrapper, common.RADIANCE)
    for what, (got, want) in out.items():
        if what != "sampled_type":
            budget(got, want, f"{wrapper} {what}")
    # a transmission through the nested glass drops eta^2
    assert _differs(out["sample weight"][0], rad["sample weight"][0]).any()


def test_dispatchers_take_the_mode(scenes):
    """bsdf_sample, bsdf_eval_pdf, bsdf_eval_mueller, bsdf_sample_mueller
    and the two nested dispatchers over every kind's lanes in
    IMPORTANCE."""
    jscene, scene = scenes
    idx = np.arange(N, dtype=np.int32) % scene.bsdf_kind.shape[0]
    si, jsi = interactions(N, 9)
    wo, s1, s2 = draws(N, 10)
    act, jact = torch.ones(N, dtype=torch.bool), jnp.ones(N, bool)
    mode = common.IMPORTANCE
    for name, args, jargs in (
            ("bsdf_sample", (T(s1), T(s2)), (J(s1), J(s2))),
            ("dispatch_sample_nested", (T(s1), T(s2)), (J(s1), J(s2))),
            ("bsdf_sample_mueller", (T(s1), T(s2)), (J(s1), J(s2))),
            ("bsdf_eval_pdf", (T(wo),), (J(wo),)),
            ("dispatch_eval_pdf_nested", (T(wo),), (J(wo),)),
            ("bsdf_eval_mueller", (T(wo),), (J(wo),))):
        got = getattr(bsdfs, name)(scene, T(idx), si, *args, act, mode)
        want = getattr(jbsdfs, name)(jscene, J(idx), jsi, *jargs, jact,
                                     mode)
        for i, (g, w) in enumerate(zip(got, want)):
            if isinstance(g, common.BSDFSample):
                for f in ("wo", "pdf", "eta"):
                    budget(getattr(g, f), getattr(w, f), f"{name} {f}")
            else:
                budget(g, w, f"{name} {i}")
