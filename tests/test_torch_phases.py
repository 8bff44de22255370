"""The port's tabulated and blended phase functions (``tabphase``,
``blendphase``) against the JAX package's on the same seeded inputs: the
builder's tables bit for bit; eval and sample per lane at rtol 1e-6 for
181-node tables on uniform and non-uniform nodes; the table's segment
index bit for bit on the nodes and cdf values (ties), also for a 91-node
table zero-padded to the 181-node width, whose padded behaviour the port
reproduces (test_padded_rows_behave_as_the_reference); and the 8x8
aerosol atmosphere under ``nee_transmittance="quadrature"`` with a
nearest-filter grid read from a ``.vol`` file through ``use_grid_bbox``,
rendered through both drivers and differentiated
(tests/test_torch_nee_modes.py's render_case)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nee_modes import (PARTS, aerosol_atmosphere, aerosol_phase,
                                  check_film, check_grad,
                                  one_torch_thread, render_case)
from test_torch_scene import reference_arrays
from eradiate_kernel_tpu import phase as jphase
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu_torch import phase
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import volfile

__all__ = ["one_torch_thread"]  # the module's autouse fixture

RTOL, ATOL = 1e-6, 1e-7


def _nonuniform_table(n_fwd=101, n_back=80):
    """A table of n_back + n_fwd non-uniform nodes, denser at forward
    scattering."""
    nodes = np.sort(np.concatenate([np.linspace(-1, 0.5, n_back),
                                    np.linspace(0.505, 1, n_fwd)]))
    values = 0.05 + np.exp(4.0 * nodes)
    return {"type": "tabphase", "nodes": nodes.tolist(),
            "values": values.tolist()}


def _scenes(table):
    """(reference, port) scenes holding a blendphase of rayleigh and the
    181-node HG table, ``table``, an hg phase and a blendphase of hg and
    ``table`` (each on a medium of its own)."""
    d = aerosol_atmosphere()
    d["m_tab"] = {"type": "homogeneous", "phase": table}
    d["m_hg"] = {"type": "homogeneous", "phase": {"type": "hg", "g": 0.4}}
    d["m_blend"] = {"type": "homogeneous",
                    "phase": {"type": "blendphase", "weight": 0.8,
                              "a": {"type": "hg", "g": -0.3},
                              "b": table}}
    return jload_dict(d), load_dict(d, device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """Tables of one width: the HG table and a non-uniform 181-node
    one."""
    return _scenes(_nonuniform_table())


@pytest.fixture(scope="module")
def padded():
    """The HG table and a non-uniform 91-node one, zero-padded to 181."""
    return _scenes(_nonuniform_table(51, 40))


@pytest.mark.parametrize("which", ["scenes", "padded"])
def test_phase_tables_bit_equal(request, which):
    jscene, scene = request.getfixturevalue(which)
    ref = reference_arrays(jscene)
    arrays = scene.arrays()
    names = [n for n in arrays if n.startswith(("phases.", "phase_",
                                                "medium_phase"))]
    assert "phases.tabphase.cdf" in names and "phases.blendphase.weight" \
        in names
    assert scene.config.phase_kinds == jscene.config.phase_kinds
    for name in names:
        np.testing.assert_array_equal(arrays[name], ref[name], err_msg=name)
    n = {"scenes": 181, "padded": 91}[which]
    assert arrays["phases.tabphase.count"].tolist() == [181, n, n]


def _lanes(scene, n, seed):
    """Seeded lanes over every phase of the scene: phase indices,
    directions and samples."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, scene.phase_kind.shape[0], n).astype(np.int32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    s1 = rng.random(n).astype(np.float32)
    s2 = rng.random((n, 2)).astype(np.float32)
    return idx, d, s1, s2


def test_eval_and_sample_match_reference(scenes):
    """phase_sample and phase_eval per lane on every kind, blendphases
    included: sampled directions, pdfs and values at rtol 1e-6."""
    jscene, scene = scenes
    idx, d, s1, s2 = _lanes(scene, 4096, 20)
    jwo, jpdf = jphase.phase_sample(jscene, jnp.asarray(idx), jnp.asarray(d),
                                    jnp.asarray(s1), jnp.asarray(s2))
    wo, pdf = phase.phase_sample(scene, torch.as_tensor(idx),
                                 torch.as_tensor(d), torch.as_tensor(s1),
                                 torch.as_tensor(s2))
    np.testing.assert_allclose(wo.numpy(), np.asarray(jwo), rtol=RTOL,
                               atol=2e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=RTOL,
                               atol=ATOL)
    # eval at the reference's sampled directions and at random ones
    rng = np.random.default_rng(21)
    w2 = rng.normal(size=d.shape)
    w2 = (w2 / np.linalg.norm(w2, axis=1, keepdims=True)).astype(np.float32)
    for wo_ in (np.array(jwo), w2):
        ref = jphase.phase_eval(jscene, jnp.asarray(idx), jnp.asarray(-d),
                                jnp.asarray(wo_))
        out = phase.phase_eval(scene, torch.as_tensor(idx),
                               torch.as_tensor(-d), torch.as_tensor(wo_))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
        assert np.asarray(ref).min() > 0
    # every kind and both children of the blends were drawn
    kinds = scene.phase_kind[torch.as_tensor(idx)]
    assert len(set(kinds.tolist())) == len(scene.config.phase_kinds)


def _on_and_between(row, n):
    """The row's first n entries, the float32 values just below and above
    each, and the midpoints. The neighbours of a 0 node are denormals,
    which XLA's CPU programs flush to 0 and torch does not: they are
    flushed here."""
    row = np.asarray(row[:n], np.float32)
    x = np.concatenate([row, np.nextafter(row, np.float32(-2)),
                        np.nextafter(row, np.float32(2)),
                        0.5 * (row[1:] + row[:-1])]).astype(np.float32)
    return np.where(np.abs(x) < np.finfo(np.float32).tiny, np.float32(0), x)


@pytest.mark.parametrize("which, slot", [("scenes", 0), ("scenes", 1),
                                         ("padded", 1)])
def test_tab_index_and_ties(request, which, slot):
    """The table lookups on the nodes and the cdf's values, the float32
    neighbours and midpoints: the segment index is the reference's
    sum(x >= row) bit for bit (ties included, the padding of a shorter row
    counted as the reference counts it), and eval and the inverse cdf
    agree at rtol 1e-6."""
    jscene, scene = request.getfixturevalue(which)
    params = scene.phases["tabphase"]
    jparams = jscene.phases["tabphase"]
    cnt = int(params["count"][slot])
    for key in ("nodes", "cdf"):
        row = params[key][slot].numpy()
        x = _on_and_between(row, cnt if key == "nodes" else cnt - 1)
        ref = np.sum(x[:, None] >= np.asarray(jparams[key])[slot][None, :],
                     -1)
        out = phase._count_le(params[key], torch.full(x.shape, slot),
                              torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(out, ref)
    ct = _on_and_between(params["nodes"][slot].numpy(), cnt)
    sl = np.full(ct.shape, slot, np.int32)
    np.testing.assert_allclose(
        phase._tab_eval(params, torch.as_tensor(sl),
                        torch.as_tensor(ct)).numpy(),
        np.asarray(jphase._tab_eval(jparams, jnp.asarray(sl),
                                    jnp.asarray(ct))), rtol=RTOL, atol=ATOL)
    total = np.float32(params["integral"][slot])
    s1 = np.clip(_on_and_between(params["cdf"][slot].numpy(), cnt - 1)
                 / total, 0, np.float32(1 - 2 ** -24)).astype(np.float32)
    sl = np.full(s1.shape, slot, np.int32)
    np.testing.assert_allclose(
        phase._sample_cos_theta("tabphase", params, torch.as_tensor(sl),
                                torch.as_tensor(s1)).numpy(),
        np.asarray(jphase._sample_cos_theta("tabphase", jparams,
                                            jnp.asarray(sl),
                                            jnp.asarray(s1))),
        rtol=RTOL, atol=1e-6)


def test_padded_rows_behave_as_the_reference(padded):
    """A row shorter than the widest keeps its zero padding in the table,
    and the reference counts the padding in its segment search: for
    cosines >= 0 its eval reads the row's last segment, and its sampler
    returns cosines in [0, 1e-9] (a fault of the reference's tables of
    several widths; ROADMAP Queue 3). The port reproduces both: cosines in
    [0, the last segment's start) evaluate to one value."""
    jscene, scene = padded
    params, jparams = scene.phases["tabphase"], jscene.phases["tabphase"]
    rng = np.random.default_rng(22)
    s1 = rng.random(4096).astype(np.float32)
    sl = np.ones(s1.shape, np.int32)
    ct = phase._sample_cos_theta("tabphase", params, torch.as_tensor(sl),
                                 torch.as_tensor(s1)).numpy()
    jct = np.asarray(jphase._sample_cos_theta(
        "tabphase", jparams, jnp.asarray(sl), jnp.asarray(s1)))
    np.testing.assert_allclose(ct, jct, rtol=RTOL, atol=1e-12)
    assert ct.min() >= 0 and ct.max() <= 1e-9
    x = rng.uniform(-1, 1, 4096).astype(np.float32)
    out = phase._tab_eval(params, torch.as_tensor(sl),
                          torch.as_tensor(x)).numpy()
    ref = np.asarray(jphase._tab_eval(jparams, jnp.asarray(sl),
                                      jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    x_last = float(params["nodes"][1, int(params["count"][1]) - 2])
    assert np.unique(out[(x >= 0) & (x < x_last)]).size == 1


def test_tabulated_hg_is_normalised_and_sampled(scenes):
    """The 181-node table of HG g = 0.7: the pdf integrates to 1 over the
    sphere, and the sampled cosines have HG's mean cosine g."""
    _jscene, scene = scenes
    params = scene.phases["tabphase"]
    mu = torch.linspace(-1, 1, 20001)
    f = phase._tab_eval(params, torch.zeros(mu.shape, dtype=torch.int64), mu)
    assert abs(float(torch.trapezoid(f, mu)) * 2 * np.pi - 1) < 1e-4
    s1 = torch.rand(200000, generator=torch.Generator().manual_seed(0))
    ct = phase._sample_cos_theta("tabphase", params,
                                 torch.zeros(s1.shape, dtype=torch.int64),
                                 s1)
    assert abs(float(ct.mean()) - 0.7) < 0.01


# --- the quadrature render with a nearest grid from a .vol file ------------

@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """nee_transmittance 'quadrature' (5 nodes); the sigma_t grid written
    to a .vol file with its bbox and read back nearest-filtered through
    use_grid_bbox; a d65 sun and a regular ground reflectance."""
    d = aerosol_atmosphere(
        integrator={"nee_transmittance": "quadrature",
                    "nee_quad_points": 5},
        phase=aerosol_phase(0.6, 0.5),
        sun={"type": "d65", "scale": 0.9},
        ground={"rho_0": {"type": "regular", "lambda_min": 400.0,
                          "lambda_max": 700.0,
                          "values": [0.05, 0.1, 0.2, 0.3, 0.25]}}, seed=1)
    grid = d["atmo"]["interior"]["sigma_t"]
    path = str(tmp_path_factory.mktemp("vol") / "sigma_t.vol")
    volfile.write_vol(path, grid.pop("data"),
                      bbox=((-19.5, -19.5, 0.0), (20.5, 20.5, 1.0)))
    del grid["to_world"]
    grid.update(filename=path, use_grid_bbox=True, filter_type="nearest")
    return render_case(d, "volumes.gridvolume_nearest.grid")


@pytest.mark.parametrize("driver", ["scan", "pool"])
def test_quadrature_film_matches_reference(case, driver):
    assert case["scene"].config.volume_kinds == ("gridvolume_nearest",
                                                 "constvolume")
    check_film(case, driver)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("which", ["scan", "replay"])
def test_quadrature_grad_matches_reference(case, which, part):
    check_grad(case, which, part)
