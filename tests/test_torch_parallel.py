"""The port's multi-device layer (eradiate_kernel_tpu_torch/parallel, over
torch.distributed) and the lane pool's sample ranges against the JAX
package's parallel module on the CPU: the reference's renders run on
four of the eight virtual devices of tests/conftest.py, the port's on
four CPU shards of one process and of two gloo processes
(tests/torch_parallel_worker.py, started when the module starts).

Bit for bit where it holds: a film is a sum of per-sample rows, zero
outside a shard's pixels, so a pixel whose samples all lie in one shard
gets the single-process value exactly when each sample's arithmetic does
not depend on its lane. A pixel whose samples straddle two shards sums
in another order: within the reference's own 2e-5
(tests/test_render.py::test_sharded_matches_single). On the CPU torch
runs the last (n mod 32) elements of an elementwise op in scalar code
(AVX-512: two vectors of 16 floats a step), whose exp and log can differ
from the vector code by an ulp, so a sample's bits depend on its lane
unless the pool's (lanes x channels) arrays hold whole multiples of 32
elements. The bit-for-bit checks of the lane pool use pools of 32 lanes;
at the reference's 16 the sharded pool film is held to the single
pool's within 1e-6 a pixel. Films are compared with the reference's
within tests/conftest.py::assert_driver_equivalent's budget, gradients
within rtol 5e-3, atol 1e-7 (the port's gradient tolerance) and between
the port's processes within rtol 1e-5, atol 1e-7 (the shards' gradients sum in another order)."""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import assert_driver_equivalent
from eradiate_kernel_tpu import integrators as jintegrators
from eradiate_kernel_tpu import parallel as jparallel
from eradiate_kernel_tpu.films import develop as jdevelop
from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import scenes as jscenes
from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.films import develop
from eradiate_kernel_tpu_torch.parallel import (init_distributed, make_mesh,
                                                render_sharded, sharded_film)
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff, scenes

HERE = os.path.dirname(os.path.abspath(__file__))
SEED, SPP = 3, 4
LANES = 16  # the reference's test_sharded_regen_matches_standard's
WIDE = 32  # whole vectors on the CPU (module docstring)


@pytest.fixture(scope="module", autouse=True)
def workers(tmp_path_factory):
    """The two gloo processes, started before the module's first test so
    that they run beside the reference's compiles; ``workers()`` waits for
    them and returns their results."""
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
         str(r), str(tmp / "store"), outs[r]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    results = []

    def wait():
        if not results:
            for p in procs:
                try:
                    log, _ = p.communicate(timeout=300)
                except subprocess.TimeoutExpired:
                    p.kill()
                    log, _ = p.communicate()
                assert p.returncode == 0, log[-3000:]
            results.extend(torch.load(o) for o in outs)
        return results

    try:
        yield wait
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh():
    return jparallel.make_mesh(jax.devices()[:4])


def lowered_atmosphere(width=8, height=8, spp=SPP, grid_res=16):
    """utils.scenes.atmosphere with its ground lowered by 1e-3 (the tie of
    the ground and the cube's floor, ROADMAP Queue 3)."""
    def build(factory):
        d = factory.atmosphere(width, height, spp, 6, grid_res=grid_res)
        d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
        return d
    return build(jscenes), build(scenes)


def straddled(splits, spp, shape):
    """(H, W) mask of the pixels whose samples two ranges share."""
    mask = np.zeros(shape[0] * shape[1], bool)
    for s in splits[1:-1]:
        if s % spp:
            mask[s // spp] = True
    return mask.reshape(shape[:2])


def assert_sum_matches(parts, whole, splits, spp):
    """Sum of partial films == the whole film: bit for bit on pixels that
    one range holds, within 2e-5 on the straddled ones."""
    total = sum(parts[1:], parts[0]).numpy()
    whole = whole.numpy()
    shared = straddled(splits, spp, whole.shape)
    np.testing.assert_array_equal(total[~shared], whole[~shared])
    np.testing.assert_allclose(total[shared], whole[shared], rtol=0,
                               atol=2e-5)


@pytest.fixture(scope="module")
def grid_case():
    """The 17x16x16-grid atmosphere: (reference scene, port scene, the
    port's whole film on a pool of 32 lanes, its sample log, the
    reference's partial-film function)."""
    jd, d = lowered_atmosphere(grid_res=(17, 16, 16))
    scene = load_dict(d, device="cpu")
    assert scene.vol_packed is not None
    film, _rays, log = integrators.render_wavefront_regen(
        scene, WIDE, SEED, SPP, sample_log=True)
    run = jax.jit(jintegrators.render_wavefront_regen,
                  static_argnames=("n_lanes", "spp", "max_total"))
    return jload_dict(jd), scene, film, log, run


@pytest.mark.parametrize("splits", [(0, 128, 256), (0, 64, 130, 256),
                                    (0, 3, 97, 255, 256)])
def test_regen_partial_films_sum_to_the_whole(grid_case, splits):
    """render_wavefront_regen over [sample_offset, sample_offset + total):
    every sample lands once (the weights count the range), the partial
    films sum to the whole film, each matches the reference's partial film
    (its sample_offset and total traced, max_total 256), and the sample
    log covers the spp-aligned window up to the range's end."""
    jscene, scene, whole, whole_log, run = grid_case
    parts = []
    for a, b in zip(splits[:-1], splits[1:]):
        stats = {}
        film, _rays, log = integrators.render_wavefront_regen(
            scene, WIDE, SEED, SPP, sample_offset=a, total=b - a,
            max_total=256, sample_log=True, stats=stats)
        assert float(film[..., 4].sum()) == b - a and stats["dropped"] == 0
        a0 = a // SPP * SPP
        assert log.shape == (b - a0, 3)
        torch.testing.assert_close(log[a - a0:], whole_log[a:b], rtol=0,
                                   atol=0)
        ref, _ = run(jscene, n_lanes=WIDE, seed=SEED, spp=SPP,
                     sample_offset=jnp.uint32(a), total=jnp.uint32(b - a),
                     max_total=256)
        assert_driver_equivalent(np.asarray(ref), film.numpy(), max_flips=4)
        parts.append(film)
    assert_sum_matches(parts, whole, splits, SPP)


def test_regen_partial_films_under_a_wide_filter():
    """Under the default gaussian filter (radius 2) each iteration splats
    its finished lanes with film_put: the partial films of two ranges, the
    second from an offset that is not a multiple of spp, sum to the whole
    film within the reference's 2e-5 (a pixel takes samples of both
    ranges, in another order)."""
    _jd, d = lowered_atmosphere(grid_res=(17, 16, 16))
    d["sensor"]["film"].pop("rfilter")
    scene = load_dict(d, device="cpu")
    assert scene.config.rfilter == "gaussian"
    whole, _ = integrators.render_wavefront_regen(scene, WIDE, SEED, SPP)
    parts = [integrators.render_wavefront_regen(
        scene, WIDE, SEED, SPP, sample_offset=a, total=b - a,
        max_total=130)[0] for a, b in ((0, 130), (130, 256))]
    assert all(float(p[..., 4].sum()) > 0 for p in parts)
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(),
                               whole.numpy(), rtol=0, atol=2e-5)


def test_regen_range_is_checked(grid_case):
    _jscene, scene, _film, _log, _run = grid_case
    for kw in (dict(sample_offset=0, total=65, max_total=64),
               dict(sample_offset=200, total=64),
               dict(sample_offset=-4, total=4)):
        with pytest.raises(ValueError, match="samples"):
            integrators.render_wavefront_regen(scene, LANES, SEED, SPP, **kw)
    film, rays = integrators.render_wavefront_regen(
        scene, LANES, SEED, SPP, sample_offset=256, total=0, max_total=64)
    assert float(film.abs().sum()) == 0 and float(rays) == 0


@pytest.fixture(scope="module")
def box_case(jmesh):
    """The Cornell box 8x8 spp 8 max_depth 3 (the reference's
    test_sharded_matches_single): (the reference's 4-device sharded film,
    the port's scene, its single-process film)."""
    jscene = jload_dict(jscenes.cornell_box(8, 8, 8, 3))
    ref = np.asarray(jparallel.render_sharded(jscene, jmesh, seed=9,
                                              develop_film=False))
    scene = load_dict(scenes.cornell_box(8, 8, 8, 3), device="cpu")
    return ref, scene, integrators.render(scene, seed=9, develop_film=False)


def test_render_sharded_scan_matches_single(box_case):
    """Four shards of 128 samples (16 pixels each): the port's render bit
    for bit, the reference's sharded render within budget, and the
    developed image the reference's."""
    ref, scene, single = box_case
    mesh = make_mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.group is None
    film = render_sharded(scene, mesh, seed=9, develop_film=False)
    assert torch.equal(film, single)
    assert_driver_equivalent(ref, film.numpy(), max_flips=2)
    img = render_sharded(scene, mesh, seed=9)
    assert torch.equal(img, integrators.render(scene, seed=9))
    # three shards of 171 samples: pixels 21 and 42 straddle
    film3 = render_sharded(scene, make_mesh(["cpu"] * 3), seed=9,
                           develop_film=False)
    assert_sum_matches([film3], single, (0, 171, 342, 512), 8)
    # passes of 96 samples, 24 a shard: three pixels a shard
    films = render_sharded(scene, mesh, seed=9, develop_film=False,
                           samples_per_pass=96)
    assert torch.equal(films, single)


@pytest.fixture(scope="module")
def atmo_case(jmesh):
    """The plane-parallel atmosphere (the reference's
    test_sharded_regen_matches_standard, ground lowered): (the reference's
    4-device pool film, the port's scene, its single pool film, its film
    on four CPU shards)."""
    jd, d = lowered_atmosphere()
    ref = np.asarray(jparallel.render_sharded(
        jload_dict(jd), jmesh, seed=SEED, regen=True, regen_lanes=LANES,
        develop_film=False))
    scene = load_dict(d, device="cpu")
    single, _ = integrators.render_wavefront_regen(scene, LANES, SEED, SPP)
    sharded = render_sharded(scene, make_mesh(["cpu"] * 4), seed=SEED,
                             regen=True, regen_lanes=LANES,
                             develop_film=False)
    return ref, scene, single, sharded


def test_render_sharded_regen_matches_single_pool(atmo_case, grid_case):
    """One lane pool a shard: the reference's sharded pool film within
    budget, the port's single pool within 1e-6 a pixel (pools of 16
    lanes, module docstring); on the 17x16x16 grid with pools of 32 lanes
    bit for bit."""
    ref, _scene, single, film = atmo_case
    mesh = make_mesh(["cpu"] * 4)
    np.testing.assert_array_equal(film[..., 3:].numpy(),
                                  single[..., 3:].numpy())
    assert_driver_equivalent(single.numpy(), film.numpy(), tol=1e-6)
    assert_driver_equivalent(ref, film.numpy(), max_flips=4)
    _jscene, grid_scene, grid_single, _log, _run = grid_case
    assert torch.equal(render_sharded(grid_scene, mesh, seed=SEED,
                                      regen=True, regen_lanes=WIDE,
                                      develop_film=False), grid_single)


def test_render_sharded_regen_more_shards_than_samples():
    """A 2x2 film at spp 2 (8 samples) over 12 shards of one sample:
    shards 8-11 render nothing, every sample lands once, and the film is
    the single pool's within 1e-6 a pixel (pools of one lane against one
    of eight, module docstring)."""
    _jd, d = lowered_atmosphere(2, 2, 2, grid_res=(17, 16, 16))
    scene = load_dict(d, device="cpu")
    single, _ = integrators.render_wavefront_regen(scene, LANES, SEED, 2)
    film = render_sharded(scene, make_mesh(["cpu"] * 12), seed=SEED,
                          regen=True, regen_lanes=LANES, develop_film=False)
    np.testing.assert_array_equal(film[..., 3:].numpy(),
                                  single[..., 3:].numpy())
    np.testing.assert_array_equal(film[..., 4].numpy(), 2)
    assert_driver_equivalent(single.numpy(), film.numpy(), tol=1e-6)


def test_render_sharded_regen_under_autograd_raises(atmo_case):
    scene = atmo_case[1]
    pm = autodiff.traverse(scene).keep(["volumes.constvolume.value"])
    sc = pm.with_trainable(pm.trainable())
    with pytest.raises(NotImplementedError, match="scan driver"):
        render_sharded(sc, make_mesh(["cpu"] * 2), regen=True)


def box_loss(film, dev=develop):
    """__graft_entry__.py:69-73's loss: the mean square of the developed
    image against a zero target."""
    return (dev(film, "rgb") ** 2).mean()


@pytest.fixture(scope="module")
def grad_case(jmesh):
    """sharded_film's gradient of box_loss with respect to the spectra on
    the Cornell box 8x8 spp 4 max_depth 3 (__graft_entry__.py's
    dryrun_multichip): (the reference's jax.jit(jax.grad) on four
    devices, the port's loss and gradient in one process over four
    shards)."""
    jscene = jload_dict(jscenes.cornell_box(8, 8, 4, 3))

    def jloss(spectra):
        sc = dataclasses.replace(jscene, spectra=spectra)
        return box_loss(jparallel.sharded_film(sc, jmesh, jnp.uint32(0), 4),
                        jdevelop)

    ref = np.asarray(jax.jit(jax.grad(jloss))(jscene.spectra)[
        "baked"]["value"])
    pm = autodiff.traverse(load_dict(scenes.cornell_box(8, 8, 4, 3),
                                     device="cpu"))
    pm.keep(["spectra.baked.value"])
    params = pm.trainable()
    loss = box_loss(sharded_film(pm.with_trainable(params),
                                 make_mesh(["cpu"] * 4), 0, 4))
    loss.backward()
    return ref, loss.detach(), params["spectra.baked.value"].grad


def test_sharded_film_gradient_matches_reference(grad_case):
    ref, _loss, grad = grad_case
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(grad.numpy(), ref, rtol=5e-3, atol=1e-7)


def test_two_processes_render(workers, box_case, atmo_case):
    """Two gloo processes of two CPU shards each: the films equal in both
    processes and bit-equal to the one-process four-shard renders (the
    same shards), the box's within budget of the reference's four-device
    render."""
    ref, scene, single = box_case
    r0, r1 = workers()
    assert (r0["size"], r0["shards"], r1["shards"]) == (4, [0, 1], [2, 3])
    for key in ("box", "atmosphere"):
        assert torch.equal(r0[key], r1[key]), key
    mesh = make_mesh(["cpu"] * 4)
    assert torch.equal(r0["box"], render_sharded(scene, mesh, seed=9,
                                                 develop_film=False))
    assert torch.equal(r0["box"], single)
    assert torch.equal(r0["atmosphere"], atmo_case[3])
    assert_driver_equivalent(ref, r0["box"].numpy(), max_flips=2)


def test_two_processes_gradient_and_adam_step(workers, grad_case):
    """sharded_film's value+grad over the two processes: the whole
    gradient in each (equal in both), the one-process gradient within
    rtol 1e-5, atol 1e-7 and the reference's jax.jit(jax.grad) within the
    port's gradient tolerance; one Adam step from a finite loss moves the
    spectra alike in both."""
    ref, loss, grad = grad_case
    r0, r1 = workers()
    for key in ("loss", "grad", "stepped"):
        assert torch.equal(r0[key], r1[key]), key
    torch.testing.assert_close(r0["loss"], loss, rtol=1e-6, atol=0)
    torch.testing.assert_close(r0["grad"], grad, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(r0["grad"].numpy(), ref, rtol=5e-3,
                               atol=1e-7)
    assert torch.isfinite(r0["loss"]) and torch.isfinite(r0["stepped"]).all()
    scene = load_dict(scenes.cornell_box(8, 8, 4, 3), device="cpu")
    assert not torch.equal(r0["stepped"], scene.spectra["baked"]["value"])


def test_make_mesh_needs_a_card_or_devices():
    """Without a card the default devices raise (resolve_device's error);
    named devices may repeat."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed("localhost:1", 1, 0)
    mesh = make_mesh(["cpu"] * 3, axis="lanes")
    assert (mesh.size, mesh.world, mesh.rank) == (3, 1, 0)
    assert mesh.axis == "lanes"
    assert [k for k, _ in mesh.shards()] == [0, 1, 2]


def test_init_distributed_reads_torchrun_environment(monkeypatch):
    """init_distributed() with no coordinator joins the group torchrun's
    variables describe (here a world of one), and make_mesh then holds
    this rank's shards in it."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    init_distributed(backend="gloo")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        mesh = make_mesh(["cpu"] * 2)
        assert mesh.group is not None and mesh.size == 2
        scene = load_dict(scenes.cornell_box(4, 4, 2, 2), device="cpu")
        assert torch.equal(render_sharded(scene, mesh, seed=1),
                           integrators.render(scene, seed=1))
    finally:
        dist.destroy_process_group()
