"""The port's ``films.save``, render runtime (utils/runtime.py) and
command line (``python -m eradiate_kernel_tpu_torch``) on the CPU.

- ``films.save`` to EXR (Y/RGB/RGBA and AOV channels under their names),
  PFM, PPM, RGBE and PNG decodes to the reference's ``films.save`` of the
  same film: the XYZ and luminance formats and the AOVs bit for bit, the
  sRGB ones within rtol 1e-6, atol 1e-7 (XLA's 3x3 XYZ -> sRGB product
  rounds differently from torch's, tests/test_torch_spectra.py; near 0
  the sum cancels), the 8-bit and shared-exponent formats to the next
  code.
- ``runtime.render`` is ``integrators.render``'s scan driver pass for
  pass: the same film bit for bit. Cancel, timeout, progress and
  checkpoint resume; the logger, ``scoped_phase`` and ``trace``.
- The command line as a subprocess with ``--device cpu -D spp=...``: its
  EXR is the in-process film, through both drivers; without a card and
  without ``--device cpu`` it refuses; ``-m spectral`` raises the port's
  refusal.
"""

import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu import films as jfilms
from eradiate_kernel_tpu.utils import bitmap as rb
from eradiate_kernel_tpu_torch import films, integrators
from eradiate_kernel_tpu_torch.core.types import Variant
from eradiate_kernel_tpu_torch.scene import load_dict, load_file
from eradiate_kernel_tpu_torch.scene import xml as pxml
from eradiate_kernel_tpu_torch.utils import bitmap as pb
from eradiate_kernel_tpu_torch.utils import meshio, runtime
from test_torch_scene import terrain_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def raw_film(h=7, w=9, seed=0):
    """A raw [X, Y, Z, A, W] film with 1-4 samples a pixel."""
    rng = np.random.default_rng(seed)
    film = rng.random((h, w, 5)).astype(np.float32)
    film[..., 3] = rng.integers(0, 2, (h, w))
    film[..., 4] = rng.integers(1, 5, (h, w))
    return film


@pytest.mark.parametrize("pixel_format",
                         ["rgb", "rgba", "xyz", "luminance", "mono"])
def test_save_exr_matches_reference(tmp_path, pixel_format):
    film = raw_film()
    mode = "mono" if pixel_format == "mono" else "rgb"
    fmt = "rgb" if pixel_format == "mono" else pixel_format
    rng = np.random.default_rng(1)
    aovs = {"depth": rng.random((7, 9)).astype(np.float32),
            "nn.x": rng.random((7, 9)).astype(np.float32)}
    ref, port = str(tmp_path / "ref.exr"), str(tmp_path / "port.exr")
    jfilms.save(ref, jnp.asarray(film), mode, fmt, aovs=aovs)
    films.save(port, torch.as_tensor(film), mode, fmt,
               aovs={k: torch.as_tensor(v) for k, v in aovs.items()})
    want, want_names = rb.read_exr(ref)  # through libOpenEXR if present
    got, names = pb.read_exr(port)
    assert names == want_names
    assert names[-2:] == ["depth", "nn.x"]
    if pixel_format in ("rgb", "rgba"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)
    # the file holds the port's own develop and the AOVs, f32 exactly
    dev = films.develop(torch.as_tensor(film), mode, fmt).numpy()
    n = dev.shape[-1]
    order = [names.index(c) for c in
             {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[n]]
    np.testing.assert_array_equal(got[..., order], dev)
    np.testing.assert_array_equal(got[..., names.index("depth")],
                                  aovs["depth"])


@pytest.mark.parametrize("ext", ["pfm", "ppm", "hdr", "png"])
def test_save_other_formats_match_reference(tmp_path, ext):
    if ext == "png":
        pytest.importorskip("PIL")
    film = raw_film(seed=2)
    film[..., :3] *= 0.5
    ref, port = str(tmp_path / f"ref.{ext}"), str(tmp_path / f"port.{ext}")
    jfilms.save(ref, jnp.asarray(film))
    films.save(port, torch.as_tensor(film))
    got, want = pb.read_image(port), rb.read_image(ref)
    assert got.shape == want.shape == (7, 9, 3)
    if ext == "pfm":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:  # 8-bit codes, or shared exponents: the same code or the next
        dev = films.develop(torch.as_tensor(film)).numpy()
        step = {"hdr": 2.0 ** -7 * np.abs(dev).max()}.get(ext, 0.05)
        assert np.abs(got - want).max() <= step


def tiny_terrain():
    return load_dict(terrain_scene(n=9, width=8, height=8, spp=4,
                                   max_depth=2), device="cpu")


@pytest.fixture(scope="module")
def scene():
    return tiny_terrain()


@pytest.fixture(scope="module")
def reference_film(scene):
    return integrators.render(scene, seed=1, samples_per_pass=60,
                              develop_film=False)


def test_runtime_render_equals_integrators_render(scene, reference_film):
    film = runtime.render(scene, seed=1, samples_per_pass=60,
                          develop_film=False)
    assert torch.equal(film, reference_film)
    img = runtime.render(scene, seed=1, samples_per_pass=60)
    assert torch.equal(img, films.develop(reference_film))
    # the default pass size takes the whole film in one pass
    one = runtime.render(scene, seed=1, develop_film=False)
    torch.testing.assert_close(one, reference_film, rtol=1e-5, atol=1e-6)
    assert float(one[..., 4].sum()) == 8 * 8 * 4


class StopAfter(runtime.RenderController):
    """Cancels once ``n`` passes have run (each pass sets ``partial``)."""

    def __init__(self, n):
        super().__init__()
        self.n, self.passes, self._last = n, 0, None

    def should_stop(self):
        if self.partial is not self._last:
            self._last = self.partial
            self.passes += 1
        return super().should_stop() or self.passes >= self.n


def test_cancel_keeps_the_partial_film(scene):
    ctl = StopAfter(1)
    film = runtime.render(scene, seed=1, samples_per_pass=60,
                          controller=ctl, develop_film=False)
    first = integrators.render_wavefront(scene, 0, 60, 1, 4)
    assert torch.equal(film, first) and torch.equal(ctl.partial, first)
    assert float(film[..., 4].sum()) == 60
    ctl = runtime.RenderController()
    ctl.cancel()
    assert ctl.should_stop()
    empty = runtime.render(scene, seed=1, controller=ctl, develop_film=False)
    assert float(empty.abs().sum()) == 0.0 and ctl.partial is None


def test_timeout_stops_between_passes(scene):
    ctl = runtime.RenderController(timeout=0.0)
    film = runtime.render(scene, seed=1, samples_per_pass=60,
                          controller=ctl, develop_film=False)
    assert ctl.should_stop()
    assert float(film[..., 4].sum()) < 8 * 8 * 4


def test_checkpoint_resume(tmp_path, scene, reference_film):
    ckpt = str(tmp_path / "render.ckpt")
    runtime.render(scene, seed=1, samples_per_pass=60, controller=StopAfter(2),
                   checkpoint_path=ckpt, develop_film=False)
    assert os.path.exists(ckpt) and not os.path.exists(ckpt + ".tmp")
    with open(ckpt, "rb") as f:
        saved = f.read()
    data = np.load(ckpt)
    assert int(data["next_pass"]) == 2
    np.testing.assert_array_equal(data["film"][..., 4].sum(), 120)
    # a render of another identity ignores it, runs to its end and
    # removes it
    other = runtime.render(scene, seed=2, samples_per_pass=60,
                           checkpoint_path=ckpt, develop_film=False)
    assert torch.equal(other, runtime.render(scene, seed=2,
                                             samples_per_pass=60,
                                             develop_film=False))
    assert not os.path.exists(ckpt)
    # the same identity resumes from pass 2: the uninterrupted film
    with open(ckpt, "wb") as f:
        f.write(saved)
    stream = io.StringIO()
    resumed = runtime.render(scene, seed=1, samples_per_pass=60,
                             checkpoint_path=ckpt, develop_film=False)
    assert torch.equal(resumed, reference_film)
    assert not os.path.exists(ckpt)  # a finished render removes it
    rep = runtime.ProgressReporter("Rendering", stream)
    rep.update(0.5)
    rep.update(1.0)
    assert "100.0%" in stream.getvalue() and stream.getvalue().endswith("\n")


def test_logger_and_profiling(tmp_path):
    stream = io.StringIO()
    log = runtime.Logger(log_level=runtime.INFO)
    app = runtime.StreamAppender(stream)
    log.add_appender(app)
    log.debug("hidden")
    log.info("shown", cls="Scene")
    log.warn("careful")
    assert log.appenders == (app,)
    with pytest.raises(RuntimeError, match="broken"):
        log.error("broken")
    text = stream.getvalue()
    assert "hidden" not in text and "INFO [Scene]: shown" in text
    assert "WARN: careful" in text and "ERROR: broken" in text
    log.remove_appender(app)
    assert runtime.logger() is runtime.logger()

    with runtime.trace(str(tmp_path / "trace")) as prof:
        with runtime.scoped_phase("render pass"):
            torch.ones(8).cumsum(0)
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "render pass" for e in events)


def xml_terrain(tmp_path):
    """The tiny terrain as XML: its mesh in a PLY file, its spp a
    parameter (``$spp``, default 4)."""
    d = terrain_scene(n=9, width=8, height=8, spp=4, max_depth=2)
    ply = str(tmp_path / "terrain.ply")
    meshio.write_ply(ply, d["terrain"]["vertices"], d["terrain"]["faces"])
    d["terrain"] = {"type": "ply", "filename": "terrain.ply",
                    "bsdf": d["terrain"]["bsdf"]}
    text = pxml.dict_to_xml(d).replace(
        '<integer name="sample_count" value="4" />',
        '<integer name="sample_count" value="$spp" />').replace(
        '<scene version="2.0.0">',
        '<scene version="2.0.0">\n  <default name="spp" value="4" />')
    path = str(tmp_path / "terrain.xml")
    with open(path, "w") as f:
        f.write(text)
    return path


def run_cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "eradiate_kernel_tpu_torch", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_cli_renders_an_xml_scene(tmp_path):
    path = xml_terrain(tmp_path)
    scene = load_file(path, parameters={"spp": "2"}, device="cpu")
    assert scene.config.spp == 2
    for regen in (False, True):
        out = str(tmp_path / f"out{int(regen)}.exr")
        res = run_cli(path, "-o", out, "--device", "cpu", "-D", "spp=2",
                      "--seed", "3", *(["--regen"] if regen else ["-p"]))
        assert res.returncode == 0, res.stderr
        assert f"wrote {out}" in res.stderr
        if regen:
            film = integrators.render(scene, seed=3, regen=True,
                                      develop_film=False)
        else:
            film = runtime.render(scene, seed=3, develop_film=False)
        img, names = pb.read_exr(out)
        assert names == ["R", "G", "B"]
        np.testing.assert_array_equal(img, films.develop(film).numpy())


def test_cli_refusals(tmp_path):
    path = xml_terrain(tmp_path)
    # volpathmis in the spectral variant renders since slice 6c-2 (slice
    # 6c-1 refused it): the command line writes its EXR, the film of the
    # same scene loaded in Python
    with open(path) as f:
        text = f.read()
    assert '<integrator type="path"' in text
    mis = str(tmp_path / "terrain_mis.xml")
    with open(mis, "w") as f:
        f.write(text.replace('<integrator type="path"',
                             '<integrator type="volpathmis"'))
    out = str(tmp_path / "mis.exr")
    res = run_cli(mis, "-m", "spectral", "-o", out, "--device", "cpu",
                  "--seed", "3")
    assert res.returncode == 0, res.stderr
    assert f"wrote {out}" in res.stderr
    scene = load_file(mis, variant=Variant("spectral"), device="cpu")
    assert scene.config.integrator.kind == "volpathmis"
    film = runtime.render(scene, seed=3, develop_film=False)
    img, names = pb.read_exr(out)
    assert names == ["R", "G", "B"] and float(film[..., 1].sum()) > 0
    np.testing.assert_array_equal(img, films.develop(film).numpy())
    if not torch.cuda.is_available():  # never quietly on the CPU
        res = run_cli(path, "-o", str(tmp_path / "x.exr"))
        assert res.returncode != 0 and "device='cpu'" in res.stderr
        assert not os.path.exists(tmp_path / "x.exr")
