"""The port's image IO (utils/bitmap.py, exr_piz.py, exr_b44.py) against
the JAX package's, and bitmaps and envmaps read from files.

- Bytes: the port's EXR writer gives the bytes of the reference's pure
  writer (its OpenEXR bridge disabled) for none/rle/zips/zip/piz/pxr24 x
  f32/f16 x 1/3/4 channels at heights 37 and 70 (partial last ZIP and PIZ
  blocks); the same for PFM, PPM, RGBE and PNG (PIL).
- Real OpenEXR files: files that libOpenEXR writes through the
  reference's bridge (ZIP, PIZ, PXR24, B44, B44A) decode exactly as
  libOpenEXR decodes them; skipped where the bridge cannot be built, as
  tests/test_regression.py does. Without the port's own bridge, DWAA
  and DWAB raise, naming libOpenEXR; with it, files of every compression
  that the port's bridge writes read as the reference's bridge reads
  them.
- The codec tests hold the port's pure-Python codec: its bridge is off
  in every test of this file but the bridge tests (``port_pure``).
- Scene arrays of a bitmap texture and an envmap read from EXR (ZIP, PIZ,
  one channel), PFM, RGBE and PNG files equal the reference's bit for
  bit.
"""

import contextlib
import os

import numpy as np
import pytest

from eradiate_kernel_tpu.scene import load_dict as jload_dict
from eradiate_kernel_tpu.utils import bitmap as rb
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import bitmap as pb
from test_torch_scene import port_config, reference_arrays

_HAVE_BRIDGE = rb._load_bridge() is not None


@pytest.fixture(autouse=True)
def port_pure(request, monkeypatch):
    """The port's pure-Python EXR codec (its OpenEXR bridge made absent),
    except in the tests that ask for the ``bridge`` fixture."""
    if "bridge" not in request.fixturenames:
        monkeypatch.setattr(pb, "_load_bridge", lambda: None)


@pytest.fixture
def bridge():
    """The port's OpenEXR bridge, built here (skip without libOpenEXR)."""
    if pb._bridge_missing():
        pytest.skip(f"no OpenEXR bridge: {pb._bridge_missing()}")
    lib = pb._load_bridge()
    assert lib is not None
    return lib


@contextlib.contextmanager
def pure_reference():
    """The reference's pure-Python EXR codec (its OpenEXR bridge off)."""
    saved = rb._bridge, rb._bridge_tried
    rb._bridge, rb._bridge_tried = None, True
    try:
        yield
    finally:
        rb._bridge, rb._bridge_tried = saved


def image(h, w, c, seed=0):
    """Signed values over a few decades with constant rows (runs for RLE
    and a ZIP that shrinks)."""
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((h, w, c)) * 5).astype(np.float32)
    img[5:9] = 0.25
    return img


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("height", [37, 70])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("pixel_type", ["f32", "f16"])
@pytest.mark.parametrize("compression",
                         ["none", "rle", "zips", "zip", "piz", "pxr24"])
def test_exr_bytes_match_reference(tmp_path, compression, pixel_type,
                                   channels, height):
    img = image(height, 13, channels, seed=height + channels)
    ref, port = str(tmp_path / "ref.exr"), str(tmp_path / "port.exr")
    with pure_reference():
        rb.write_exr(ref, img, compression=compression, pixel_type=pixel_type)
        ref_img, ref_names = rb.read_exr(ref)
    pb.write_exr(port, img, compression=compression, pixel_type=pixel_type)
    assert read_bytes(port) == read_bytes(ref)
    got, names = pb.read_exr(port)
    assert names == ref_names
    np.testing.assert_array_equal(got, ref_img)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("fmt", ["pfm", "ppm", "hdr"])
def test_pfm_ppm_rgbe_bytes_match_reference(tmp_path, fmt, channels):
    img = np.abs(image(11, 7, channels, seed=channels)) * 0.1
    img[0, 0] = 0.0
    ref, port = str(tmp_path / f"ref.{fmt}"), str(tmp_path / f"port.{fmt}")
    write, read = {"pfm": ("write_pfm", "read_pfm"),
                   "ppm": ("write_ppm", "read_ppm"),
                   "hdr": ("write_rgbe", "read_rgbe")}[fmt]
    getattr(rb, write)(ref, img)
    getattr(pb, write)(port, img)
    assert read_bytes(port) == read_bytes(ref)
    np.testing.assert_array_equal(getattr(pb, read)(port),
                                  getattr(rb, read)(ref))
    np.testing.assert_array_equal(pb.read_image(port), rb.read_image(ref))


def test_png_round_trips_through_pil(tmp_path):
    pytest.importorskip("PIL")
    img = np.abs(image(9, 6, 3)) * 0.1
    ref, port = str(tmp_path / "ref.png"), str(tmp_path / "port.png")
    rb.write_png(ref, img)
    pb.write_png(port, img)
    assert read_bytes(port) == read_bytes(ref)
    back = pb.read_image(port)
    np.testing.assert_array_equal(back, rb.read_image(ref))
    assert back.shape == (9, 6, 3) and back.dtype == np.float32
    # 8 bits through the sRGB transfer: within half a code value
    assert np.abs(back - np.clip(img, 0, 1)).max() < 0.01


def test_rgbe_rle_scanlines_match_reference(tmp_path):
    """New-style RLE .hdr scanlines (0x02 0x02 marker, per-component runs
    and literals), built by hand from Ward's format."""
    w, h = 16, 3
    rng = np.random.default_rng(5)
    rgbe = rng.integers(10, 200, (h, w, 4), dtype=np.uint8)
    rgbe[0, 4:12] = rgbe[0, 3]
    payload = bytearray()
    for y in range(h):
        payload += bytes([2, 2, w >> 8, w & 0xFF])
        for comp in range(4):
            col = rgbe[y, :, comp]
            x = 0
            while x < w:
                run = 1
                while x + run < w and col[x + run] == col[x] and run < 127:
                    run += 1
                if run >= 3:
                    payload += bytes([128 + run, int(col[x])])
                else:
                    payload += bytes([run]) + col[x:x + run].tobytes()
                x += run
    path = str(tmp_path / "rle.hdr")
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                + b"-Y %d +X %d\n" % (h, w) + bytes(payload))
    got = pb.read_rgbe(path)
    np.testing.assert_array_equal(got, rb.read_rgbe(path))
    e = rgbe[..., 3].astype(np.float64) - 136
    np.testing.assert_array_equal(got, (rgbe[..., :3] * np.ldexp(
        1.0, e.astype(np.int64))[..., None]).astype(np.float32))


@pytest.mark.skipif(not _HAVE_BRIDGE, reason="no system libOpenEXR")
@pytest.mark.parametrize("pixel_type", ["f16", "f32"])
@pytest.mark.parametrize("compression",
                         ["zip", "piz", "pxr24", "b44", "b44a"])
def test_reads_openexr_files_as_openexr_does(tmp_path, compression,
                                             pixel_type):
    """Files written by libOpenEXR (the reference's bridge) decode as
    libOpenEXR decodes them: bit for bit, lossy codecs included."""
    for channels, names in ((1, ["Y"]), (3, ["R", "G", "B"]),
                            (4, ["R", "G", "B", "A"]), (2, ["Z", "N"])):
        img = image(37, 21, channels, seed=channels)
        img[20:29, 3:11] = 1.5  # flat 4x4 blocks for B44A
        path = str(tmp_path / f"lib{channels}.exr")
        assert rb._bridge_write_exr(path, img, names, compression,
                                    pixel_type)
        lib, lib_names = rb.read_exr(path)  # libOpenEXR's decode
        got, got_names = pb.read_exr(path)
        assert got_names == lib_names
        np.testing.assert_array_equal(got, lib)


@pytest.mark.parametrize("codec", [8, 9])
def test_dwa_compression_refuses(tmp_path, codec):
    """DWAA (8) and DWAB (9) are read only through libOpenEXR: with the
    port's bridge absent, they raise, naming the library."""
    path = str(tmp_path / "dwa.exr")
    pb.write_exr(path, image(4, 4, 3), compression="zip")
    data = bytearray(read_bytes(path))
    key = b"compression\x00compression\x00\x01\x00\x00\x00"
    at = data.index(key) + len(key)
    assert data[at] == 3
    data[at] = codec
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(NotImplementedError, match="libOpenEXR"):
        pb.read_exr(path)
    if _HAVE_BRIDGE:  # and a real file from libOpenEXR
        lib = str(tmp_path / "lib_dwa.exr")
        assert rb._bridge_write_exr(lib, image(40, 40, 3), ["R", "G", "B"],
                                    "dwaa" if codec == 8 else "dwab", "f16")
        with pytest.raises(NotImplementedError, match="libOpenEXR"):
            pb.read_exr(lib)


@pytest.mark.skipif(not _HAVE_BRIDGE, reason="no system libOpenEXR")
@pytest.mark.parametrize("pixel_type", ["f16", "f32"])
@pytest.mark.parametrize("compression", sorted(pb._BRIDGE_COMPRESSION))
def test_bridge_write_read_as_reference(tmp_path, bridge, compression,
                                        pixel_type):
    """Through the port's OpenEXR bridge, write_exr writes every
    compression (DWAA and DWAB too), and read_exr reads the file as the
    reference's bridge reads it, RGB(A) and other channel sets."""
    for channels, names in ((1, ["Y"]), (3, ["R", "G", "B"]),
                            (4, ["R", "G", "B", "A"]), (2, ["Z", "N"])):
        img = image(37, 21, channels, seed=channels)
        path = str(tmp_path / f"port{channels}.exr")
        pb.write_exr(path, img, names, compression=compression,
                     pixel_type=pixel_type)
        got, got_names = pb.read_exr(path)
        want, want_names = rb.read_exr(path)
        assert got_names == want_names
        np.testing.assert_array_equal(got, want)
        if compression in ("none", "rle", "zips", "zip", "piz") and \
                pixel_type == "f32":  # lossless: the image itself
            np.testing.assert_array_equal(
                got, img[..., [names.index(n) for n in got_names]])


def file_scene(tex, env):
    """A rectangle under a diffuse bitmap reflectance and an envmap sky,
    seen by a small camera."""
    return {
        "type": "scene",
        "ground": {"type": "rectangle",
                   "bsdf": {"type": "diffuse",
                            "reflectance": {"type": "bitmap", **tex}}},
        "sky": {"type": "envmap", **env},
        "camera": {
            "type": "perspective", "fov": 50.0,
            "to_world": {"type": "look_at", "origin": [0.0, -2.0, 2.0],
                         "target": [0.0, 0.0, 0.0], "up": [0, 0, 1]},
            "film": {"type": "hdrfilm", "width": 8, "height": 8,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": 2}},
        "integrator": {"type": "path", "max_depth": 3},
    }


@pytest.mark.parametrize("fmt", ["exr-zip", "exr-piz", "exr-y", "pfm",
                                 "hdr", "png"])
def test_file_images_match_reference(tmp_path, fmt):
    """A bitmap and an envmap from the same kind of file: the port's scene
    arrays equal the reference's bit for bit (the reference reads EXRs
    through libOpenEXR where its bridge builds)."""
    if fmt == "png":
        pytest.importorskip("PIL")
    tex_img = np.abs(image(12, 10, 3, seed=1)) * 0.1
    env_img = np.abs(image(9, 16, 3, seed=2)) * 0.2 + 0.05
    paths = {}
    for name, img in (("tex", tex_img), ("env", env_img)):
        path = paths[name] = str(tmp_path / f"{name}.{fmt.split('-')[0]}")
        if fmt == "exr-y" and name == "tex":
            pb.write_exr(path, img[..., 1])
        elif fmt.startswith("exr"):
            pb.write_exr(path, img, compression=fmt[4:],
                         pixel_type="f16" if name == "env" else "f32")
        else:
            {"pfm": pb.write_pfm, "hdr": pb.write_rgbe,
             "png": pb.write_png}[fmt](path, img)
    d = file_scene({"filename": paths["tex"]},
                   {"filename": paths["env"], "scale": 0.5})
    ref_scene = jload_dict(d)
    ref = reference_arrays(ref_scene)
    scene = load_dict(d, device="cpu")
    arrays = scene.arrays()
    want = (12, 10, 1) if fmt == "exr-y" else (12, 10, 3)
    assert arrays["bitmap_data"].shape == (1, *want)
    assert arrays["emitters.envmap.image"].shape[1:] == (9, 17, 3)
    for name, a in arrays.items():
        assert a.shape == ref[name].shape, name
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    assert scene.config == port_config(ref_scene.config)
    # the same scene with the files' images inline
    inline = load_dict(file_scene(
        {"data": pb.read_image(paths["tex"]) if fmt != "exr-y"
         else pb.read_exr(paths["tex"])[0][..., 0]},
        {"data": pb.read_image(paths["env"]), "scale": 0.5}), device="cpu")
    if fmt != "exr-y":  # an inline 2-D image repeats to 3 channels
        for name, a in inline.arrays().items():
            np.testing.assert_array_equal(a, arrays[name], err_msg=name)


def test_projector_reads_only_inline_data(tmp_path):
    """The reference's projector reads its irradiance image (for the
    aspect) only from inline data; a file is refused."""
    path = str(tmp_path / "slide.pfm")
    pb.write_pfm(path, np.ones((4, 6, 3), np.float32))
    d = file_scene({"data": np.ones((2, 2, 3), np.float32)},
                   {"data": np.ones((4, 8, 3), np.float32)})
    d["proj"] = {"type": "projector",
                 "irradiance": {"type": "bitmap", "filename": path}}
    with pytest.raises(ValueError, match="inline 'data'"):
        load_dict(d, device="cpu")
    assert os.path.exists(path)
