"""The port's native host libraries (csrc/tile_builder.cpp,
csrc/bvh_builder.cpp and csrc/exr_bridge.cpp, built with g++ by
utils/native_cache.py) against their numpy plain versions and the JAX
package's:

- the native tile builder bit-equal to the port's numpy builder and to
  the reference's ``pack_tiles`` on terrain(64) and a random triangle
  soup;
- the native BVH builder bit-equal to the port's numpy builder and to the
  reference's on plain and instanced leaves (one group's tiles under many
  instances), and its 8-wide collapse with them;
- the build directory: created 0700, a group- or world-writable one
  refused, a changed source built anew under another name, and no g++
  falling back to the numpy builders with one line on stderr
  (``ERT_NO_NATIVE`` makes the BVH builder take numpy, as the
  reference's);
- DWAA and DWAB files written by the reference's OpenEXR bridge read by
  the port's bridge as the reference reads them (skipped without
  libOpenEXR).
"""

import os
import stat

import numpy as np
import pytest

from eradiate_kernel_tpu.ops import accel as jaccel
from eradiate_kernel_tpu.ops import bvh as jbvh
from eradiate_kernel_tpu.utils import bitmap as rb
from eradiate_kernel_tpu_torch.ops import accel, bvh
from eradiate_kernel_tpu_torch.utils import bitmap as pb
from eradiate_kernel_tpu_torch.utils import native_cache
from test_torch_bitmap import image
from test_torch_intersect import soup, terrain

NEEDS_GXX = pytest.mark.skipif(not native_cache.have_gxx(),
                               reason="no g++ to build the native builders")
MESHES = {"terrain64": lambda: terrain(64), "soup": lambda: soup(2000, 4)}


@NEEDS_GXX
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tile_builder_bit_equal(mesh):
    V, F = MESHES[mesh]()
    assert accel._builder() is not None
    native = accel.build_tri_tiles(V, F)
    plain = accel._build_tiles_numpy(V, F)
    ref = jaccel._build_tiles_numpy(V, F, accel.TILE_K)
    for a, b, c in zip(native, plain, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    shape = np.arange(len(F), dtype=np.int32) % 3
    got = accel.pack_tiles(V, None, F, shape)
    want = jaccel.pack_tiles(V, None, F, shape)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def instanced_leaves(n_inst=24, seed=1):
    """One group's 40 tile boxes under ``n_inst`` random translations and
    scales: leaf boxes, group tile ids and instance ids."""
    rng = np.random.default_rng(seed)
    V, F = soup(40 * 128 // 4, seed)
    _perm, lo, hi = accel._build_tiles_numpy(V, F)
    off = rng.uniform(-20, 20, (n_inst, 1, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (n_inst, 1, 1)).astype(np.float32)
    T = len(lo)
    return ((lo[None] * scale + off).reshape(-1, 3),
            (hi[None] * scale + off).reshape(-1, 3),
            np.tile(np.arange(T, dtype=np.int32), n_inst),
            np.repeat(np.arange(n_inst, dtype=np.int32), T))


@NEEDS_GXX
@pytest.mark.parametrize("leaves", ["terrain", "instanced"])
def test_bvh_builder_bit_equal(leaves):
    if leaves == "terrain":
        _perm, lo, hi = accel._build_tiles_numpy(*terrain(64))
        args = (lo, hi)
    else:
        args = instanced_leaves()
    assert bvh._builder() is not None
    native = bvh.build_tile_bvh(*args)
    plain = bvh._build_tile_bvh_numpy(*args)
    ref = jbvh._build_tile_bvh_numpy(*args)
    for a, b, c in zip(native, plain, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for a, b in zip(bvh.collapse_to_bvh8(native[0], native[1]),
                    jbvh.collapse_to_bvh8(ref[0], ref[1])):
        np.testing.assert_array_equal(a, b)


def test_build_dir_created_private(tmp_path):
    path = str(tmp_path / "build")
    assert native_cache.native_cache_dir(path) == path
    assert stat.S_IMODE(os.stat(path).st_mode) & 0o077 == 0


@pytest.mark.parametrize("mode", [0o775, 0o757])
def test_writable_build_dir_refused(tmp_path, mode):
    """A build directory that others can write to is refused before any
    library is loaded from it."""
    path = tmp_path / "build"
    path.mkdir()
    os.chmod(path, mode)
    with pytest.raises(RuntimeError, match="group/world-writable"):
        native_cache.native_cache_dir(str(path))


@NEEDS_GXX
def test_changed_source_rebuilds(tmp_path, monkeypatch):
    """The library's name is the hash of its source (and command line):
    an edited source is built anew beside the old library."""
    src = os.path.join(native_cache.CSRC, "tile_builder.cpp")
    monkeypatch.setattr(native_cache, "CSRC", str(tmp_path))
    monkeypatch.setattr(native_cache, "BUILD_DIR", str(tmp_path / "build"))
    with open(src) as f:
        text = f.read()
    (tmp_path / "tile_builder.cpp").write_text(text)
    native_cache.host_library("tile_builder", ("-O1",))
    (tmp_path / "tile_builder.cpp").write_text(text + "\n// edited\n")
    native_cache.host_library("tile_builder", ("-O1",))
    built = sorted(os.listdir(tmp_path / "build"))
    assert len(built) == 2 and all(n.startswith("tile_builder_")
                                   for n in built), built


def test_no_gxx_falls_back_to_numpy(monkeypatch, capsys):
    """Without g++ both builders take their numpy versions and say so
    once on stderr."""
    monkeypatch.setattr(native_cache, "have_gxx", lambda: False)
    monkeypatch.setattr(native_cache, "_builders", {})
    V, F = terrain(17)
    got = accel.build_tri_tiles(V, F)
    _ = bvh.build_tile_bvh(got[1], got[2])
    err = capsys.readouterr().err
    assert err.count("no g++") == 1, err
    for a, b in zip(got, accel._build_tiles_numpy(V, F)):
        np.testing.assert_array_equal(a, b)


def test_no_native_env_takes_numpy_bvh(monkeypatch):
    monkeypatch.setenv("ERT_NO_NATIVE", "1")
    assert bvh._builder() is None
    _perm, lo, hi = accel._build_tiles_numpy(*terrain(17))
    for a, b in zip(bvh.build_tile_bvh(lo, hi),
                    bvh._build_tile_bvh_numpy(lo, hi)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.skipif(rb._load_bridge() is None or pb._bridge_missing(),
                    reason="no system libOpenEXR")
@pytest.mark.parametrize("pixel_type", ["f16", "f32"])
@pytest.mark.parametrize("compression", ["dwaa", "dwab"])
def test_reads_reference_dwa_files(tmp_path, compression, pixel_type):
    for channels, names in ((3, ["R", "G", "B"]), (4, ["R", "G", "B", "A"]),
                            (2, ["Z", "N"])):
        path = str(tmp_path / f"ref{channels}.exr")
        assert rb._bridge_write_exr(path, image(40, 33, channels, seed=5),
                                    names, compression, pixel_type)
        got, got_names = pb.read_exr(path)
        want, want_names = rb.read_exr(path)
        assert got_names == want_names
        np.testing.assert_array_equal(got, want)
