"""The directory the port builds its native libraries into, and the host
libraries built there with g++ (utils/native_cache.py counterpart).

Every library the port loads with ctypes, the CUDA kernels of
ops/_build.py and the host helpers below, comes from the package's
``build/`` directory. Before anything is loaded from it the directory is
checked as the reference checks its cache: owned by the current user and
neither group- nor world-writable (another local user could otherwise
plant a library there); it is created with mode 0700.

The host helpers are csrc/tile_builder.cpp, csrc/bvh_builder.cpp and
csrc/exr_bridge.cpp, compiled with the reference's g++ flags at first use
(never at import) into ``build/<name>_<hash>.so``, the hash over the
source, the command line and the machine, so a changed source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import stat
import subprocess
import sys

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "build")


def native_cache_dir(path=None) -> str:
    """Create ``path`` (the package's build/ directory by default) with
    mode 0700 if it is missing, and check it: raise unless the current
    user owns it and it is neither group- nor world-writable."""
    path = BUILD_DIR if path is None else path
    os.makedirs(path, mode=0o700, exist_ok=True)
    st = os.stat(path)
    if st.st_uid != os.getuid() or (st.st_mode & (stat.S_IWGRP
                                                   | stat.S_IWOTH)):
        raise RuntimeError(
            f"native build dir {path} is owned by uid {st.st_uid} or "
            "group/world-writable; refusing to load libraries from it")
    return path


def have_gxx() -> bool:
    return shutil.which("g++") is not None


def host_library(name, flags, libs=()):
    """The ctypes library of csrc/<name>.cpp built by ``g++ <flags>
    -shared -fPIC ... <libs>`` into the checked build directory (built
    once, at first use). Raises if g++ fails."""
    src = os.path.join(CSRC, f"{name}.cpp")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join((*flags, *libs, platform.machine())).encode())
    so = os.path.join(native_cache_dir(), f"{name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *flags, "-shared", "-fPIC", "-o", tmp,
                               src, *libs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(so)


_builders = {}


def host_builder(name):
    """The library of builder csrc/<name>.cpp (g++ -O3 -march=native, the
    reference's flags), or None where there is no g++: the caller then
    takes its numpy version, and this says so once on stderr. Raises if
    g++ is there and the build fails."""
    if name not in _builders:
        if not have_gxx():
            if not any(v is None for v in _builders.values()):
                print("eradiate_kernel_tpu_torch: no g++, so the tile and "
                      "BVH builders run their numpy versions",
                      file=sys.stderr)
            _builders[name] = None
        else:
            _builders[name] = host_library(name, ("-O3", "-march=native"))
    return _builders[name]
