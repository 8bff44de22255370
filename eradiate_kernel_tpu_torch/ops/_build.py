"""Building and loading the port's CUDA kernels (route (b): nvcc into a
shared library with a plain C entry point, loaded with ctypes).

Each kernel ``<name>`` is one source ``csrc/<name>.cu`` (plus the shared
headers it names) exporting one or more ``int <entry>(...)`` functions,
each of which launches on the stream it is given and returns
``cudaGetLastError()``. The modules that own kernels register them here;
``build_kernels()`` compiles every registered kernel for sm_90a at first
use, one nvcc per source, all started together, into the package's
``build/`` directory, keyed by the hash of the sources. Nothing is built
when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "build")

PTR, INT, LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# name -> (shared headers, {entry: ctypes argument types})
_SPECS = {}
_libs = {}


def register(name, entries, headers=()):
    """Declare kernel ``name``: csrc/<name>.cu and the launch signature of
    each of its C entries (entry name -> argument types). Pointers and the
    stream are PTR, ints INT, 64-bit ints LONG (ctypes would otherwise pass
    a Python int as a 32-bit int and cut a pointer)."""
    _SPECS[name] = (tuple(headers), {e: list(a) for e, a in entries.items()})


def _so_path(name):
    """build/<name>_<hash of the source and its headers>.so"""
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + _SPECS[name][0]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def _nvcc():
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_kernels(names=None, verbose=False):
    """Compile csrc/<name>.cu for sm_90a (every registered kernel when
    ``names`` is None), one nvcc per source, all started together, and load
    them. Returns {name: seconds its build took} (0 for a library built
    before). Raises if nvcc fails."""
    names = tuple(_SPECS if names is None else names)
    procs = {}
    for name in names:
        if name in _libs:
            continue
        so = _so_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        # -fmad=false: no a*b+c contraction, so the kernels round every
        # product and sum like the plain versions' eager torch ops do
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-fmad=false", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so, time.perf_counter())
    seconds = dict.fromkeys(names, 0.0)
    failed = []
    for name, (proc, tmp, so, t0) in procs.items():
        out = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{out}")
            continue
        if verbose:
            print(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        load(name)
    return seconds


def load(name):
    """The loaded ctypes library of kernel ``name``, built at first use,
    with the argument types of every entry set."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    so = _so_path(name)
    if not os.path.exists(so):
        build_kernels((name,))
        return _libs[name]
    lib = ctypes.CDLL(so)
    for entry, argtypes in _SPECS[name][1].items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    _libs[name] = lib
    return lib


def entry(name, fn):
    """The ctypes function ``fn`` of kernel ``name`` (built and loaded at
    first use); callers keep it, so a launch looks nothing up."""
    return getattr(load(name), fn)


def stream(index):
    """The current stream of CUDA device ``index`` (an int, as
    Tensor.get_device() gives it) as a raw cudaStream_t (an int):
    torch._C._cuda_getCurrentRawStream, the getter PyTorch's own generated
    code calls, which builds no torch.cuda.Stream object. It is the handle
    of torch.cuda.current_stream(index).cuda_stream (tested)."""
    return torch._C._cuda_getCurrentRawStream(index)


def check(name, tensors, dev):
    """Raise unless every (tensor, dtype, shape) of ``tensors`` (argument
    name -> triple) is contiguous, of that dtype and shape, on ``dev``."""
    for arg, (a, dtype, shp) in tensors.items():
        if (a.device != dev or a.dtype != dtype or tuple(a.shape) != shp
                or not a.is_contiguous()):
            raise ValueError(
                f"{name}: {arg} must be a contiguous {dtype} tensor of "
                f"shape {shp} on {dev}, got {a.dtype} {tuple(a.shape)} on "
                f"{a.device}")
