"""Build and bind the hand-written CUDA kernels of this package.

Every ``csrc/*.cu`` source (with the ``csrc/*.cuh`` headers they share)
compiles with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into ONE shared library with a
plain C interface, loaded through ``ctypes``. The build happens on first
use, into ``ckrenderengine_tpu_torch/_build/`` (git-ignored), under a file
name that hashes the sources and flags, so an edited kernel never loads a
stale library. Building takes seconds (no PyTorch headers are included).

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (pointers, the stream: c_void_p).
_SIGNATURES = {
    "ck_reduce_flat": (_P, _I, _P, _P, _P, _I, _I, _F, _P),
    "ck_reduce_flat_split": (_I, _I, _I),
    "ck_reduce_flat_occupancy": (),
    "ck_solve_tiled": (_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _I, _I, _F,
                       _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _P),
    "ck_solve_tiled_occupancy": (_I, _I, _I, _I, _I, _I),
    "ck_ordered_blend": (_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ck_ordered_peel": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                        _I, _I, _I, _P),
    "ck_ordered_blend_occupancy": (_I, _I, _I),
    "ck_ordered_peel_occupancy": (_I, _I, _I),
    "ck_line_bins": (_P, _I, _P, _I, _I, _F, _F, _P),
    "ck_draw_lines": (_P, _I, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P),
}


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: str, build_log: str,
                 build_seconds: float):
        self.lib = lib
        self.path = path
        self.build_log = build_log
        self.build_seconds = build_seconds


_LOADED: KernelLibrary | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc is needed to build "
                           "the kernels of ckrenderengine_tpu_torch)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library() -> KernelLibrary:
    """Build (once per source/flag hash) and load the kernel library."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(_BUILD, exist_ok=True)
    so = os.path.join(_BUILD, f"libckkernels-{h.hexdigest()[:16]}.so")
    log_path = so + ".log"
    t0 = time.monotonic()
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        # One nvcc per source, all started together, then one link.
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj,
                                   src], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        if any(proc.returncode for proc in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        link = subprocess.run([_nvcc(), "-shared", NVCC_FLAGS[0],
                               NVCC_FLAGS[1], "-o", tmp, *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{log}")
        for obj in objs:
            os.remove(obj)
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, so)
    build_seconds = time.monotonic() - t0
    with open(log_path) as f:
        log = f.read()
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LOADED = KernelLibrary(lib, so, log, build_seconds)
    return _LOADED


def check(name: str, code: int) -> None:
    """Raise when a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def ptr(t) -> int:
    """Device pointer of a tensor (0 for None)."""
    return 0 if t is None else t.data_ptr()
