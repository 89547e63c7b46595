"""ctypes loader for the native ckcore library (native/ckcore.cpp).

Builds the shared library on demand with g++ when missing (no external
dependencies). All consumers (utils/geometry.py) fall back to numpy
implementations when the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_lock = threading.Lock()
_lib = None
_tried = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_NATIVE_DIR, "ckcore.cpp")
_SO = os.path.join(_NATIVE_DIR, "libckcore.so")


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", _SO, _SRC],
            check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load():
    """The ckcore cdll, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        stale = (os.path.exists(_SO) and os.path.exists(_SRC)
                 and os.path.getmtime(_SRC) > os.path.getmtime(_SO))
        if (not os.path.exists(_SO) or stale) and os.path.exists(_SRC):
            if not _build() and not os.path.exists(_SO):
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ck_radix_sort_u32.argtypes = [u32p, ctypes.c_uint32, u32p]
        lib.ck_radix_sort_f32.argtypes = [f32p, ctypes.c_uint32, u32p]
        lib.ck_mesh_adjacency.argtypes = [u32p, ctypes.c_uint32, u32p]
        lib.ck_stripify.argtypes = [u32p, ctypes.c_uint32, u32p, u32p, u32p]
        lib.ck_stripify.restype = ctypes.c_uint32
        try:   # absent from pre-rebuild .so files; consumers hasattr-check
            lib.ck_nvstripify.argtypes = [u32p, ctypes.c_uint32,
                                          ctypes.c_uint32, u32p, u32p, u32p]
            lib.ck_nvstripify.restype = ctypes.c_uint32
        except AttributeError:
            pass
        lib.ck_vertex_cache_optimize.argtypes = [
            u32p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, u32p]
        lib.ck_cache_misses.argtypes = [u32p, ctypes.c_uint32, ctypes.c_uint32]
        lib.ck_cache_misses.restype = ctypes.c_uint32
        lib.ck_npgrid_build.argtypes = [f32p, ctypes.c_uint32, ctypes.c_float]
        lib.ck_npgrid_build.restype = ctypes.c_void_p
        lib.ck_npgrid_nearest.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float]
        lib.ck_npgrid_nearest.restype = ctypes.c_uint32
        lib.ck_npgrid_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None
