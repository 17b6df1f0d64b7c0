"""ctypes bindings for the native OBJ parser (``csrc/fast_obj.cpp``).

The port's copy of the JAX package's ``io/native.py``.  The library is
built on first use by ``g++`` into the package's ``_build/`` directory
(``_build.build_host``), never beside the source.  Every entry point gives
way to the pure-Python parser when the toolchain or the build is
unavailable, so the native path is an accelerator on the host, never a
dependency.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

from neural_renderer_torch import _build

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build.build_host('fast_obj')))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        lib.fobj_parse.restype = ctypes.c_int
        lib.fobj_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.fobj_free.restype = None
        lib.fobj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available():
    return _load() is not None


def parse_obj(path):
    """Parse v/f of an OBJ natively -> (vertices [nv,3] f32, faces [nf,3]
    i32) or None if the native library is unavailable or fails."""
    lib = _load()
    if lib is None:
        return None
    vptr = ctypes.POINTER(ctypes.c_float)()
    fptr = ctypes.POINTER(ctypes.c_int)()
    nv = ctypes.c_int()
    nf = ctypes.c_int()
    rc = lib.fobj_parse(os.fsencode(path), ctypes.byref(vptr),
                        ctypes.byref(nv), ctypes.byref(fptr),
                        ctypes.byref(nf))
    if rc != 0:
        return None
    try:
        vertices = np.ctypeslib.as_array(
            vptr, shape=(nv.value, 3)).astype(np.float32, copy=True)
        faces = np.ctypeslib.as_array(
            fptr, shape=(nf.value, 3)).astype(np.int32, copy=True)
    finally:
        lib.fobj_free(ctypes.cast(vptr, ctypes.c_void_p))
        lib.fobj_free(ctypes.cast(fptr, ctypes.c_void_p))
    return vertices, faces
