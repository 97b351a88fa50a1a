"""ctypes bindings for the native (C++) OBJ loader.

Counterpart of ``tpu_renderer/models/native.py``: the same source,
``native/obj_loader.cpp`` at the repository root, compiled with ``g++`` at
first use into ``tpu_renderer_torch/build/`` (listed in ``.gitignore``) and
loaded through ``ctypes``. It parses OBJ files into the exact arrays of the
Python parser (``Model.load_model``), tens of times faster on
production-scale meshes. This is host asset parsing, not a render path:
without a compiler, ``native_available()`` is false, ``load_obj_native``
returns None and ``Model.load_model(use_native=None)`` parses in Python;
``use_native=True`` raises instead.

The library is built under a temporary name and moved into place with
``os.replace``, so processes that build at once (test workers) never load
a half-written file.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

__all__ = ["load_obj_native", "native_available", "build_error"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG), "native", "obj_loader.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libobjloader.so")

_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None


def _build() -> str:
    """Compile SRC into LIB_PATH unless a library at least as new exists.
    Raises FileNotFoundError without the source, OSError or
    subprocess.SubprocessError when g++ is missing or fails."""
    if not os.path.exists(SRC):
        raise FileNotFoundError(SRC)
    os.makedirs(BUILD_DIR, exist_ok=True)
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC)):
        return LIB_PATH
    fd, tmp = tempfile.mkstemp(prefix="libobjloader.", suffix=".so.tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        "-o", tmp, SRC], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB_PATH


def _get_lib():
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = _build()
        except (OSError, subprocess.SubprocessError) as exc:
            detail = getattr(exc, "stderr", None)
            _error = f"{exc!r}" + (f": {detail.decode()}" if detail else "")
            return None
        lib = ctypes.CDLL(path)
        lib.obj_load.restype = ctypes.c_void_p
        lib.obj_load.argtypes = [ctypes.c_char_p]
        for name in ("obj_n_vertices", "obj_n_uv", "obj_n_normals",
                     "obj_n_faces"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name, ctype in (("obj_vertices", ctypes.c_float),
                            ("obj_uv", ctypes.c_float),
                            ("obj_normals", ctypes.c_float),
                            ("obj_faces", ctypes.c_int)):
            getattr(lib, name).restype = ctypes.POINTER(ctype)
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("obj_mtllib", "obj_groups"):
            getattr(lib, name).restype = ctypes.c_char_p
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.obj_free.argtypes = [ctypes.c_void_p]
        lib.obj_free.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the C++ loader builds (once per process) and loads."""
    return _get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library did not build, or None."""
    _get_lib()
    return _error


def load_obj_native(path):
    """Parse an OBJ with the C++ loader.

    Returns (vertices (N, 4) f32, uv (T, 3) f32 | None, normals (M, 3) f32 |
    None, faces (F, 3, 4) i32, mtllib str | None, material_group list[str])
    with the exact array layouts of the Python parser, or None when the
    library is unavailable.
    """
    lib = _get_lib()
    if lib is None:
        return None
    handle = lib.obj_load(os.fspath(path).encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        def arr(fn, n, cols, dtype):
            if n == 0:
                return None
            return np.ctypeslib.as_array(
                fn(handle), shape=(n, cols)).astype(dtype, copy=True)

        vertices = arr(lib.obj_vertices, lib.obj_n_vertices(handle), 4,
                       np.float32)
        uv = arr(lib.obj_uv, lib.obj_n_uv(handle), 3, np.float32)
        normals = arr(lib.obj_normals, lib.obj_n_normals(handle), 3,
                      np.float32)
        n_faces = lib.obj_n_faces(handle)
        faces = (np.ctypeslib.as_array(lib.obj_faces(handle),
                                       shape=(n_faces, 3, 4))
                 .astype(np.int32, copy=True) if n_faces else
                 np.zeros((0, 3, 4), np.int32))
        mtllib = lib.obj_mtllib(handle).decode() or None
        groups = lib.obj_groups(handle).decode().split("\n")
        return vertices, uv, normals, faces, mtllib, groups
    finally:
        lib.obj_free(handle)
