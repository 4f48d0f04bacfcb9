"""The port's host library: the native ``.obj`` parser and JPEG decoder
(``csrc/host/objparser.cpp``, ``csrc/host/jpegdec.cpp``), built at first
use with the host C++ compiler and loaded with ctypes (the counterpart of
the JAX package's ``utils/native.py``, whose library is built by CMake).

The build is cached under ``another_raytracer_tpu_torch/_build/`` by a hash
of the sources and flags, as ``ops/kernels/_build.py`` caches the CUDA
kernels, so a fresh checkout builds it by itself.  A failed build raises,
naming the compiler and its report: no caller falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading
from pathlib import Path

import numpy as np

from another_raytracer_tpu_torch.ops.kernels import _build

SOURCES = (_build.CSRC_DIR / "host" / "objparser.cpp",
           _build.CSRC_DIR / "host" / "jpegdec.cpp")
FLAGS = ("-O2", "-std=c++20", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError(
            "no host C++ compiler: the port's native .obj parser and JPEG "
            "decoder are built at first use with $CXX or c++ on PATH")
    return cxx


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return _build.BUILD_DIR / f"host-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the host library unless this exact source is built.  Returns
    (library path, seconds compiling)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    return out, _build.compile_library(out, [compiler(), *FLAGS], SOURCES,
                                       "the host library (csrc/host)")


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            lib.artpu_parse_obj.restype = ctypes.c_void_p
            lib.artpu_parse_obj.argtypes = [ctypes.c_char_p]
            lib.artpu_mesh_num_triangles.restype = ctypes.c_longlong
            lib.artpu_mesh_num_triangles.argtypes = [ctypes.c_void_p]
            lib.artpu_mesh_num_materials.restype = ctypes.c_longlong
            lib.artpu_mesh_num_materials.argtypes = [ctypes.c_void_p]
            lib.artpu_mesh_fill.restype = None
            lib.artpu_mesh_fill.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_longlong)]
            lib.artpu_mesh_material.restype = ctypes.c_char_p
            lib.artpu_mesh_material.argtypes = [ctypes.c_void_p,
                                                ctypes.c_longlong]
            lib.artpu_mesh_free.restype = None
            lib.artpu_mesh_free.argtypes = [ctypes.c_void_p]
            lib.artpu_decode_jpeg.restype = ctypes.c_void_p
            lib.artpu_decode_jpeg.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.artpu_image_free.restype = None
            lib.artpu_image_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def parse_obj(path):
    """Parse and fan-triangulate an .obj.  Returns (tri_pos [T,3,3] f64,
    tri_uv [T,3,2] f64, tri_mat [T] i64, [(name, ka, kd, map_kd)] of the
    mtl materials).  Raises ValueError when the file cannot be read or a
    face indexes past its vertex or texcoord list."""
    lib = _load()
    handle = lib.artpu_parse_obj(os.fsencode(path))
    if not handle:
        raise ValueError(f"{path}: the native .obj parser cannot read it")
    try:
        t = int(lib.artpu_mesh_num_triangles(handle))
        tri_pos = np.zeros((t, 3, 3), np.float64)
        tri_uv = np.zeros((t, 3, 2), np.float64)
        tri_mat = np.zeros((t,), np.int64)
        lib.artpu_mesh_fill(
            handle, tri_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tri_uv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tri_mat.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
        materials = []
        for i in range(int(lib.artpu_mesh_num_materials(handle))):
            # name|ka_r,ka_g,ka_b|kd_r,kd_g,kd_b|map_kd
            raw = lib.artpu_mesh_material(handle, i).decode(errors="replace")
            name, ka, kd, map_kd = raw.split("|")
            materials.append((name, tuple(float(x) for x in ka.split(",")),
                              tuple(float(x) for x in kd.split(",")), map_kd))
        return tri_pos, tri_uv, tri_mat, materials
    finally:
        lib.artpu_mesh_free(handle)


def decode_jpeg(path) -> np.ndarray:
    """Decode a baseline or progressive 8-bit Huffman JPEG (1 or 3
    components) to [h, w, 3] uint8.  Subsampled chroma is replicated, as in
    the JAX package's decoder.  Raises ValueError on a file it cannot
    decode."""
    lib = _load()
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    ptr = lib.artpu_decode_jpeg(os.fsencode(path), ctypes.byref(w),
                                ctypes.byref(h))
    if not ptr:
        raise ValueError(f"{path}: the native JPEG decoder cannot decode it")
    try:
        return np.frombuffer(ctypes.string_at(ptr, w.value * h.value * 3),
                             np.uint8).reshape(h.value, w.value, 3).copy()
    finally:
        lib.artpu_image_free(ptr)
