"""ctypes bindings for the native host runtime (native/pupil_native.cpp).

The reference's host runtime is C++; this module keeps this build's
host hot paths native too: the 8-wide SAH BVH builder (the GAS-build
analog) and the OBJ parser. The library is compiled lazily with g++ on
first use (no pip/pybind11 dependency); every caller falls back to the
numpy implementation when the toolchain or binary is unavailable, and
tests assert native/numpy equivalence.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from pupiloptixlab_tpu.utils.log import get_logger

log = get_logger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libpupil_native.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("PUPIL_NO_NATIVE"):
        return None
    try:
        src = _NATIVE_DIR / "pupil_native.cpp"
        # the .so is a build artifact (never committed): compile on
        # demand, and recompile when the source is newer than the binary
        stale = (
            _LIB_PATH.exists()
            and src.exists()
            and src.stat().st_mtime > _LIB_PATH.stat().st_mtime
        )
        if not _LIB_PATH.exists() or stale:
            if not src.exists():
                return None
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 "-o", str(_LIB_PATH), str(src)],
                check=True, capture_output=True, timeout=120,
            )
            log.info("built native host runtime: %s", _LIB_PATH)
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.pupil_build_bvh8.restype = ctypes.c_int
        lib.pupil_build_bvh8.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.pupil_parse_obj.restype = ctypes.c_int
        lib.pupil_parse_obj.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)
        ]
        lib.pupil_obj_fetch.restype = ctypes.c_int
        lib.pupil_obj_fetch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32),
        ]
        _lib = lib
    except Exception as exc:  # toolchain missing, build failure, ...
        log.info("native host runtime unavailable (%s); using numpy", exc)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def build_bvh8_native(p0, p1, p2, valid_count: int, tcl: int):
    """C++ build_bvh (accel/bvh.py semantics). Returns a BvhArrays or
    None when the native library is unavailable / reports an error."""
    lib = _load()
    if lib is None:
        return None
    t_pad = int(p0.shape[0])
    max_nodes = t_pad // tcl + 8
    order = np.empty(t_pad, np.int64)
    child = np.empty(max_nodes * 8, np.int32)
    axis = np.empty(max_nodes, np.int32)
    boxes = np.empty(max_nodes * 64, np.float32)
    p0c = np.ascontiguousarray(p0, np.float32)
    p1c = np.ascontiguousarray(p1, np.float32)
    p2c = np.ascontiguousarray(p2, np.float32)
    m = lib.pupil_build_bvh8(
        _fptr(p0c), _fptr(p1c), _fptr(p2c),
        t_pad, int(valid_count), int(tcl), max_nodes,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        child.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        axis.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _fptr(boxes),
    )
    if m <= 0:
        return None
    from pupiloptixlab_tpu.accel.bvh import BvhArrays

    return BvhArrays(
        order=order,
        child=child[: m * 8].copy(),
        axis=axis[:m].copy(),
        boxes=boxes[: m * 64].reshape(m * 8, 8).copy(),
        tcl=tcl,
        n_nodes=m,
    )


def parse_obj_native(path):
    """C++ OBJ reader; returns (pos, normals|None, uv|None, idx) or None."""
    lib = _load()
    if lib is None:
        return None
    counts = np.zeros(4, np.int64)
    rc = lib.pupil_parse_obj(
        str(path).encode(), counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    )
    if rc != 0:
        return None
    nv, nf, has_uv, has_n = (int(c) for c in counts)
    pos = np.empty((nv, 3), np.float32)
    uv = np.empty((nv, 2), np.float32)
    nrm = np.empty((nv, 3), np.float32)
    idx = np.empty((nf, 3), np.uint32)
    lib.pupil_obj_fetch(
        _fptr(pos), _fptr(uv), _fptr(nrm),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return pos, (nrm if has_n else None), (uv if has_uv else None), idx
