"""ctypes loader for the native host-runtime library (lscnative.cpp).

Builds on first use with g++ if the shared object is missing; every
consumer has a pure-Python fallback, so the native layer is an
acceleration/validation path, never a hard dependency.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "lscnative.cpp")
_SO = os.path.join(_DIR, "liblscnative.so")

_lib = None
_tried = False


def build(force: bool = False) -> bool:
    """Compile the shared library; returns True on success."""
    if os.path.exists(_SO) and not force and \
            os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return True
    # build under a private name, then rename: several processes (test
    # workers) may build at once, and none may load a half-written file
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if not build():
        return None
    lib = ctypes.CDLL(_SO)
    lib.lsc_bt_resolution.restype = ctypes.c_double
    lib.lsc_bt_resolution.argtypes = [ctypes.c_char_p]
    lib.lsc_bt_rasterize.restype = ctypes.c_int
    lib.lsc_bt_rasterize.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C")]
    lib.lsc_edt3d.restype = None
    lib.lsc_edt3d.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        np.ctypeslib.ndpointer(np.float32, flags="C")]
    lib.lsc_astar6.restype = ctypes.c_int
    lib.lsc_astar6.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.c_int64]
    _lib = lib
    return _lib


def bt_resolution(path: str) -> float:
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return float(lib.lsc_bt_resolution(path.encode()))


def bt_rasterize(path: str, k0: np.ndarray, dims: np.ndarray) -> np.ndarray:
    lib = load()
    occ = np.zeros(int(np.prod(dims)), np.uint8)
    rc = lib.lsc_bt_rasterize(path.encode(),
                              np.ascontiguousarray(k0, np.int64),
                              np.ascontiguousarray(dims, np.int64), occ)
    if rc != 0:
        raise RuntimeError(f"bt_rasterize failed: {rc}")
    return occ.reshape(tuple(int(d) for d in dims)).astype(bool)


def edt3d(occ: np.ndarray, res: float, maxdist: float) -> np.ndarray:
    lib = load()
    occ8 = np.ascontiguousarray(occ, np.uint8)
    out = np.zeros(occ8.size, np.float32)
    X, Y, Z = occ8.shape
    lib.lsc_edt3d(occ8.reshape(-1), X, Y, Z, res, maxdist, out)
    return out.reshape(occ8.shape)


def astar6(occ: np.ndarray, start, goal, max_len: int = 4096):
    """6-connected A* oracle; returns (L, 3) int64 cell path (possibly
    empty)."""
    lib = load()
    occ8 = np.ascontiguousarray(occ, np.uint8)
    dims = np.asarray(occ8.shape, np.int64)
    out = np.zeros(3 * max_len, np.int64)
    n = lib.lsc_astar6(occ8.reshape(-1), dims,
                       np.asarray(start, np.int64),
                       np.asarray(goal, np.int64), out, max_len)
    if n < 0:
        raise ValueError("astar6: start/goal out of bounds")
    return out[:3 * n].reshape(n, 3)
