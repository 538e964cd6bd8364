"""The C++ BVH builder (``native/bvh.cpp``), built with g++ and loaded with
ctypes.

The library is compiled at first use into ``build/mitsuba_tpu_torch/`` at the
root of the checkout (listed in ``.gitignore``), under a file name that carries
a hash of the source and flags, so an edited source is rebuilt. Unlike the JAX
package, a failed build raises: ``accel.build`` sends only large meshes here,
and the numpy builder would take minutes on them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("bvh.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mitsuba_tpu_torch"
# the JAX package's flags (mitsuba_tpu/native/__init__.py), so that both
# builders compile the same arithmetic on one host
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libbvh_native-{digest[:16]}.so"


def get_lib() -> ctypes.CDLL:
    """The loaded builder library, compiled first if missing; raises if g++
    is absent or fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: the native BVH builder "
                                   "cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.mtpu_build_bvh.restype = ctypes.c_int64
        lib.mtpu_build_bvh.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_int32,
                                       f32p, f32p, i32p, i32p, i32p, i32p]
        _lib = lib
        return lib


def build_bvh_native(prim_lo: np.ndarray, prim_hi: np.ndarray, leaf_size: int):
    """C++ binned-SAH build of per-primitive AABBs (T, 3): the arrays of
    ``accel.build.BVH`` as a tuple (lo, hi, skip, prim_first, prim_count,
    prim_order). Raises on failure."""
    lib = get_lib()
    T = prim_lo.shape[0]
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    cap = 2 * T + 16
    out_lo = np.empty((cap, 3), np.float32)
    out_hi = np.empty((cap, 3), np.float32)
    out_skip = np.empty(cap, np.int32)
    out_first = np.empty(cap, np.int32)
    out_count = np.empty(cap, np.int32)
    out_order = np.empty(T, np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    n = lib.mtpu_build_bvh(fp(lo), fp(hi), T, leaf_size, fp(out_lo), fp(out_hi),
                           ip(out_skip), ip(out_first), ip(out_count),
                           ip(out_order))
    if n <= 0:
        raise RuntimeError(f"native BVH build failed on {T} primitives")
    return (out_lo[:n].copy(), out_hi[:n].copy(), out_skip[:n].copy(),
            out_first[:n].copy(), out_count[:n].copy(), out_order)
