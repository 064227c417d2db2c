"""ctypes bridge to the C++ binned-SAH BVH builder.

Compiles native/bvh_builder.cpp on first use (g++ -O3, portable x86-64
code: no -march=native, so the library runs on any host that shares the
checkout) into native/build/, which .gitignore lists.  If the build
fails, the reason goes to stderr and ops/bvh.py uses its numpy builder.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bvh_builder.cpp")
_BUILD = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD, "libbvh_builder.so")
_LIB = None


def _compile():
    """Build into a temporary file, then rename: concurrent first uses
    (test workers) never load a half-written library."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, _SO)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        print(f"bvh_native: building {_SRC} failed; using the numpy BVH "
              f"builder instead.\n{detail}", file=sys.stderr)
        raise
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        _compile()
    lib = ctypes.CDLL(_SO)
    lib.bvh_build.restype = ctypes.c_int64
    lib.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _LIB = lib
    return lib


def build(tri_p: np.ndarray):
    """tri_p (T,3,3) f32 -> ops.bvh.FlatBVH (or None on failure)."""
    from ..ops.bvh import FlatBVH

    lib = _load()
    t = np.ascontiguousarray(tri_p, dtype=np.float32)
    n = t.shape[0]
    cap = max(2 * n, 2)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_right = np.zeros(cap, np.int32)
    node_count = np.zeros(cap, np.int32)
    node_axis = np.zeros(cap, np.int32)
    order = np.empty(n, np.int64)
    max_depth = ctypes.c_int32(0)

    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    m = lib.bvh_build(fp(t), n, fp(node_min), fp(node_max), ip(node_right),
                      ip(node_count), ip(node_axis), lp(order),
                      ctypes.byref(max_depth))
    if m <= 0:
        return None
    return FlatBVH(
        node_min=node_min[:m].copy(), node_max=node_max[:m].copy(),
        node_right=node_right[:m].copy(), node_count=node_count[:m].copy(),
        node_axis=node_axis[:m].copy(), prim_order=order,
        max_depth=int(max_depth.value),
    )
