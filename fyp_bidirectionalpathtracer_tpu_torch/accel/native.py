"""Optional binding (ctypes) of the C++ BVH construction.

The reference's one irreducibly-native host component is the acceleration-
structure build (RtModel.cpp:181-254).  native/bvh_builder.cc implements the
same threaded-BVH flatten as accel.bvh in C++; this module loads it lazily
and falls back to None (callers then use the numpy construction).

Build:  cd native && make    (produces libbvh_builder.so next to this file's
package root under native/).

The port's own copy of `fyp_bidirectionalpathtracer_tpu/accel/native.py`:
it loads the same library from `native/` at the root of the checkout and
imports nothing of the JAX package.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _find_lib():
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cands = [
        os.path.join(here, "native", "libbvh_builder.so"),
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "libbvh_builder.so"),
    ]
    for c in cands:
        if os.path.exists(c):
            return c
    return None


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.bvh_build.restype = ctypes.c_int64
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # positions [V*3]
            ctypes.c_int64,                  # V
            ctypes.POINTER(ctypes.c_int64),  # indices [F*3]
            ctypes.c_int64,                  # F
            ctypes.c_int64,                  # leaf_size
            # outputs (caller-allocated, capacity 2F nodes)
            ctypes.POINTER(ctypes.c_float),  # node_min [2F*3]
            ctypes.POINTER(ctypes.c_float),  # node_max
            ctypes.POINTER(ctypes.c_int32),  # node_left
            ctypes.POINTER(ctypes.c_int32),  # node_count
            ctypes.POINTER(ctypes.c_int32),  # node_hit
            ctypes.POINTER(ctypes.c_int32),  # node_miss
            ctypes.POINTER(ctypes.c_int32),  # tri_order [F]
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def build_sah_native(positions: np.ndarray, indices: np.ndarray, leaf_size: int):
    """Returns the BVH array dict, or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int64)
    f = len(indices)
    cap = max(1, 2 * f)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_left = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    node_hit = np.empty(cap, np.int32)
    node_miss = np.empty(cap, np.int32)
    tri_order = np.empty(max(1, f), np.int32)
    pf = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa: E731
    pi = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    n = lib.bvh_build(
        pf(positions),
        len(positions),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        f,
        leaf_size,
        pf(node_min),
        pf(node_max),
        pi(node_left),
        pi(node_count),
        pi(node_hit),
        pi(node_miss),
        pi(tri_order),
    )
    if n <= 0:
        return None
    return {
        "node_min": node_min[:n].copy(),
        "node_max": node_max[:n].copy(),
        "node_left": node_left[:n].copy(),
        "node_count": node_count[:n].copy(),
        "node_hit": node_hit[:n].copy(),
        "node_miss": node_miss[:n].copy(),
        "tri_order": tri_order[:f].copy(),
    }
