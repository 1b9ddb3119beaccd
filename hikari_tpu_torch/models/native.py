"""ctypes bridge to the port's native BVH builder (csrc/bvh_builder.cpp).

Compiled with g++ on first use into build/hikari_tpu_torch/. When the
toolchain is missing, `available()` is False and models/bvh.py takes the
numpy LBVH, the same rule as hikari_tpu's.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from hikari_tpu_torch.build import build_host_library

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
            path = build_host_library("bvh_builder.cpp", "libhikari_bvh.so")
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError):
            return None
        fn = lib.hikari_build_bvh_sah
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_sah(aabb_min: np.ndarray, aabb_max: np.ndarray):
    """Binned-SAH build. Returns (node_min, node_max, entry, exit, first,
    last, prim_order), the models.bvh.Bvh contract."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native BVH library unavailable")
    amin = np.ascontiguousarray(aabb_min, np.float32)
    amax = np.ascontiguousarray(aabb_max, np.float32)
    n = len(amin)
    total = 2 * n - 1
    node_min = np.empty((total, 3), np.float32)
    node_max = np.empty((total, 3), np.float32)
    entry = np.empty(total, np.uint32)
    exit_ = np.empty(total, np.uint32)
    first = np.empty(total, np.int64)
    last = np.empty(total, np.int64)
    prim_order = np.empty(n, np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    count = lib.hikari_build_bvh_sah(
        p(amin, ctypes.c_float), p(amax, ctypes.c_float), n,
        p(node_min, ctypes.c_float), p(node_max, ctypes.c_float),
        p(entry, ctypes.c_uint32), p(exit_, ctypes.c_uint32),
        p(first, ctypes.c_int64), p(last, ctypes.c_int64),
        p(prim_order, ctypes.c_int64))
    if count != total:
        raise RuntimeError(f"native BVH build failed: {count} != {total}")
    return node_min, node_max, entry, exit_, first, last, prim_order
