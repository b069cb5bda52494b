"""ctypes bindings for the native host preprocessing kernels.

Counterpart of ``allset_tpu/graph/native.py``. The C++ source is shared:
``native/hypercore.cpp`` at the repository root is built on demand with
g++ into this package's ignored ``_build/`` directory. Every entry point
has a pure-numpy fallback, so the host build works without a toolchain;
both give identical arrays.
"""

from __future__ import annotations

import ctypes
import os
import os.path as osp
import subprocess
from typing import Optional, Tuple

import numpy as np

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
_SRC = osp.join(osp.dirname(_PKG), "native", "hypercore.cpp")
_BUILD_DIR = osp.join(_PKG, "_build")
_SO = osp.join(_BUILD_DIR, "libhypercore.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False

I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not osp.exists(_SRC):
        return None
    try:
        if not osp.exists(_SO) or osp.getmtime(_SO) < osp.getmtime(_SRC):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", _SO, _SRC],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(_SO)
    except (OSError, subprocess.CalledProcessError):
        return None  # no toolchain: the numpy fallbacks serve
    lib.hypercore_clique_expand.restype = ctypes.c_int64
    lib.hypercore_clique_expand.argtypes = [
        I64P, I64P, ctypes.c_int64, ctypes.c_int64, I64P, I64P, F32P, ctypes.c_int64,
    ]
    lib.hypercore_coalesce.restype = ctypes.c_int64
    lib.hypercore_coalesce.argtypes = [I64P, I64P, ctypes.c_int64, I64P, I64P]
    lib.hypercore_counting_argsort.restype = None
    lib.hypercore_counting_argsort.argtypes = [
        I64P, ctypes.c_int64, ctypes.c_int64, I64P,
    ]
    _lib = lib
    return _lib


def clique_expand(
    node: np.ndarray, edge: np.ndarray, num_edges: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native weighted clique expansion: (pairs [2, P] i<j, weights [P]) in
    the library's order; None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    node = np.ascontiguousarray(node, dtype=np.int64)
    edge = np.ascontiguousarray(edge, dtype=np.int64)
    sizes = np.bincount(edge, minlength=num_edges).astype(np.int64)
    cap = int((sizes * (sizes - 1) // 2).sum())
    if cap == 0:
        return np.zeros((2, 0), np.int64), np.zeros(0, np.float32)
    out_i = np.empty(cap, np.int64)
    out_j = np.empty(cap, np.int64)
    out_w = np.empty(cap, np.float32)
    k = lib.hypercore_clique_expand(
        node, edge, len(node), num_edges, out_i, out_j, out_w, cap
    )
    if k < 0:
        return None
    return np.stack([out_i[:k], out_j[:k]]), out_w[:k]


def coalesce(node: np.ndarray, edge: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native sort-by-(edge, node) + dedup; None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    node = np.ascontiguousarray(node, dtype=np.int64)
    edge = np.ascontiguousarray(edge, dtype=np.int64)
    out_node = np.empty_like(node)
    out_edge = np.empty_like(edge)
    k = lib.hypercore_coalesce(node, edge, len(node), out_node, out_edge)
    return out_node[:k], out_edge[:k]


def counting_argsort(keys: np.ndarray, num_keys: int) -> Optional[np.ndarray]:
    """Stable argsort of integer keys in [0, num_keys): O(n + K) counting
    sort in C++. None when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    out = np.empty(len(keys), np.int64)
    lib.hypercore_counting_argsort(keys, len(keys), int(num_keys), out)
    return out


def stable_argsort(keys: np.ndarray, num_keys: int) -> np.ndarray:
    """counting_argsort with the numpy fallback (the same permutation)."""
    out = counting_argsort(keys, num_keys)
    if out is None:
        out = np.argsort(keys, kind="stable")
    return out
