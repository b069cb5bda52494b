"""Build, load and count the hand-written CUDA kernels.

The sources under ``allset_tpu_torch/csrc/*.cu`` are compiled by ``nvcc``
for Hopper (``sm_90a``), one ``nvcc`` per source, all started together,
and linked into one shared library with a plain C interface,
``allset_tpu_torch/_build/libkernels.so`` (an ignored directory), at first
use, and again whenever a source or a header (``*.cuh``) is newer than
the library. The library is loaded with ctypes; every pointer and the
stream are passed as ``c_void_p``. Each C entry returns ``cudaGetLastError()`` after its
launches, and :func:`check` raises if it is not zero. A failed build
raises too: there is no fallback.

``launches`` counts, per kernel, the calls that launched it. A wrapper
adds one where it launches its kernel and nowhere else. The counters
(``KERNELS``): K1 ``segment_sum`` and K1 with the gather inside
``segment_sum_gather`` (``csrc/segment_sum.cu``); the PMA epilogue, its
runs grids and the score+pack; the LayerNorm pair; the row gathers
``gather`` and ``gather_sorted``; ``segsum_onehot``, one counter for the
one-hot segment-sum experiments B1-B4 and B6 (``csrc/segsum_onehot.cu``);
``stream_flat``, ``stream_dual`` and ``stream_fold``, the probes B5, B7
and B8 (``csrc/stream.cu``).
"""

from __future__ import annotations

import collections
import ctypes
import glob
import os
import os.path as osp
import shutil
import subprocess
import time

import torch

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
_CSRC = osp.join(_PKG, "csrc")
BUILD_DIR = osp.join(_PKG, "_build")
_SO = osp.join(BUILD_DIR, "libkernels.so")

KERNELS = ("segment_sum", "pma_epilogue_fwd", "pma_epilogue_bwd",
           "pma_epilogue_fwd_runs", "pma_epilogue_bwd_runs", "pma_gmax", "pma_pack",
           "layer_norm_fwd", "layer_norm_bwd", "gather", "gather_sorted",
           "segment_sum_gather", "segsum_onehot", "stream_flat", "stream_dual", "stream_fold")
launches = collections.Counter({k: 0 for k in KERNELS})

_lib = None
build_seconds = 0.0
build_log = ""  # nvcc's stderr of the last build: -Xptxas -v registers and spills

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
_SIGNATURES = {
    "allset_segment_sum": [P, P, P, I, P, I, P, P, I, I, P],
    "allset_pma_epilogue_fwd": [P] * 10 + [I] * 8 + [P],
    "allset_pma_epilogue_bwd": [P] * 17 + [I] * 11 + [P],
    "allset_pma_gmax": [P] * 3 + [I] * 6 + [P],
    "allset_pma_pack": [P] * 5 + [I] * 6 + [P],
    "allset_layer_norm_fwd": [P] * 4 + [LL, I, I, LL, LL, I, I, P],
    "allset_layer_norm_bwd": [P] * 8 + [LL, I, I, LL, LL, I, I, I, P],
    "allset_pma_wide_fwd": [P] * 10 + [I] * 9 + [P],
    "allset_pma_wide_bwd": [P] * 17 + [I] * 9 + [P],
    "allset_gather": [P, P, I, P, LL, LL, LL, P],
    "allset_gather_sorted": [P, P, I, P, LL, LL, LL, P],
    "allset_segment_sum_gather": [P, LL, P, I, P, I, I, I, P, P, I, P, I, P, P, I, I, P],
    "allset_segsum_onehot": [P, P, P, LL] + [I] * 9 + [P, I, P],
    "allset_stream": [P, P, P] + [I] * 5 + [P, P, I, P],
}


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def _nvcc() -> str:
    cand = osp.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if osp.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into the shared library if it is missing or
    older than a source or header; returns its path."""
    global build_seconds, build_log
    srcs = sorted(glob.glob(osp.join(_CSRC, "*.cu")))
    newest = max(osp.getmtime(s) for s in srcs + glob.glob(osp.join(_CSRC, "*.cuh")))
    if not force and osp.exists(_SO) and osp.getmtime(_SO) >= newest:
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    objs = [osp.join(BUILD_DIR, osp.basename(s)[:-3] + f".{tag}.o") for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", o, s], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(srcs, objs)]
    logs = [(s, p.communicate()[1]) for s, p in zip(srcs, procs)]
    build_log = "".join(e for _, e in logs)
    errs = [(s, e) for (s, e), p in zip(logs, procs) if p.returncode != 0]
    tmp = f"{_SO}.{tag}"
    if not errs:
        r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True,
                           text=True)
    for o in objs:
        if osp.exists(o):
            os.remove(o)
    if errs:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{s}:\n{e}" for s, e in errs))
    build_seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, _SO)  # atomic: a concurrent loader sees old or new
    return _SO


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        so.allset_error_string.argtypes = [ctypes.c_int]
        so.allset_error_string.restype = ctypes.c_char_p
        _lib = so
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().allset_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
