"""Profiling and timing utilities.

Counterpart of ``allset_tpu/utils/profiling.py``, with the same names:
``time_fn`` (median, min and mean seconds per call, fenced on the
device), ``trace`` (a profiler trace of a block, viewable in Perfetto or
TensorBoard) and ``StepTimer``. ``torch.profiler`` takes the place of
``jax.profiler``, and ``torch.cuda.synchronize`` on the outputs' devices
that of the JAX fence.

On the card ``trace`` records CPU and CUDA activity through CUPTI: every
kernel launched in the process shows, the port's own too (they launch
through ctypes, outside PyTorch's dispatcher, so no torch op encloses
them). A trace of a CUDA block without its device's kernels is worth
nothing, so ``trace`` raises where CUPTI is missing and where the trace
it took holds no kernel, and writes no file then. On the CPU it records
CPU activity only. ``trace_summary`` reads a written trace: the largest
device ops and the device's busy share of the traced window.

This module imports nothing of the package, so a script can load it by
path beside another tree's package.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import socket
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

TRACE_SUFFIX = ".pt.trace.json"
# Chrome-trace categories of work on the device (kernels, copies, fills)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def _fence(out) -> None:
    """Wait for the devices of out's CUDA tensors (a CPU output needs no
    fence)."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2):
    """Median/min/mean seconds per call, device-fenced."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _fence(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _fence(out)
        times.append(time.perf_counter() - t0)
    t = np.asarray(times)
    return {
        "median_s": float(np.median(t)),
        "min_s": float(t.min()),
        "mean_s": float(t.mean()),
        "iters": iters,
    }


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "allset_tpu_torch_trace")


def _device_events(path: str) -> list:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device=None):
    """Record a profiler trace of the block into ``log_dir`` (a
    ``*.pt.trace.json`` Chrome/Perfetto file; default: a directory under
    the temporary directory). ``device``: where the block runs; a CUDA
    device (the default where one is available) records CPU and CUDA
    activity and raises, writing nothing, if CUPTI cannot trace the card or
    the trace holds no kernel; the CPU records CPU activity only. Yields
    log_dir."""
    log_dir = _default_dir() if log_dir is None else log_dir
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        if torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("trace: this PyTorch cannot trace CUDA activity (no CUPTI); "
                               "refusing to write a trace without the device's kernels")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize(device)
    name = f"{socket.gethostname()}_{os.getpid()}_{time.time_ns()}{TRACE_SUFFIX}"
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    if cuda and not any(e.get("cat") == "kernel" for e in _device_events(path)):
        os.remove(path)
        raise RuntimeError("trace: the CUDA trace holds no kernel (CUPTI recorded no device "
                           "activity); no trace written")


def latest_trace(log_dir: str) -> str:
    """The newest trace file ``trace`` wrote into log_dir."""
    files = glob.glob(os.path.join(log_dir, "*" + TRACE_SUFFIX))
    if not files:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} file in {log_dir}")
    return max(files, key=os.path.getmtime)


def trace_summary(path: str, top: int = 10) -> dict:
    """The device side of a written trace: ``ops``, the ``top`` device ops
    by summed time ([name, ms, count], largest first), every kernel's name
    (``kernels``), the device's busy time (the union of its ops'
    intervals), the traced window's span (first to last event of any
    kind) and the busy share of it. A CPU trace has no device ops."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    totals = {}
    for e in dev:
        ms, n = totals.get(e["name"], (0.0, 0))
        totals[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    ops = sorted(([k, v[0], v[1]] for k, v in totals.items()), key=lambda r: -r[1])
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in dev):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    span = (max(e["ts"] + e.get("dur", 0) for e in events) - min(e["ts"] for e in events)
            if events else 0.0)
    return {"ops": ops[:top], "kernels": sorted({e["name"] for e in dev if e.get("cat") == "kernel"}),
            "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "busy_share": busy / span if span else 0.0}


class StepTimer:
    """Lightweight running stats for host-side loops (HAN trainer etc.)."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def summary(self):
        t = np.asarray(self.times) if self.times else np.zeros(1)
        return {"mean_s": float(t.mean()), "std_s": float(t.std()), "n": len(self.times)}
