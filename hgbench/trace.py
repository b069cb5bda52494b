"""The traced run's reduction: ``torch.profiler`` (CPU and CUDA activity,
through CUPTI) around one job, its Chrome trace written to a temporary
directory, read back and deleted.

The busy arithmetic is a frozen copy of
``allset_tpu_torch/utils/profiling.py::trace_summary`` at commit
b978a993e545: the device's busy time is the union of its operations'
intervals (kernels, copies, fills), here clipped to the job's own span,
which a ``record_function`` range of the benchmark marks. Each idle gap
of the device inside the span is named by the innermost host operation
running at its middle.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
SPAN = "hgbench.job"
TOP = 10


def kernel_base(name: str) -> str:
    """A device op's name without its leading return type and the
    anonymous namespace the port's kernels live in: ``void (anonymous
    namespace)::pma_bwd_wg_kernel<float>(...)`` -> ``pma_bwd_wg_kernel<float>(...)``.
    PyTorch's and the libraries' kernels keep their namespaces."""
    return re.sub(r"^(void\s+)?(\(anonymous namespace\)::)?", "", name)


def traced(fn: Callable):
    """(fn()'s result, its trace summary): see :func:`summarize`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("this PyTorch cannot trace CUDA activity (no CUPTI)")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="hgbench_trace_")
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(SPAN):
                out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        path = os.path.join(tmp, "job.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, summarize(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def _innermost(host: List[dict], times: List[float]) -> List[str]:
    """For each of the ascending ``times``, the name of the innermost host
    event (they nest on one thread) running then: a sweep with a stack of
    the open events."""
    host = sorted(host, key=lambda e: (e["ts"], -e.get("dur", 0)))
    names, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i]["ts"] <= t:
            e = host[i]
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < t:
            stack.pop()
        names.append(stack[-1]["name"] if stack else "host, between ops")
    return names


def summarize(events: List[dict]) -> dict:
    """From a trace's complete events: ``device_s`` {op name: seconds}
    inside the job's span, ``busy_s``, ``window_s`` (the span),
    ``device_ops`` (the TOP ops by time, [name, seconds]) and
    ``idle_gaps`` (the device's idle time inside the span by the host
    operation running then, the TOP largest, [name, seconds])."""
    spans = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"the trace holds no {SPAN!r} range")
    span = spans[0]
    w0, w1 = span["ts"], span["ts"] + span.get("dur", 0)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0]
    device_s: Dict[str, float] = {}
    for e in dev:
        device_s[e["name"]] = device_s.get(e["name"], 0.0) + e.get("dur", 0) / 1e6
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)) for e in dev])
    busy_us = sum(t1 - t0 for t0, t1 in busy)
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("tid") == span.get("tid")
            and e.get("pid") == span.get("pid") and e is not span]
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    idle_iv = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps: Dict[str, float] = {}
    for (a, b), name in zip(idle_iv, _innermost(host, [(a + b) / 2 for a, b in idle_iv])):
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    top = sorted(device_s.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_s": device_s, "busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}
