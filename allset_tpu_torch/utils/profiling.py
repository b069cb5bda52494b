"""Spans, profiler traces and their summary.

``span`` records a named interval of the program into the process's
recorder (``RECORDER``): its name, an id, the id of the span enclosing it
on the opening thread (``parent``), the id of the fit it belongs to
(``fit``: a span opened with ``fit=True`` starts one, every other span
inherits its parent's), its host start and end
(``time.perf_counter_ns``), optional ``counts`` and, where asked, the
device's milliseconds. Host spans are always on: two clock reads and an
append. While a ``torch.profiler`` profile is active (``trace``, the
CLI's ``--profile``, the benchmark's traced run) a span also opens a
``torch.profiler.record_function`` range of its name, so it lands in the
profiler's Chrome trace beside the kernels and on the profiler's clock,
and a span given a CUDA ``device`` puts a pair of timing events on that
device's current stream at its edges; ``Span.device_ms`` reads their
elapsed time once the work has finished. With the profiler off no range
and no event is made. ``annotate`` opens a profiler range alone, kept
nowhere. The recorder keeps the first MAX_SPANS spans to close and counts
those beyond (``dropped``); ``spans`` returns the kept ones in the order
they closed, ``reset`` empties the recorder.

``trace`` takes a profiler trace of a block, viewable in Perfetto or
TensorBoard. On the card it records CPU and CUDA activity through CUPTI:
every kernel launched in the process shows, the port's own too (they
launch through ctypes, outside PyTorch's dispatcher, so no torch op
encloses them). A trace of a CUDA block without its device's kernels is
worth nothing, so ``trace`` raises where CUPTI is missing and where the
trace it took holds no kernel, and writes no file then. On the CPU it
records CPU activity only. ``trace_summary`` reads a written trace: the
largest device ops and the device's busy share of the traced window.

This module imports nothing of the package, so a script can load it by
path beside another tree's package.
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import json
import os
import socket
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

TRACE_SUFFIX = ".pt.trace.json"
# Chrome-trace categories of work on the device (kernels, copies, fills)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


# spans a recorder keeps; those beyond are counted in ``dropped``
MAX_SPANS = 1 << 16


class Span:
    """One recorded interval (see the module's docstring), entered with
    ``with``. ``seconds`` is its host duration; ``device_ms`` the device's
    elapsed milliseconds between its edges, or None where it put no
    timing events (the profiler off, or no CUDA device given)."""

    __slots__ = ("name", "id", "parent", "fit", "t0_ns", "t1_ns", "counts", "profiled",
                 "_rec", "_device", "_new_fit", "_range", "_events", "_ms")

    def __init__(self, rec: "Recorder", name: str, device, new_fit: bool):
        self._rec, self.name, self._device, self._new_fit = rec, name, device, new_fit
        self.id = self.parent = self.fit = None
        self.t0_ns = self.t1_ns = 0
        self.counts: Dict[str, int] = {}
        self.profiled = False
        self._range = self._events = self._ms = None

    def __enter__(self) -> "Span":
        stack = self._rec._stack()
        outer = stack[-1] if stack else None
        self.id = next(self._rec._ids)
        self.parent = None if outer is None else outer.id
        self.fit = self.id if self._new_fit else (None if outer is None else outer.fit)
        self.profiled = torch.autograd._profiler_enabled()
        if self.profiled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            if self._device is not None and torch.device(self._device).type == "cuda":
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record(torch.cuda.current_stream(self._device))
        stack.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._rec._close(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    @property
    def device_ms(self) -> Optional[float]:
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._ms = start.elapsed_time(end)
            self._events = None
        return self._ms


class Recorder:
    """Keeps the first ``cap`` spans to close; counts the rest in
    ``dropped``. Spans nest on the thread that opens them."""

    def __init__(self, cap: int = MAX_SPANS):
        self.cap = cap
        self.dropped = 0
        self._spans: List[Span] = []
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()

    def span(self, name: str, device=None, fit: bool = False) -> Span:
        return Span(self, name, device, fit)

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, s: Span) -> None:
        self._stack().pop()
        with self._lock:
            if len(self._spans) < self.cap:
                self._spans.append(s)
            else:
                self.dropped += 1

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans = []
            self.dropped = 0


RECORDER = Recorder()


def span(name: str, device=None, fit: bool = False) -> Span:
    """A span of the process's recorder: ``with span("trainer.epoch",
    device) as s: ...``. ``device``: where the span's work runs; a CUDA
    device gets timing events while the profiler is active. ``fit``: the
    span starts a fit, whose id its inner spans carry."""
    return RECORDER.span(name, device, fit)


def spans() -> List[Span]:
    """The process's recorded spans, in the order they closed."""
    return RECORDER.spans()


def dropped() -> int:
    """Spans the process's recorder counted beyond its cap."""
    return RECORDER.dropped


def reset() -> None:
    RECORDER.reset()


def annotate(name: str):
    """A ``record_function`` range of ``name`` while a profile is active,
    else a context that does nothing; never recorded."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


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
