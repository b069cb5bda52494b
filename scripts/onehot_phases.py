"""Where the one-hot segment-sum kernel's time goes: the kernel built
again with one phase cut out at a time, timed at the experiments' shapes
on one card.

    python3 scripts/onehot_phases.py

``csrc/segsum_onehot.cu`` is copied into a temporary directory and built
alone (one nvcc each, all started together) as is and with a phase cut:
``no_build`` (build A writes no one-hot: the products read stale shared
memory), ``no_products`` (no fragments, no mma; builds A and C),
``no_loads`` (no msgs rows copied: the stages compute on stale shared
memory), ``no_write`` (the item's sums are not stored), ``no_stages`` (no
stage runs: the plan kernel, the item's ids, spans and the writes of
zeros, the second pass); and with the registers capped otherwise:
``regs_uncapped`` (no cap: one thread block an SM where the kernel takes
more than 128 registers a thread) and ``two_blocks`` (128 registers
where the kernel caps B1's at 80 for three blocks an SM). A cut variant computes the wrong sums and only its
time is read; the whole build is held to the plain version. Each is
launched through the wrapper (``ops/cuda_onehot.py``) on B2/B4's uniform
ids (bf16, F 384, build A and C), B3's node side (nacc 1) and B1's (f32,
F 256, blocks of 64), and timed by CUDA events (10 calls after a
warm-up) and from a CUDA graph.
Prints a line per input and variant, and one line ``PHASES {json}``; the
card's name and power limit first. Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

CUTS = {
    "whole": [],
    "no_build": [("build_oh<kSR>(s, span, 0);", "(void)0;")],
    "no_products": [("      products(acc, s, slot, span);\n", "      (void)span;\n")],
    "no_loads": [("cp16z(dst + r * LDC + v * EV, msgs + (ok ? row0 + r : 0) * a.F + col0 "
                  "+ v * EV, ok);", "(void)ok;")],
    "no_write": [("*reinterpret_cast<float2*>(dst + (size_t)s * a.F + col) = "
                  "make_float2(v0, v1);",
                  "if (v0 == 12345.f) *reinterpret_cast<float2*>(dst + (size_t)s * a.F + col) = "
                  "make_float2(v0, v1);")],
    "no_stages": [("const int nact = act[kMaxStages],", "const int nact = 0 * act[kMaxStages],")],
    "regs_uncapped": [("__launch_bounds__(kThreads, Cfg<T, MT, NACC>::MIN_BLOCKS)",
                       "__launch_bounds__(kThreads)")],
    "two_blocks": [("__launch_bounds__(kThreads, Cfg<T, MT, NACC>::MIN_BLOCKS)",
                    "__launch_bounds__(kThreads, 2)")],
}


def build(tmp):
    """{variant: the C entry of its library}."""
    from allset_tpu_torch.ops import _kernels

    src = open(os.path.join(HERE, "allset_tpu_torch", "csrc", "segsum_onehot.cu")).read()
    procs = {}
    for name, subs in CUTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the source has no {old!r}")
            text = text.replace(old, new)
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", so, cu], stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (so, p) in procs.items():
        err = p.communicate()[1]
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(so).allset_segsum_onehot
        fn.argtypes = _kernels._SIGNATURES["allset_segsum_onehot"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launcher(fn, *args, **kw):
    """segsum_onehot_cuda(*args, **kw) with its C entry taken from another
    library (the wrapper reads it from ``_kernels.lib()``)."""
    from types import SimpleNamespace

    from allset_tpu_torch.ops import _kernels, cuda_onehot as co

    real = _kernels.lib()
    lib = SimpleNamespace(allset_segsum_onehot=fn, allset_error_string=real.allset_error_string)

    def call():
        _kernels._lib = lib
        try:
            return co.segsum_onehot_cuda(*args, **kw)
        finally:
            _kernels._lib = real

    return call


def main() -> int:
    import numpy as np
    import torch

    from allset_tpu_torch.experiments import common
    from allset_tpu_torch.ops import cuda_onehot as co
    from onehot_probe import device_ms, onehot_cases

    if not torch.cuda.is_available():
        print("onehot_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = common.card(dev)
    print(card, flush=True)
    rec = {"card": card, "phases": {}}
    with tempfile.TemporaryDirectory(prefix="onehot_phases_") as tmp:
        fns = build(tmp)
        cases = onehot_cases(common, co, dev, torch, np)
        runs = [("B2/B4 uniform build A", "B2/B4 uniform", {}),
                ("B2/B4 uniform build C", "B2/B4 uniform", {"build": "C"}),
                ("B3 node side", "B3 node side", {}), ("B1 f32", "B1 f32", {})]
        for label, case, kw in runs:
            msgs, dst, bip, nseg, s_blk, _, ckw = cases[case]
            kw = {**ckw, **kw}
            plain = co.segsum_onehot_plain(msgs, dst, bip, nseg, s_blk, 512, **kw)
            r = {}
            for name, fn in fns.items():
                call = launcher(fn, msgs, dst, bip, nseg, s_blk, 512, **kw)
                if name == "whole":
                    err = common.scaled_err(call(), plain)
                    if not err <= common.ONEHOT_TOL:
                        raise SystemExit(f"{label}: the whole build is {err} from plain")
                r[name] = {"event_ms": common.timed(call, dev, 10), "device_ms": device_ms(call)}
                print(f"  {label} {name}: event {r[name]['event_ms']:.4f} ms, device "
                      f"{r[name]['device_ms']:.4f} ms", flush=True)
            rec["phases"][label] = r
            del plain
            torch.cuda.empty_cache()
    print("PHASES " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
