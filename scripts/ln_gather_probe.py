"""Event and device times of B9 (the sorted gather) and B13 (the LayerNorm
backward) at the main path's shapes, on one card.

    python3 scripts/ln_gather_probe.py [--tree TREE]

TREE is this checkout by default, or another one (for example an earlier
commit unpacked with ``git archive`` into an ignored directory): the
script imports TREE's package and TREE's ``chip_smoke.py`` for its
helpers (the package never imports either).

B9: the sorted gathers of one CEGAT bench step (bf16, 8 heads of 32, on
the bench graph's V2V graph) and of one HAN step (``benchmarks/
han_bench.py``'s graph, f32), recorded through
``chip_smoke.record_launches``. Per shape, B9, B10 and index_select (on
the ids clamped beforehand) are each timed two ways: the event time of
20 calls back to back (``chip_smoke.cuda_ms``, what chip_smoke's phases
4c and 4e report; where the wrapper's host work per call is longer than
the kernel, this is the host's rate), and the device time of one call,
from a CUDA graph of 20 calls replayed 5 times between events. Beside
them the host time of one wrapper call (20 calls enqueued, no sync).

B13: at an AllDeepSets bench step's launches (``chip_smoke.
ln_step_shapes``, bf16) and a 20-run epoch's (the walmart preset, f32,
``EPOCH_SHAPES``), the wrapper's event and device times. Where TREE's
``csrc/layer_norm.cu`` has the column pass of the earlier 64-row design,
also the split: the C entry built alone twice into a temporary
directory, as is and with the column pass compiled out, each launched
with the wrapper's arguments and timed from a CUDA graph; the row pass
with the partials' sum is the second, the column pass the difference.

Prints a line per shape, the sums per step and epoch, and one line
``PROBE {json}`` with them; the card's name and power limit first.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# B13's launches in one 20-run AllDeepSets epoch of the walmart preset
# (f32; runs in groups of 18 and 2; chip_smoke.time_layer_norm_epoch
# records them): (rows, R, F, dx needed, launches)
EPOCH_SHAPES = ((158_766, 18, 256, True, 4), (158_766, 2, 256, True, 4),
                (88_860, 18, 100, False, 1), (88_860, 18, 256, True, 3),
                (88_860, 2, 100, False, 1), (88_860, 2, 256, True, 3))
# the column pass of csrc/layer_norm.cu's 64-row ln_bwd_kernel
COLUMN_PASS = ("  const long long out = ((long long)r * gridDim.x + blk) * F;\n"
               "  for (int c = threadIdx.x; c < F; c += THREADS) {\n")


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device time of one fn() in ms: ``launches`` calls captured in a CUDA
    graph, the graph replayed between CUDA events (no host launch cost)."""
    import torch

    fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / (replays * launches)


def host_us(fn, calls: int = 20) -> float:
    """Host time of one fn() in microseconds: ``calls`` calls enqueued back
    to back on the host clock, the device drained before and after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def sorted_gather_calls(cs, dev):
    """The sorted gathers of one CEGAT bench step and one HAN step ->
    [(what, shape, dtype, ids, launches)]."""
    import torch

    from allset_tpu_torch.graph import Batch
    from allset_tpu_torch.train.factory import v2v_incidence

    raw = cs.bench_raw()
    batches = {"CEGAT": Batch.from_incidence(raw, v2v_incidence(raw, "CEGAT", bucket=1024), dev)}
    model, batch, mask = cs.zoo_model(batches, dev, "CEGAT", dict(cs.CE)["CEGAT"])
    _, calls, _ = cs.record_launches(lambda: cs.run_steps(model, batch, mask, 1))
    out = [("CEGAT", *g) for g in cs.group_calls(calls)]
    del model, batch, batches
    _, hbatch = cs.han_graphs(dev)
    model = cs.han_model(0, dev)
    _, calls, _ = cs.record_launches(
        lambda: cs.run_steps(model, hbatch, cs.han_loss_mask(hbatch), 1))
    out += [("HAN", *g) for g in cs.group_calls(calls)]
    del model
    torch.cuda.empty_cache()
    return out


def probe_b9(cs, dev, calls):
    """Per recorded shape: event, device and host times of B9, B10 and
    index_select; B9 held bit for bit to its plain version. Returns
    {shape key: {...}} and the sums per CEGAT and HAN step."""
    import torch

    from allset_tpu_torch.ops import cuda_gather as cg

    rows, sums = {}, {}
    for what, shape, dtype, ids, n in calls:
        table = torch.randn(shape, device=dev).to(dtype)
        clamped = ids.clamp(0, shape[0] - 1)
        fns = {"b9": lambda: cg.gather_sorted_fwd_cuda(table, ids),
               "b10": lambda: cg.gather_fwd_cuda(table, ids),
               "index_select": lambda: table.index_select(0, clamped)}
        cs.require(torch.equal(fns["b9"](), cg.gather_sorted_fwd_plain(table, ids)),
                   f"B9 differs at [{ids.shape[0]}, {list(shape[1:])}]")
        r = {"launches": n, "distinct": int(torch.unique(clamped).numel())}
        for k, fn in fns.items():
            r[f"{k}_event_ms"] = cs.cuda_ms(fn, iters=20)
            r[f"{k}_device_ms"] = graph_ms(fn)
            r[f"{k}_host_us"] = host_us(fn)
        key = f"{what} [{ids.shape[0]}, {list(shape[1:])}] {str(dtype)[6:]}"
        rows[key] = r
        print(f"  B9 {key} from {shape[0]} rows ({r['distinct']} distinct, x{n}): "
              + ", ".join(f"{k} event {r[f'{k}_event_ms']:.4f} ms, device "
                          f"{r[f'{k}_device_ms']:.4f} ms, host {r[f'{k}_host_us']:.1f} us"
                          for k in fns), flush=True)
        for k in fns:
            for t in ("event", "device"):
                s = sums.setdefault(f"{what}_step", {})
                s[f"{k}_{t}_ms"] = s.get(f"{k}_{t}_ms", 0.0) + n * r[f"{k}_{t}_ms"]
        del table
    return rows, sums


def split_libs(tree):
    """TREE's layer_norm.cu built alone as is and with the column pass
    compiled out -> (whole, row pass) ctypes libraries, or None where the
    source has no such column pass."""
    from allset_tpu_torch.ops import _kernels

    src = open(os.path.join(tree, "allset_tpu_torch", "csrc", "layer_norm.cu")).read()
    if COLUMN_PASS not in src:
        return None
    cut = src.replace(COLUMN_PASS, COLUMN_PASS.replace("c < F;", "c < 0;"))
    libs = []
    with tempfile.TemporaryDirectory(prefix="ln_split_") as tmp:
        procs = []
        for name, text in (("whole", src), ("rows", cut)):
            cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
            with open(cu, "w") as f:
                f.write(text)
            procs.append((so, subprocess.Popen(
                [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so, cu],
                stderr=subprocess.PIPE, text=True)))
        for so, p in procs:
            err = p.communicate()[1]
            if p.returncode != 0:
                raise SystemExit(f"nvcc failed:\n{err}")
            fn = ctypes.CDLL(so).allset_layer_norm_bwd  # loaded: the file may go
            fn.argtypes = _kernels._SIGNATURES["allset_layer_norm_bwd"]
            fn.restype = ctypes.c_int
            libs.append(fn)
    return libs


def probe_b13(cs, dev, libs, step_shapes):
    """B13's event and device times at the step's and the epoch's shapes,
    and with ``libs`` the row pass's device time. Returns per-shape rows
    and the sums per step and epoch."""
    import torch

    from allset_tpu_torch.ops import _kernels, cuda_ln as cl

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [("step", rows, 1, 256, xdt, torch.bfloat16, dx, step_shapes.count((rows, xdt, dx)))
              for rows, xdt, dx in sorted(set(step_shapes), key=str)]
    shapes += [("epoch", rows, R, F, torch.float32, torch.float32, dx, n)
               for rows, R, F, dx, n in EPOCH_SHAPES]
    out, sums = {}, {}
    for what, rows, R, F, xdt, gdt, need_dx, n in shapes:
        lead = (rows,) if what == "step" else (rows, R)
        x = (2 * torch.randn(lead + (F,), device=dev, generator=gen) + 1).to(xdt)
        g = torch.randn(lead + (F,), device=dev, generator=gen).to(gdt)
        gamma = 1 + 0.3 * torch.randn(((R,) if what == "epoch" else ()) + (F,), device=dev,
                                      generator=gen)
        fn = lambda: cl.ln_bwd_cuda(g, x, gamma, need_dx)
        r = {"launches": n, "event_ms": cs.cuda_ms(fn, iters=20), "device_ms": graph_ms(fn)}
        if libs is not None:
            nblk = -(-rows // cl.BWD_ROWS)
            dx = torch.empty(lead + (F,), dtype=xdt, device=dev) if need_dx else None
            part = torch.empty(2, R, nblk, F, device=dev)
            dgb = torch.empty(2, R, F, device=dev)
            xs_row, xs_run = (F, 0) if what == "step" else (R * F, F)

            def call(entry):
                rc = entry(g.data_ptr(), x.data_ptr(), gamma.data_ptr(),
                           0 if dx is None else dx.data_ptr(), part[0].data_ptr(),
                           part[1].data_ptr(), dgb[0].data_ptr(), dgb[1].data_ptr(), rows, R, F,
                           xs_row, xs_run, nblk, _kernels.dtype_code(x), _kernels.dtype_code(g),
                           _kernels.stream_ptr(x))
                if rc != 0:
                    raise RuntimeError(f"layer_norm_bwd copy: CUDA error {rc}")

            r["whole_copy_device_ms"] = graph_ms(lambda: call(libs[0]))
            r["row_pass_device_ms"] = graph_ms(lambda: call(libs[1]))
            r["column_pass_device_ms"] = r["whole_copy_device_ms"] - r["row_pass_device_ms"]
            del dx, part, dgb
        key = f"{what} x {list(lead + (F,))} {str(xdt)[6:]}{' dx' if need_dx else ''}"
        out[key] = r
        print(f"  B13 {key} (x{n}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items() if k != "launches"), flush=True)
        s = sums.setdefault(what, {})
        for k, v in r.items():
            if k != "launches":
                s[k] = s.get(k, 0.0) + n * v
        del x, g
        torch.cuda.empty_cache()
    return out, sums


def step_shapes(cs):
    """B13's launches of an AllDeepSets bench step: chip_smoke.ln_step_shapes
    on the bench graph's sizes (131,072 nodes, 65,536 hyperedges)."""
    bench = SimpleNamespace(num_nodes=131_072,
                            inc=SimpleNamespace(real=SimpleNamespace(num_edges=65_536)))
    return cs.ln_step_shapes(bench)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE, help="the checkout to measure")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from allset_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        print("ln_gather_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    print(f"tree {tree}", flush=True)
    _kernels.build(force=True)
    _kernels.lib()
    calls = sorted_gather_calls(cs, dev)
    b9, b9_sums = probe_b9(cs, dev, calls)
    del calls
    libs = split_libs(tree)
    print(f"  B13 split: {'column pass compiled out in a copy' if libs else 'no column pass'}",
          flush=True)
    b13, b13_sums = probe_b13(cs, dev, libs, step_shapes(cs))
    for k, v in {**b9_sums, **{f"B13 per {k}": v for k, v in b13_sums.items()}}.items():
        print(f"  {k}: " + ", ".join(f"{a} {b:.4f}" for a, b in v.items()) + f" [{card}]",
              flush=True)
    print("PROBE " + json.dumps({"tree": tree, "card": card, "b9": b9, "b9_sums": b9_sums,
                                 "b13": b13, "b13_sums": b13_sums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
