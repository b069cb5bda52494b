"""B8's phase split on one card: the device time of each kernel a call of
``stream_fold`` launches, at ``experiments/exp_autopipe.py``'s shapes.

    python3 scripts/stream_phases.py [--tree TREE] [--calls 10] [--blocks N]

TREE is this checkout by default, or another one (for example an earlier
commit unpacked with ``git archive`` into an ignored directory): the
script imports TREE's package (which never imports JAX) and this
checkout's ``allset_tpu_torch/utils/profiling.py`` by path, so a tree
without the profiler is split the same way.

x [524,288, 384] bf16 from a seed, chunks of 512, 1,024 and 2,048 rows,
both bodies ("fold": every row into acc[r % 16]; "first16": each chunk's
first 16 rows). Per case: the check against the plain version (1e-5 of
its max |.|) and two calls bit for bit; the event time of ``--calls``
calls back to back after a warm-up; the device time of one call from a
CUDA graph of 10 calls replayed 3 times; the same two times of the
library call (a sum over a view); the bound (the function's bytes at
3.35 TB/s); and, from a torch.profiler trace of ``--calls`` calls, each
kernel's device time per call by name (the phases: for the fold, the
streaming kernel and the pass that adds the partials).

``--blocks N`` runs the fold on a grid of N blocks in place of the
persistent grid of one block an SM (``cuda_stream.fold_blocks``;
a tree without it ignores the option), to compare grids on one card.

Prints a line per case and one line ``PHASES {json}``; the card's name
and power limit first. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM = 3.35e12


def device_ms(fn, launches: int = 10, replays: int = 3) -> float:
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
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
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


def event_ms(fn, calls: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def load_profiling():
    path = os.path.join(HERE, "allset_tpu_torch", "utils", "profiling.py")
    spec = importlib.util.spec_from_file_location("_stream_phases_profiling", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phases(fn, calls: int, prof) -> dict:
    """{kernel name: device ms per call} from a trace of ``calls`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with prof.trace(d, "cuda"):
            for _ in range(calls):
                fn()
        summ = prof.trace_summary(prof.latest_trace(d), top=100)
    return {name: ms / calls for name, ms, _ in summ["ops"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=HERE)
    p.add_argument("--calls", type=int, default=10)
    p.add_argument("--blocks", type=int, default=None)
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("stream_phases: no CUDA device", file=sys.stderr)
        return 1
    from allset_tpu_torch.ops import _kernels, cuda_stream as cst

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.blocks is not None and hasattr(cst, "fold_blocks"):
        cst.fold_blocks = lambda x: args.blocks
    print(f"{card}; tree {tree}; fold blocks "
          f"{args.blocks if args.blocks is not None else 'one an SM'}", flush=True)
    prof = load_profiling()
    dev = torch.device("cuda", 0)
    f, rows_n = 384, 512 * 1024
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((rows_n, f), dtype=np.float32))
    x = x.to(dev).to(torch.bfloat16)
    seed = torch.zeros(16, f, device=dev)
    out = []
    for body in cst.BODIES:
        for chunk in (512, 1024, 2048):
            n = rows_n // chunk
            fn = lambda: cst.stream_fold(x, seed, chunk, body)
            if body == "fold":
                lib = lambda: x[: n * chunk].view(-1, 16, f).sum(0, dtype=torch.float32)
                need = n * chunk * f * 2
            else:
                lib = lambda: x[: n * chunk].view(n, chunk, f)[:, :16].sum(0, dtype=torch.float32)
                need = n * 16 * f * 2
            need += 2 * 16 * f * 4
            got, want = fn(), cst.stream_fold_plain(x, seed, chunk, body)
            err = (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)
            if not err <= 1e-5:
                raise AssertionError(f"{body} chunk {chunk}: {err} off the plain version")
            if not torch.equal(got, fn()):
                raise AssertionError(f"{body} chunk {chunk}: two calls differ")
            before = _kernels.launches["stream_fold"]
            row = {"body": body, "chunk": chunk, "scaled_err": err,
                   "ms": event_ms(fn, args.calls), "device_ms": device_ms(fn),
                   "library_ms": event_ms(lib, args.calls), "library_device_ms": device_ms(lib),
                   "bound_ms": need / HBM * 1e3, "phases": phases(fn, args.calls, prof)}
            row["launches"] = _kernels.launches["stream_fold"] - before
            row["share"] = row["bound_ms"] / row["device_ms"]
            print(f"  {body} chunk={chunk}: event {row['ms']:.4f} ms, device "
                  f"{row['device_ms']:.4f} (share {row['share']:.3f} of bound "
                  f"{row['bound_ms']:.4f}), library {row['library_ms']:.4f} / device "
                  f"{row['library_device_ms']:.4f}, err {err:.2e}; phases (device ms a call) "
                  + ", ".join(f"{k[:48]} {v:.4f}" for k, v in row["phases"].items()),
                  flush=True)
            out.append(row)
    print("PHASES " + json.dumps({"card": card, "tree": tree, "blocks": args.blocks,
                                  "rows": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
