"""What the experiment scripts share: the device, timing, the bench
graph's node side, costs and the report.

Each experiment runs on the card by default (``--device cuda``; without a
card it raises) at its JAX script's shapes; ``--device cpu`` runs the
plain versions at a small size, timed on the host clock (no device
number). Times on the card are CUDA-event means after a warm-up call.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time

import torch

HBM = 3.35e12  # H100 SXM bytes/s (NVIDIA data sheet)
PEAK = {"bf16": 989e12, "tf32x2": 495e12 / 2, "f32": 67e12}  # FLOP/s


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default): the kernels at the script's shapes; cpu: the plain "
                        "versions at a small size")
    p.add_argument("--iters", type=int, default=10, help="timed calls per reading")
    return p


def device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the experiments run on the card (--device cpu runs "
                           "the plain versions at a small size)")
    return torch.device("cuda", 0) if name == "cuda" else torch.device("cpu")


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if dev.type != "cuda":
        return "cpu (host clock, no device time)"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def timed(fn, dev: torch.device, iters: int = 10) -> float:
    """Mean ms of fn() after one warm-up call: CUDA events on the card,
    the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, launches: int = 10, replays: int = 3):
    """Device time of one fn() in ms on the card: ``launches`` calls
    captured in a CUDA graph, the graph replayed between CUDA events (no
    host launch cost)."""
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


def bound_ms(nbytes: float, ops=()) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes at HBM and
    the operations at their peak; ops: [(count, PEAK key)]."""
    tb = nbytes / HBM * 1e3
    to = sum(n / PEAK[k] for n, k in ops) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def scaled_err(got, want) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return float("inf")
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)


@functools.lru_cache(maxsize=None)
def _bench_hd(small: bool):
    from allset_tpu_torch.data import scale_free_hypergraph
    from allset_tpu_torch.graph import add_self_loops, norm_construction

    n, e = (2048, 1024) if small else (131072, 65536)
    raw = scale_free_hypergraph(num_nodes=n, num_hyperedges=e, avg_edge_size=12,
                                feature_dim=256, seed=0)
    return norm_construction(add_self_loops(raw), "all_one")


def bench_batch(dev: torch.device):
    """The bench graph (131,072 nodes, 65,536 hyperedges, edge size 12,
    self-loops), as bench.py and chip_smoke.py build it; on the CPU the
    same generator at 2,048 nodes and 1,024 hyperedges."""
    from allset_tpu_torch.graph import Batch

    return Batch.from_hyperdata(_bench_hd(dev.type == "cpu"), device=dev, bucket=1024)


def walmart_batch(dev: torch.device):
    """The 20-run protocol's graph (synthetic-walmart, prepared as the CLI
    prepares it); on the CPU the small synthetic graph."""
    from allset_tpu_torch.data import load_dataset
    from allset_tpu_torch.train.factory import ExperimentConfig, prepare

    name = "synthetic" if dev.type == "cpu" else "synthetic-walmart"
    data = load_dataset(name, feature_noise=1.0, seed=0)
    return prepare(ExperimentConfig(dname=name), data, dev)[1]


def node_side(batch, split: bool) -> torch.Tensor:
    """The sorted node ids of the bench graph's entries: the E->V reduce
    of the self-loop split (its real entries, ``split``) or every entry
    with the self-loops, int32 on the batch's device."""
    if split:
        d = batch.inc.e2v_split()
        counts = (d.indptr[1:] - d.indptr[:-1]).long()
        ids = torch.repeat_interleave(torch.arange(d.num_dst, device=counts.device), counts)
        return ids.to(torch.int32)
    inc = batch.inc
    return inc.node_sorted[: inc.nnz].to(torch.int32)


def report(name: str, dev: torch.device, rows: list, **extra) -> dict:
    """Print each variant's line and one JSON line; returns the record."""
    head = card(dev)
    print(f"{name} [{head}]", flush=True)
    for r in rows:
        print("  " + r["label"] + ": " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items() if k != "label"), flush=True)
    rec = {"experiment": name, "card": head, "device": dev.type, "variants": rows, **extra}
    print(json.dumps(rec), flush=True)
    return rec


ONEHOT_TOL = 1e-5  # of the plain version's max |.|: exact bf16 products or 3xTF32, f32 sums


def onehot_rows(msgs, dst, bip, nseg, s_blk, chunk, variants, dev, iters, nnz):
    """Each variant (label, segsum_onehot keywords) of the one-hot family
    on one input: the kernel's time (the plain version's where dev is
    the CPU), the plain version's, the check against it (ONEHOT_TOL), the
    bound of the mode's function (full, noonehot: every row of the blocks'
    chunks, its ids and the one-hot products; the surrogates: the first
    s_blk rows of each chunk), the streamed rate (every row of the chunks),
    and, for the segment-sum, torch.segment_reduce over the nnz entries;
    on the card also the device time from a CUDA graph (device_ms)."""
    from allset_tpu_torch.ops import _kernels, cuda_onehot as co

    F, item = msgs.shape[1], msgs.element_size()
    _, nchunks = co.windows(bip, chunk)
    streamed = min(int(nchunks.sum()) * chunk, msgs.shape[0])
    surro = min(int(nchunks.sum()) * s_blk, msgs.shape[0])
    lib_ms = None
    rows = []
    for label, kw in variants:
        mode = kw.get("mode", "full")
        fn = lambda: co.segsum_onehot(msgs, dst, bip, nseg, s_blk, chunk, **kw)
        plain = lambda: co.segsum_onehot_plain(msgs, dst, bip, nseg, s_blk, chunk, **kw)
        before = _kernels.launches["segsum_onehot"]
        ms = timed(fn, dev, iters)
        launches = _kernels.launches["segsum_onehot"] - before
        dev_ms = device_ms(fn) if dev.type == "cuda" else None
        p_ms = timed(plain, dev, 2)
        got, want = fn(), plain()
        err = scaled_err(got, want)
        if not err <= ONEHOT_TOL:
            raise AssertionError(f"segsum_onehot {label} disagrees with its plain version: {err}")
        ids = mode not in ("nodst", "nodst4")
        if mode in ("full", "noonehot"):
            need = streamed * (F * item + 4) + nseg * F * 4 + bip.numel() * 4
            ops = [(2 * s_blk * streamed * F, "bf16" if item == 2 else "tf32x2")]
        else:
            need = surro * (F * item + (4 if mode == "nomatmul" else 0)) + nseg * F * 4
            ops = [(surro * F, "f32")]
        b, by = bound_ms(need, ops)
        if mode == "full" and lib_ms is None:
            offsets = torch.searchsorted(dst[:nnz].contiguous(),
                                         torch.arange(nseg + 1, device=dst.device,
                                                      dtype=dst.dtype)).long()
            lib = lambda: torch.segment_reduce(msgs[:nnz], "sum", offsets=offsets, axis=0)
            lib_ms = timed(lib, dev, iters)
        rows.append({"label": label, "ms": ms, "device_ms": dev_ms, "plain_ms": p_ms,
                     "max_abs_err": (got - want).abs().max().item(), "scaled_err": err,
                     "bound_ms": b, "bound_by": by,
                     "stream_gbs": streamed * (F * item + 4 * ids) / ms / 1e6,
                     "library_ms": lib_ms if mode == "full" else None, "launches": launches})
    return rows


def padded_ids(ids_sorted, nseg, s_blk, chunk, pad_id):
    """The experiments' padding: ids past the last entry set to pad_id,
    to pad_for_kernel(nnz, chunk) rows; the block indptr over nseg
    segments (a multiple of s_blk)."""
    from allset_tpu_torch.ops import cuda_onehot as co

    nnz = ids_sorted.shape[0]
    dst = torch.full((co.pad_for_kernel(nnz, chunk),), pad_id, dtype=torch.int32,
                     device=ids_sorted.device)
    dst[:nnz] = ids_sorted
    return dst, co.block_indptr(ids_sorted, nseg, s_blk)


def normal(shape, dtype, dev, seed):
    """Random normal input from a seed (numpy on the host, as the tests)."""
    import numpy as np

    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(dev).to(dtype)


def stream_row(label, name, fn, plain, library, need_bytes, streamed_bytes, dev, iters):
    """One streaming probe (B5, B7, B8): the kernel's time (the plain
    version's on the CPU), the plain version's, the library call's (a sum
    over a view), the check against the plain version (1e-5 of its max
    |.|: f32 sums in another order), the bound of the function's bytes,
    the rate at which the probe read its bytes and, on the card, the
    device times of the kernel and of the library call from a CUDA graph
    (device_ms, library_device_ms) and the kernel's share of its bound
    (bound / device_ms)."""
    from allset_tpu_torch.ops import _kernels

    before = _kernels.launches[name]
    ms = timed(fn, dev, iters)
    launches = _kernels.launches[name] - before
    dev_ms = device_ms(fn) if dev.type == "cuda" else None
    p_ms = timed(plain, dev, 2)
    lib_ms = timed(library, dev, iters)
    lib_dev = device_ms(library) if dev.type == "cuda" else None
    got, want = fn(), plain()
    err = scaled_err(got, want)
    if not err <= 1e-5:
        raise AssertionError(f"{name} {label} disagrees with its plain version: {err}")
    b, by = bound_ms(need_bytes)
    return {"label": label, "ms": ms, "device_ms": dev_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "max_abs_err": (got - want).abs().max().item(),
            "scaled_err": err, "bound_ms": b, "bound_by": by,
            "share": None if dev_ms is None else b / dev_ms,
            "stream_gbs": streamed_bytes / ms / 1e6, "launches": launches}
