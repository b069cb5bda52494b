"""Event and device times of the one-hot segment-sum (B1-B4, B6) and the
probes B5 and B7 at their experiments' shapes, on one card.

    python3 scripts/onehot_probe.py [--tree TREE] [--sweep 1024,2048,4096]

TREE is this checkout by default, or another one (for example an earlier
commit unpacked with ``git archive`` into an ignored directory): the
script imports TREE's package (which never imports JAX).

Inputs as the experiment modules make them (``allset_tpu_torch/
experiments``): B3's node side (the bench graph's E->V reduce of the
self-loop split, F 384 bf16, blocks of 256 segments, chunks of 512 rows)
as it is and with the hub block's entries taken out (the largest block,
92% of the entries; the rest keep their ids and padding), B6's (every
entry, ``full``), B2/B4's uniform ids (452,608 over 131,072 segments)
and B1's (524,288 over 32,768, F 256 f32, blocks of 64). Each is timed
two ways: the event time of 10 calls back to back after a warm-up (what
the experiments report) and the device time of one call from a CUDA
graph of 10 calls replayed 3 times; each output is held to the plain
version (``ONEHOT_TOL``), and ``torch.segment_reduce`` is timed beside
it. With ``--sweep`` (a tree whose wrapper takes ``item_rows``) B3, B6,
B2 and B1 again at each work-item size. B5 and B7 at
``exp_segsum_ablate``'s shapes, with their sums over a view, also the
host time of one call (20 enqueued back to back).

Prints a line per reading and one line ``PROBE {json}``; the card's name
and power limit first. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def onehot_cases(common, co, dev, torch, np):
    """{name: (msgs, dst, bip, nseg, s_blk, nnz, keywords)}."""
    batch = common.bench_batch(dev)
    cases = {}
    for name, split in (("B3 node side", True), ("B6 node side", False)):
        ids = common.node_side(batch, split=split)
        m_pad = -(-batch.num_nodes // 256) * 256
        dst, bip = common.padded_ids(ids, m_pad, 256, 512, m_pad + 7)
        msgs = common.normal((dst.shape[0], 384), torch.bfloat16, dev, 0)
        kw = {"nacc": 1} if split else {"mode": "full"}
        cases[name] = (msgs, dst, bip, m_pad, 256, ids.shape[0], kw)
        if split:
            hub = int(torch.argmax(bip[1:] - bip[:-1]))
            rest = ids[torch.div(ids, 256, rounding_mode="floor") != hub].contiguous()
            dst2, bip2 = common.padded_ids(rest, m_pad, 256, 512, m_pad + 7)
            msgs2 = common.normal((dst2.shape[0], 384), torch.bfloat16, dev, 0)
            held = int(bip[hub + 1] - bip[hub])
            print(f"  B3 hub block {hub}: {held} of {ids.shape[0]} entries", flush=True)
            cases["B3 without the hub block"] = (msgs2, dst2, bip2, m_pad, 256, rest.shape[0], kw)
    del batch
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.sort(rng.integers(0, 131072, 452608)).astype(np.int32)).to(dev)
    dst, bip = common.padded_ids(ids, 131072, 256, 512, 131072 + 7)
    msgs = common.normal((dst.shape[0], 384), torch.bfloat16, dev, 0)
    cases["B2/B4 uniform"] = (msgs, dst, bip, 131072, 256, 452608, {})
    nnz, m = 1 << 19, 1 << 15
    ids = np.sort(np.random.default_rng(0).integers(0, m, nnz)).astype(np.int32)
    dst = torch.from_numpy(np.concatenate([ids, np.full(1024, m, np.int32)])).to(dev)
    x = np.random.default_rng(0).normal(size=(nnz + 1024, 256)).astype(np.float32)
    x[nnz:] = 0
    bip = torch.from_numpy(np.searchsorted(dst.cpu().numpy(), np.arange(0, m + 64, 64))
                           .astype(np.int32)).to(dev)
    cases["B1 f32"] = (torch.from_numpy(x).to(dev), dst, bip, m, 64, nnz, {})
    return cases


def host_us(fn, calls: int = 20) -> float:
    """Host time of one fn() in microseconds: ``calls`` calls enqueued back
    to back on the host clock, the device drained before and after."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE, help="the checkout to measure")
    ap.add_argument("--sweep", default="", help="work-item rows to sweep, comma-separated")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from allset_tpu_torch.experiments import common
    from allset_tpu_torch.ops import _kernels, cuda_onehot as co, cuda_stream as cst

    if not torch.cuda.is_available():
        print("onehot_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = common.card(dev)
    print(card, flush=True)
    print(f"tree {tree}", flush=True)
    _kernels.build(force=True)
    _kernels.lib()
    has_items = "item_rows" in inspect.signature(co.segsum_onehot_cuda).parameters
    sweep = [int(v) for v in args.sweep.split(",") if v] if has_items else []
    rec = {"tree": tree, "card": card, "onehot": {}, "stream": {}}
    for name, (msgs, dst, bip, nseg, s_blk, nnz, kw) in onehot_cases(common, co, dev, torch,
                                                                      np).items():
        plain = co.segsum_onehot_plain(msgs, dst, bip, nseg, s_blk, 512, **kw)
        offsets = torch.searchsorted(dst[:nnz].contiguous(), torch.arange(
            nseg + 1, device=dev, dtype=dst.dtype)).long()
        lib = lambda: torch.segment_reduce(msgs[:nnz], "sum", offsets=offsets, axis=0)
        r = {"library_ms": common.timed(lib, dev, 10),
             "plain_ms": common.timed(
                 lambda: co.segsum_onehot_plain(msgs, dst, bip, nseg, s_blk, 512, **kw), dev, 2)}
        for ir in [None] + sweep:
            extra = {} if ir is None else {"item_rows": ir}
            fn = lambda: co.segsum_onehot_cuda(msgs, dst, bip, nseg, s_blk, 512, **kw, **extra)
            err = common.scaled_err(fn(), plain)
            if not err <= common.ONEHOT_TOL:
                raise SystemExit(f"{name} item_rows {ir}: {err} from the plain version")
            key = "kernel" if ir is None else f"item_rows={ir}"
            r[key] = {"event_ms": common.timed(fn, dev, 10), "device_ms": device_ms(fn),
                      "scaled_err": err}
            if ir is None:
                r["bits_equal"] = bool(torch.equal(fn(), fn()))
            print(f"  {name} {key}: event {r[key]['event_ms']:.4f} ms, device "
                  f"{r[key]['device_ms']:.4f} ms, err {err:.2e}", flush=True)
        print(f"  {name}: plain {r['plain_ms']:.4f} ms, segment_reduce {r['library_ms']:.4f} ms",
              flush=True)
        rec["onehot"][name] = r
        del plain
        torch.cuda.empty_cache()
    seed = torch.zeros(16, 384, device=dev)
    x = common.normal((co.pad_for_kernel(582248, 512), 384), torch.bfloat16, dev, 0)
    n = x.shape[0] // (512 * cst.FLAT_CHUNKS) * cst.FLAT_CHUNKS
    a = common.normal((512 * 512, 384), torch.bfloat16, dev, 1)
    b = common.normal((512 * 512, 384), torch.bfloat16, dev, 2)
    nd = a.shape[0] // (512 * cst.DUAL_CHUNKS) * cst.DUAL_CHUNKS
    view = lambda t, k: t[: k * 512].view(k, 512, -1)[:, :16].sum(0, dtype=torch.float32)
    for name, fn, lib in (("B5", lambda: cst.stream_flat(x, seed, 512), lambda: view(x, n)),
                          ("B7", lambda: cst.stream_dual(a, b, seed, 512),
                           lambda: view(a, nd) + view(b, nd))):
        r = {"event_ms": common.timed(fn, dev, 20), "device_ms": device_ms(fn),
             "host_us": host_us(fn), "library_ms": common.timed(lib, dev, 20),
             "library_device_ms": device_ms(lib), "library_host_us": host_us(lib)}
        print(f"  {name}: event {r['event_ms']:.4f} ms, device {r['device_ms']:.4f} ms, host "
              f"{r['host_us']:.1f} us; sum over a view {r['library_ms']:.4f} / "
              f"{r['library_device_ms']:.4f} ms, host {r['library_host_us']:.1f} us", flush=True)
        rec["stream"][name] = r
    print("PROBE " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
