"""Why the port builds no buckets: the JAX package's bucketed exchange
(``allset_tpu/ops/bucketed.py``) against the port's exchange, on one card,
on the 4x bench graph's exchange passes and training step.

    python3 scripts/bucket_pairs.py [--rows 0,32768,131072] [--rounds 2]
                                    [--nodes 524288] [--edges 262144]

The JAX package cuts every gather table into slices of ``bucket_rows``
rows once a side exceeds them (131,072 by default: the TPU's VMEM
window), and sums one partial a slice. The port has no such route: the
gather inside K1 keeps its table's column slabs in the L2 already. This
script carries the experiment itself. For ``bucket_rows`` > 0 it builds
the JAX bucketing on the host (the entries of each gather-id range,
stably sorted by reduce id) with each bucket's CSR and K1 chunk plan,
and routes the exchange's 'add' over a full table (not under norm
gradients) through one launch of the gather inside K1 a bucket and pass,
the partials added in f32 in bucket order, as the JAX route does;
``bucket_rows`` 0 is the port's own exchange.

The graph is ``bench.py``'s at ``BENCH_4X.json``'s size
(``BENCH_NODES=1<<19 BENCH_EDGES=1<<18``: scale_free_hypergraph with
edge size 12 and 256 features, self-loops, all-one norms); the buckets
are those of the self-loop split's ``real`` incidence, which the step's
exchanges run on. For each ``bucket_rows`` the script measures, in
rounds whose order alternates (A B C, then C B A):

  * the step's four exchange passes (``dir_spmm`` over ``v2e_split`` and
    ``e2v_split``, forward and backward, bf16 at width 264: hidden 256
    and 8 heads' denominators, as the bench step's PMA exchanges): the
    event time of 5 calls back to back after a warm-up, and the device
    time per call (the union of its kernels' intervals in a torch.profiler
    trace of 3 calls, ``allset_tpu_torch/utils/profiling.py``); the
    launches of the gather inside K1 per call; the outputs against those
    of the first ``bucket_rows`` (bf16 partials: 2e-2 of the max |.|);
  * the bench training step (``chip_smoke.bench_model``: SetGNN, hidden
    256, 8 heads, bf16, Adam): the median of 6 steps on the host clock to
    a synchronize, and the device time per step from a trace of 2 steps.

Prints a line per reading, then per ``bucket_rows`` the mean of each
number, and one line ``BUCKETS {json}``; the card's name and power limit
first. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

W = 264
ROUTES = {}  # (num_src, num_dst) of a Direction -> its buckets, while measured


def bucket_sides(gather_ids, red_ids, num_gather: int, num_red: int, bucket_rows: int):
    """The JAX package's bucketing of one pass (``build_bucket_side``
    without the TPU kernel's padding): for each range of ``bucket_rows``
    gather ids, its entries stably sorted by reduce id, their ids local
    to the slice, their canonical positions, CSR and K1 chunk plan."""
    from allset_tpu_torch.graph.incidence import chunk_plan

    sides = []
    for lo in range(0, num_gather, bucket_rows):
        rows = min(bucket_rows, num_gather - lo)
        sel = np.flatnonzero((gather_ids >= lo) & (gather_ids < lo + rows))
        order = np.argsort(red_ids[sel], kind="stable")
        sel = sel[order]
        indptr = np.searchsorted(red_ids[sel], np.arange(num_red + 1)).astype(np.int32)
        sides.append(dict(lo=lo, rows=rows,
                          ids=torch.from_numpy((gather_ids[sel] - lo).astype(np.int32)),
                          canon=torch.from_numpy(sel), indptr=torch.from_numpy(indptr),
                          plan=chunk_plan(indptr), num_red=num_red))
    return sides


def one_pass(table, sides, norm):
    """One launch of the gather inside K1 a bucket on its row slice; the
    partials, each in the table's dtype, added in f32 in bucket order."""
    from allset_tpu_torch.ops.cuda_segment import gather_segment_sum

    out = None
    for s in sides:
        n = None if norm is None else norm.index_select(-1, s["canon"])
        part = gather_segment_sum(table[s["lo"]: s["lo"] + s["rows"]], s["ids"], s["indptr"],
                                  s["num_red"], s["plan"], n)
        if len(sides) == 1:
            return part
        out = part.float() if out is None else out + part.float()
    return out.to(table.dtype)


class Bucketed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, norm, fwd, bwd):
        ctx.bwd, ctx.dtype = bwd, w.dtype
        ctx.save_for_backward(norm)
        return one_pass(w, fwd, norm)

    @staticmethod
    def backward(ctx, g):
        (norm,) = ctx.saved_tensors
        return one_pass(g.to(ctx.dtype).contiguous(), ctx.bwd, norm), None, None, None


def bucketed_routes(inc, bucket_rows: int, dev) -> dict:
    """The buckets of both directions of ``inc`` (empty at 0): V->E
    gathers by node and reduces by edge, its backward the transpose; E->V
    the other way round, its norm put back in canonical order."""
    if bucket_rows <= 0:
        return {}
    node = inc.node[: inc.nnz].cpu().numpy().astype(np.int64)
    edge = inc.edge[: inc.nnz].cpu().numpy().astype(np.int64)

    def placed(*args):
        return [{k: v.to(dev) if hasattr(v, "to") else v for k, v in s.items()}
                for s in bucket_sides(*args, bucket_rows)]

    by_node = placed(node, edge, inc.num_nodes, inc.num_edges)
    by_edge = placed(edge, node, inc.num_edges, inc.num_nodes)
    if inc.num_nodes == inc.num_edges:
        raise ValueError("the routes are keyed by table sizes, which must differ")
    return {(inc.num_nodes, inc.num_edges): (by_node, by_edge, None),
            (inc.num_edges, inc.num_nodes): (by_edge, by_node, inc.inv_node_perm)}


def route_exchange():
    """Route ``ops/exchange.py::_core`` through ``ROUTES`` as the JAX
    package routes: 'add' over a full source table, not under norm
    gradients; everything else takes the port's exchange."""
    from allset_tpu_torch.ops import exchange

    port_core = exchange._core

    def core(w, d, norm, reduce, norm_grad):
        route = ROUTES.get((d.num_src, d.num_dst)) if reduce == "add" else None
        if route is None or w.shape[0] != d.num_src or (norm is not None and norm_grad):
            return port_core(w, d, norm, reduce, norm_grad)
        fwd, bwd, canon = route
        if norm is not None and canon is not None:
            norm = norm.index_select(-1, canon)
        return Bucketed.apply(w, None if norm is None else norm.detach(), fwd, bwd)

    exchange._core = core


def event_ms(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def busy_ms(fn, calls: int) -> float:
    """Device time per call: the busy time of a trace of ``calls`` calls."""
    from allset_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d, "cuda"):
            for _ in range(calls):
                fn()
        return profiling.trace_summary(profiling.latest_trace(d))["busy_ms"] / calls


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", default="0,32768,131072")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--nodes", type=int, default=1 << 19)
    p.add_argument("--edges", type=int, default=1 << 18)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bucket_pairs: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from allset_tpu_torch.data import scale_free_hypergraph
    from allset_tpu_torch.graph import Batch, add_self_loops, norm_construction
    from allset_tpu_torch.ops import _kernels
    from allset_tpu_torch.ops.exchange import dir_spmm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    raw = scale_free_hypergraph(num_nodes=args.nodes, num_hyperedges=args.edges,
                                avg_edge_size=12, feature_dim=256, seed=0)
    hd = norm_construction(add_self_loops(raw), "all_one")
    print(f"graph: {args.nodes} nodes, {args.edges} hyperedges, nnz {hd.nnz} with self-loops "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    configs = {}
    for rows in (int(r) for r in args.rows.split(",")):
        t0 = time.perf_counter()
        batch = Batch.from_hyperdata(hd, device=dev, bucket=1024)
        real = batch.inc.real
        routes = bucketed_routes(real, rows, dev)
        host_s = time.perf_counter() - t0
        nb = ((0, 0) if not routes else
              tuple(len(routes[k][0]) for k in ((real.num_nodes, real.num_edges),
                                                (real.num_edges, real.num_nodes))))
        print(f"bucket_rows {rows}: built in {host_s:.1f} s; the real incidence's buckets "
              f"{nb[0]} by node, {nb[1]} by edge", flush=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        d1, d2 = batch.inc.v2e_split(), batch.inc.e2v_split()
        xn = torch.randn(batch.num_nodes, W, generator=gen, device=dev).bfloat16()
        xe = torch.randn(real.num_edges + batch.num_nodes, W, generator=gen,
                         device=dev).bfloat16()
        g1 = torch.randn(real.num_edges + batch.num_nodes, W, generator=gen,
                         device=dev).bfloat16()
        g2 = torch.randn(batch.num_nodes, W, generator=gen, device=dev).bfloat16()
        xn.requires_grad_()
        xe.requires_grad_()

        def passes(xn=xn, xe=xe, g1=g1, g2=g2, d1=d1, d2=d2):
            y1, y2 = dir_spmm(xn, d1), dir_spmm(xe, d2)
            return (y1.detach(), y2.detach(),
                    *torch.autograd.grad([y1, y2], [xn, xe], [g1, g2]))

        configs[rows] = dict(batch=batch, passes=passes, host_s=host_s, buckets=nb,
                             routes=routes)
    route_exchange()
    ref = None
    for rows, c in configs.items():
        ROUTES.clear()
        ROUTES.update(c["routes"])
        _kernels.reset_launches()
        out = c["passes"]()
        torch.cuda.synchronize()
        c["launches"] = _kernels.launches["segment_sum_gather"]
        if ref is None:
            ref = out
        err = max((a.float() - b.float()).abs().max().item()
                  / max(b.float().abs().max().item(), 1.0) for a, b in zip(out, ref))
        c["err"] = err
        print(f"bucket_rows {rows}: {c['launches']} launches of the gather inside K1 over the "
              f"four passes; outputs and gradients within {err:.2e} of bucket_rows "
              f"{next(iter(configs))}", flush=True)
        if err > 2e-2:
            raise AssertionError(f"bucket_rows {rows}: the passes disagree ({err})")
        del out
    mask = None
    readings = {rows: [] for rows in configs}
    order = list(configs)
    for r in range(args.rounds):
        for rows in (order if r % 2 == 0 else order[::-1]):
            c = configs[rows]
            batch = c["batch"]
            ROUTES.clear()
            ROUTES.update(c["routes"])
            if mask is None:
                mask = torch.arange(batch.num_nodes, device=dev) % 2 == 0
            ev, busy = event_ms(c["passes"], 5), busy_ms(c["passes"], 3)
            model = chip_smoke.bench_model(0, batch.inc.nnz_padded, 256).to(dev)
            chip_smoke.run_steps(model, batch, mask, 1)  # warm-up
            losses, times = chip_smoke.run_steps(model, batch, mask, 6)
            step_busy = busy_ms(lambda: chip_smoke.run_steps(model, batch, mask, 1), 2)
            rec = {"passes_ms": ev, "passes_device_ms": busy,
                   "step_ms": statistics.median(times) * 1e3, "step_device_ms": step_busy,
                   "loss": float(losses[-1])}
            readings[rows].append(rec)
            print(f"  round {r} bucket_rows {rows}: four passes {ev:.3f} ms (device {busy:.3f}); "
                  f"step {rec['step_ms']:.3f} ms (device {step_busy:.3f}); last loss "
                  f"{rec['loss']:.6f} [{card}]", flush=True)
            del model
            torch.cuda.empty_cache()
    summary = {}
    for rows, recs in readings.items():
        mean = {k: statistics.mean(r[k] for r in recs) for k in recs[0]}
        summary[rows] = {**mean, "host_s": configs[rows]["host_s"],
                         "buckets": configs[rows]["buckets"],
                         "launches": configs[rows]["launches"], "err": configs[rows]["err"],
                         "readings": recs}
        print(f"bucket_rows {rows}: mean four passes {mean['passes_ms']:.3f} ms (device "
              f"{mean['passes_device_ms']:.3f}), step {mean['step_ms']:.3f} ms (device "
              f"{mean['step_device_ms']:.3f}) over {len(recs)} rounds [{card}]", flush=True)
    print("BUCKETS " + json.dumps({"card": card, "nodes": args.nodes, "edges": args.edges,
                                   "nnz": hd.nnz, "rows": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
