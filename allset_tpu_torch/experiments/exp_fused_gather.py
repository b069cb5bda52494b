"""B11, B10, B9: the row gathers, and the gather inside K1 against the pair it replaces.

    python -m allset_tpu_torch.experiments.exp_fused_gather [--device cpu]

Port of ``benchmarks/exp_fused_gather.py``'s main: a [131,072, 384] bf16
table and 524,288 random ids; index_select (the script's XLA take), B10
(``cuda_gather.gather_fwd``), B9 (``cuda_gather.gather_sorted_fwd``) and
the gather inside K1 on the identity CSR (``indptr = arange(n + 1)``: each
segment one entry, so it computes B11's ``take(table, ids)``), each held
bit for bit to index_select, as the script checks ``ok``.

Then the measurement that chose ``ops/exchange.py::_Spmm``'s route: its
passes, the gather inside K1 against the pair it replaces (B10's gather,
then K1), at the bench step's four (one V->E and one E->V exchange of
the self-loop split, forward and backward, bf16, width 264, the bench
graph) and at a 20-run epoch's six (f32, width 20 x 264, the
synthetic-walmart preset; the forward runs twice, train and eval). Each
of 2 pairs reads fused, pair, pair, fused, each reading the sum over the
passes of CUDA-event means; the two sides are held bit for bit to each
other at every pass. The fused route holds while its mean is no higher
than the pair's in both cases.
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from allset_tpu_torch.experiments import common
from allset_tpu_torch.graph.incidence import chunk_plan
from allset_tpu_torch.ops import cuda_gather as cg, cuda_segment as cs


def spmm_passes(batch, width, dtype, fwd_times, seed=0):
    """_Spmm's passes over one V->E and one E->V exchange of the self-loop
    split, forward (counted ``fwd_times``) and backward: (table, ids,
    indptr, segments, plan, times) with random tables at ``width``."""
    gen = torch.Generator().manual_seed(seed)
    dev = batch.inc.node.device
    out = []
    for d in (batch.inc.v2e_split(), batch.inc.e2v_split()):
        k = d.nnz
        for rows, ids, ip, nseg, plan, n in (
                (d.num_src, d.src[:k], d.indptr, d.num_dst, d.plan, fwd_times),
                (d.num_dst, d.dst_srcsort[:k], d.src_indptr, d.num_src, d.src_plan, 1)):
            table = torch.randn(rows, width, generator=gen).to(dtype).to(dev)
            out.append((table, ids, ip, nseg, plan, n))
    return out


def fused(p):
    return cs.gather_segment_sum(p[0], p[1], p[2], p[3], p[4])


def pair(p):
    return cs.segment_sum(cg.gather_fwd(p[0], p[1]), p[2], p[3], p[4])


def pass_bytes(p, fused_side: bool) -> int:
    """Bytes each input read once and each output written once: the fused
    kernel reads the table, the ids and indptr and writes the segments;
    the pair also writes and reads back the [k, W] gathered rows."""
    table, ids, ip, nseg, _, _ = p
    item, w, k = table.element_size(), table.shape[1], ids.shape[0]
    base = (table.shape[0] + nseg) * w * item + k * ids.element_size() + 4 * (nseg + 1)
    return base if fused_side else base + 2 * k * w * item


def spmm_pairs(passes, dev, iters, pairs=2):
    """(fused readings, pair readings) in ms, each the sum over the passes;
    each pass held bit for bit between the two sides first."""
    for p in passes:
        if not torch.equal(fused(p), pair(p)):
            raise AssertionError(f"fused and pair differ at [{p[1].shape[0]}, {p[0].shape[1]}]")

    def total(fn):
        return sum(p[5] * common.timed(lambda: fn(p), dev, iters) for p in passes)

    f_ms, p_ms = [], []
    for _ in range(pairs):
        f_ms.append(total(fused))
        p_ms.append(total(pair))
        p_ms.append(total(pair))
        f_ms.append(total(fused))
    return f_ms, p_ms


def gather_probes(dev, iters):
    """index_select, B10, B9 and the gather inside K1 on the identity CSR
    at the script's shapes, each bit for bit against index_select."""
    n_rows, nnz, f = (1 << 17, 524288, 384) if dev.type == "cuda" else (1000, 4096, 64)
    table = common.normal((n_rows, f), torch.bfloat16, dev, 0)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, n_rows, nnz)
                           .astype(np.int32)).to(dev)
    indptr = torch.arange(nnz + 1, dtype=torch.int32)
    plan = chunk_plan(indptr.numpy()).to(dev)
    indptr = indptr.to(dev)
    want = table.index_select(0, ids)
    cases = (("index_select (XLA take)", lambda: table.index_select(0, ids)),
             ("B10 gather", lambda: cg.gather_fwd(table, ids)),
             ("B9 gather_sorted", lambda: cg.gather_sorted_fwd(table, ids)),
             ("B11 gather inside K1, identity CSR",
              lambda: cs.gather_segment_sum(table, ids, indptr, nnz, plan)))
    rows = []
    for label, fn in cases:
        ok = torch.equal(fn(), want)
        if not ok:
            raise AssertionError(f"{label} differs from index_select")
        ms = common.timed(fn, dev, iters)
        b, by = common.bound_ms((n_rows + nnz) * f * 2 + nnz * 4 + 4 * (nnz + 1))
        rows.append({"label": label, "ms": ms, "ns_per_row": ms / nnz * 1e6, "ok": ok,
                     "bound_ms": b, "bound_by": by})
    rows[-1]["plain_ms"] = common.timed(
        lambda: cs.gather_segment_sum_plain(table, ids, indptr, nnz), dev, 2)
    return rows


def main(argv=None, bench=None, walmart=None) -> dict:
    """``bench``, ``walmart``: the graphs already built on the device."""
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    rows = gather_probes(dev, args.iters)
    route = "fused"
    for case in ("step", "epoch"):
        if case == "step":
            batch = common.bench_batch(dev) if bench is None else bench
            passes = spmm_passes(batch, 264, torch.bfloat16, 1)
        else:
            batch = common.walmart_batch(dev) if walmart is None else walmart
            passes = spmm_passes(batch, 20 * 264, torch.float32, 2)
        f_ms, p_ms = spmm_pairs(passes, dev, args.iters)
        fb = common.bound_ms(sum(p[5] * pass_bytes(p, True) for p in passes))[0]
        pb = common.bound_ms(sum(p[5] * pass_bytes(p, False) for p in passes))[0]
        if statistics.mean(f_ms) > statistics.mean(p_ms):
            route = "pair"
        what = "bench step" if case == "step" else "20-run epoch"
        rows.append({"label": f"_Spmm's {sum(p[5] for p in passes)} passes per {what}",
                     "fused_ms": statistics.mean(f_ms), "fused_lo": min(f_ms),
                     "fused_hi": max(f_ms), "pair_ms": statistics.mean(p_ms),
                     "pair_lo": min(p_ms), "pair_hi": max(p_ms), "fused_bound_ms": fb,
                     "pair_bound_ms": pb})
        del passes
    print(f"route: {route} ({'the gather inside K1 no slower than the pair in every case' if route == 'fused' else 'the pair faster in a case'})", flush=True)
    return common.report("B11/B10/B9 exp_fused_gather", dev, rows, route=route)


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
