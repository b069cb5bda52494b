"""Time B9 (the sorted gather) against B10 and index_select by row width.

    python3 scripts/gather_sorted_sweep.py

The measurement behind ``ops/cuda_gather.py::NARROW_BYTES``, the widest
row that a gather by sorted ids sends to B9: on the bench graph's V2V
clique expansion (``chip_smoke.bench_raw`` through CEGAT's factory, the
self-loops included; 279,962 entries sorted by destination, padded as the
Incidence pads), each kernel gathers a [131,072, W] table by the sorted
destination ids at row widths of 4 B to 1 KiB, f32 and bf16. Per width:
B9, B10 and index_select (on the clamped ids) in CUDA-event time around
eager calls, in alternating order (B9, B10, B10, B9), which at these
sizes is the wrappers' launch rate; the device time of B9 and B10 alone,
from a CUDA graph of 50 launches replayed; the bytes bound (distinct rows
read, rows written, ids; 3.35 TB/s) and B9's result against its plain
version, bit for bit. Prints the card's name and power limit. Needs one CUDA card;
imports ``chip_smoke.py`` for its helpers (the package never imports
either).
"""

from __future__ import annotations

import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as cs
    from allset_tpu_torch.ops import _kernels, cuda_gather as cg
    from allset_tpu_torch.train.factory import v2v_incidence

    if not torch.cuda.is_available():
        print("gather_sorted_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    _kernels.lib()
    inc = v2v_incidence(cs.bench_raw(), "CEGAT", bucket=1024)
    rows = inc.num_nodes
    v2v = inc.edge.to(dev)
    # the same number of sorted ids in runs of 16 (a graph whose destinations
    # have 16 entries each): where staging a row once per run pays
    runs16 = torch.arange(rows, device=dev).repeat_interleave(16)[: v2v.shape[0]]
    for what, ids in (("V2V destinations", v2v), ("runs of 16", runs16)):
        distinct = int(torch.unique(ids.clamp(0, rows - 1)).numel())
        print(f"{what}: {ids.shape[0]} ids (V2V entries {inc.nnz}), {rows} rows, {distinct} "
              f"distinct ids", flush=True)
        sweep(cs, cg, card, dev, ids, rows, distinct)
    return 0


def sweep(cs, cg, card, dev, ids, rows, distinct):
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        item = torch.tensor([], dtype=dtype).element_size()
        for nbytes in (4, 8, 16, 32, 64, 128, 256, 512, 1024):
            if nbytes < item:
                continue
            W = nbytes // item
            table = torch.randn(rows, W, device=dev).to(dtype)
            got = cg.gather_sorted_fwd_cuda(table, ids)
            cs.require(torch.equal(got, cg.gather_sorted_fwd_plain(table, ids)),
                       f"B9 differs at {nbytes} B {dtype}")
            clamped = ids.clamp(0, rows - 1)
            b9, b10 = [], []
            for _ in range(2):
                b9.append(cs.cuda_ms(lambda: cg.gather_sorted_fwd_cuda(table, ids), iters=50))
                b10.append(cs.cuda_ms(lambda: cg.gather_fwd_cuda(table, ids), iters=50))
                b10.append(cs.cuda_ms(lambda: cg.gather_fwd_cuda(table, ids), iters=50))
                b9.append(cs.cuda_ms(lambda: cg.gather_sorted_fwd_cuda(table, ids), iters=50))
            lib = cs.cuda_ms(lambda: table.index_select(0, clamped), iters=50)
            dev9 = cs.graph_ms(lambda: cg.gather_sorted_fwd_cuda(table, ids), 50)
            dev10 = cs.graph_ms(lambda: cg.gather_fwd_cuda(table, ids), 50)
            bound = ((distinct + ids.shape[0]) * nbytes + ids.shape[0] * 8) / cs.HBM * 1e3
            print(f"  {str(dtype)[6:]:8s} row {nbytes:5d} B: B9 {statistics.mean(b9):.4f} ms "
                  f"[{min(b9):.4f}, {max(b9):.4f}], B10 {statistics.mean(b10):.4f} ms "
                  f"[{min(b10):.4f}, {max(b10):.4f}], index_select {lib:.4f} ms; device time B9 "
                  f"{dev9:.4f} ms, B10 {dev10:.4f} ms; bound {bound:.4f} ms; B9 bit-equal "
                  f"[{card}]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
