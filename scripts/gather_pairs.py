"""Time B10 (the row gather) against index_select over the exchange's gathers.

    python3 scripts/gather_pairs.py

The pairs that decide which gather ``ops/exchange.py::_Spmm`` runs: over
one V->E and one E->V exchange, forward and backward, the main path's row
gathers, at the bench step's shapes (bf16, width 264, the bench graph of
``chip_smoke.bench_batch``) and at a 20-run epoch's (f32, width 20 x 264,
the synthetic-walmart preset; the forward gathers twice, train and eval,
the backward once). Each of 2 pairs reads B10, index_select,
index_select, B10, each reading the sum over the gathers of CUDA-event
times (10 calls each). Prints, per case, each side's mean, lowest and highest reading,
the bytes bound, and the card's name and power limit. B10 keeps the
exchange's gathers while its mean is no higher than index_select's in
both cases. Needs one CUDA card; imports ``chip_smoke.py`` for its
helpers (the package never imports either).
"""

from __future__ import annotations

import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spmm_gathers(batch, F):
    """_Spmm's row gathers over one V->E and one E->V exchange (the
    self-loop split), forward and backward: (table rows, ids) at width F."""
    inc = batch.inc
    out = []
    for d in (inc.v2e_split(), inc.e2v_split()):
        k = d.nnz
        out += [(d.num_src, d.src[:k]), (d.num_dst, d.dst_srcsort[:k])]
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from allset_tpu_torch.ops import _kernels, cuda_gather as cg

    if not torch.cuda.is_available():
        print("gather_pairs: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    _kernels.lib()  # built from csrc/ unless the library is newer than every source
    passes = True
    for name, make, F, dtype, fwd_times in (
            ("bench step", cs.bench_batch, 264, torch.bfloat16, 1),
            ("20-run epoch", cs.walmart_batch, 20 * 264, torch.float32, 2)):
        batch = make(dev)
        work = []
        for j, (rows, ids) in enumerate(spmm_gathers(batch, F)):
            table = torch.randn(rows, F, device=dev).to(dtype)
            work.append((table, ids, fwd_times if j % 2 == 0 else 1))
        bound = sum(n * cs.gather_cost(t.shape[0], i.shape[0], F, t.element_size(),
                                       i.element_size())[0] for t, i, n in work) / cs.HBM * 1e3

        def total(fn):
            return sum(n * cs.cuda_ms(lambda: fn(t, i), iters=10) for t, i, n in work)

        k_ms, s_ms = [], []
        for _ in range(2):
            k_ms.append(total(cg.gather_fwd_cuda))
            s_ms.append(total(lambda t, i: t.index_select(0, i)))
            s_ms.append(total(lambda t, i: t.index_select(0, i)))
            k_ms.append(total(cg.gather_fwd_cuda))
        passes &= statistics.mean(k_ms) <= statistics.mean(s_ms)
        print(f"_Spmm's gathers per {name}: B10 {statistics.mean(k_ms):.4f} ms "
              f"[{min(k_ms):.4f}, {max(k_ms):.4f}], index_select {statistics.mean(s_ms):.4f} ms "
              f"[{min(s_ms):.4f}, {max(s_ms):.4f}]; bound {bound:.4f} ms (bytes) [{card}]",
              flush=True)
        del batch, work
        torch.cuda.empty_cache()
    print("guard: " + ("B10 no slower than index_select in both cases" if passes
                       else "B10 slower than index_select in a case"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
