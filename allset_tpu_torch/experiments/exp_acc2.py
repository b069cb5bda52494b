"""B3: the one-hot segment-sum with NACC accumulator sets, on the card.

    python -m allset_tpu_torch.experiments.exp_acc2 [--device cpu]

Port of ``benchmarks/exp_acc2.py``'s main: the bench graph's node-side
reduce (the E->V sum of the self-loop split over its 451,178 real
entries, ``common.node_side``), F 384 bf16, blocks of 256 segments,
chunks of 512 rows; the kernel with 1, 2 and 4 accumulator sets, chunk c
into set c % NACC.
"""

from __future__ import annotations

import sys

import torch

from allset_tpu_torch.experiments import common


def main(argv=None, batch=None) -> dict:
    """``batch``: the bench graph already built on the device (else built)."""
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    batch = common.bench_batch(dev) if batch is None else batch
    s_blk, chunk, f = 256, 512, 384 if dev.type == "cuda" else 128
    ids = common.node_side(batch, split=True)
    m_pad = -(-batch.num_nodes // s_blk) * s_blk
    dst, bip = common.padded_ids(ids, m_pad, s_blk, chunk, m_pad + 7)
    msgs = common.normal((dst.shape[0], f), torch.bfloat16, dev, 0)
    print(f"node side: nnz={ids.shape[0]} segs={batch.num_nodes} s_blk={s_blk} chunk={chunk}",
          flush=True)
    rows = common.onehot_rows(msgs, dst, bip, m_pad, s_blk, chunk,
                              [(f"nacc={n}", {"nacc": n}) for n in (1, 2, 4)], dev, args.iters,
                              ids.shape[0])
    return common.report("B3 exp_acc2", dev, rows)


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
