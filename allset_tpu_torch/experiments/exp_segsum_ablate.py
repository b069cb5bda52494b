"""B6, B5, B7: the segment-sum ablations and the streaming probes, on the card.

    python -m allset_tpu_torch.experiments.exp_segsum_ablate [--device cpu]

Port of ``benchmarks/exp_segsum_ablate.py``: the bench graph's node side
(every entry's node id, self-loops included, ``common.node_side``), F
384 bf16, blocks of 256 segments, chunks of 512 rows. B6's modes through
``ops/cuda_onehot.py``: full, noonehot, nomatmul, dmaonly, depth4, nodst,
nodst4. Then ``flat`` (B5, ``ABLATE_ONLY=flat`` there): the same msgs
as whole blocks of 8 chunks of 512 rows streamed by cp.async into a
double buffer (``ops/cuda_stream.py``), and ``dual`` (B7,
``ABLATE_ONLY=dual``): two [262,144, 384] bf16 arrays streamed together,
blocks of 4 chunks.
"""

from __future__ import annotations

import sys

import torch

from allset_tpu_torch.experiments import common
from allset_tpu_torch.ops import cuda_onehot as co, cuda_stream as cst

def _first16_view(x, n, chunk):
    return lambda: x[: n * chunk].view(n, chunk, -1)[:, :16].sum(0, dtype=torch.float32)


def main(argv=None, batch=None) -> dict:
    """``batch``: the bench graph already built on the device (else built)."""
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    batch = common.bench_batch(dev) if batch is None else batch
    s_blk, chunk, f = 256, 512, 384 if dev.type == "cuda" else 128
    ids = common.node_side(batch, split=False)
    m_pad = -(-batch.num_nodes // s_blk) * s_blk
    dst, bip = common.padded_ids(ids, m_pad, s_blk, chunk, m_pad + 7)
    msgs = common.normal((dst.shape[0], f), torch.bfloat16, dev, 0)
    print(f"node-side nnz={ids.shape[0]} segs={batch.num_nodes} F={f} s_blk={s_blk} "
          f"chunk={chunk}", flush=True)
    rows = common.onehot_rows(msgs, dst, bip, m_pad, s_blk, chunk,
                              [(m, {"mode": m}) for m in co.MODES], dev, args.iters,
                              ids.shape[0])
    seed = torch.zeros(16, f, device=dev)
    c = chunk
    n = msgs.shape[0] // (c * cst.FLAT_CHUNKS) * cst.FLAT_CHUNKS  # B5
    rows.append(common.stream_row(
        f"flat (B5) chunk={c}", "stream_flat", lambda: cst.stream_flat(msgs, seed, c),
        lambda: cst.stream_flat_plain(msgs, seed, c), _first16_view(msgs, n, c),
        n * 16 * f * 2 + 2 * 16 * f * 4, n * c * f * 2, dev, args.iters))
    r = 512 * c if dev.type == "cuda" else 16 * c  # B7
    a = common.normal((r, f), torch.bfloat16, dev, 1)
    b = common.normal((r, f), torch.bfloat16, dev, 2)
    n = r // (c * cst.DUAL_CHUNKS) * cst.DUAL_CHUNKS
    fa, fb = _first16_view(a, n, c), _first16_view(b, n, c)
    rows.append(common.stream_row(
        f"dual (B7) chunk={c}", "stream_dual", lambda: cst.stream_dual(a, b, seed, c),
        lambda: cst.stream_dual_plain(a, b, seed, c), lambda: fa() + fb(),
        2 * n * 16 * f * 2 + 2 * 16 * f * 4, 2 * n * c * f * 2, dev, args.iters))
    return common.report("B6/B5/B7 exp_segsum_ablate", dev, rows)


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
