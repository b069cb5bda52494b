"""B2: the one-hot segment-sum with NBUF-deep buffers, on the card.

    python -m allset_tpu_torch.experiments.exp_nbuf [--device cpu]

Port of ``benchmarks/exp_nbuf.py``'s main: 452,608 sorted random ids over
131,072 segments (the bench's node-side shape), F 384 bf16, blocks of
256 segments, chunks of 512 rows, padded ids past the last segment; the
kernel (``ops/cuda_onehot.py``) with a cp.async ring of 2, 3, 4 and 6
stages.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from allset_tpu_torch.experiments import common


def main(argv=None) -> dict:
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    nnz, m, f = (452608, 131072, 384) if dev.type == "cuda" else (8192, 2048, 128)
    s_blk, chunk = 256, 512
    m_pad = -(-m // s_blk) * s_blk
    ids = torch.from_numpy(np.sort(np.random.default_rng(0).integers(0, m, nnz))
                           .astype(np.int32)).to(dev)
    dst, bip = common.padded_ids(ids, m_pad, s_blk, chunk, m_pad + 7)
    msgs = common.normal((dst.shape[0], f), torch.bfloat16, dev, 0)
    rows = common.onehot_rows(msgs, dst, bip, m_pad, s_blk, chunk,
                              [(f"nbuf={n}", {"nbuf": n}) for n in (2, 3, 4, 6)], dev,
                              args.iters, nnz)
    return common.report("B2 exp_nbuf", dev, rows)


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
