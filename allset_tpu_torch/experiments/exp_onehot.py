"""B4: the one-hot segment-sum's three one-hot builds, on the card.

    python -m allset_tpu_torch.experiments.exp_onehot [--device cpu]

Port of ``benchmarks/exp_onehot.py``'s main: the shapes of B2 (452,608
sorted random ids over 131,072 segments, F 384 bf16, blocks of 256
segments, chunks of 512 rows). Builds: A, each stage's whole one-hot in
shared memory; B, one 16-entry k-slice at a time; C, the mma fragments
in registers straight from the ids (``csrc/segsum_onehot.cu``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from allset_tpu_torch.experiments import common
from allset_tpu_torch.ops import cuda_onehot as co


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
                              [(f"build {v}", {"build": v}) for v in co.BUILDS], dev,
                              args.iters, nnz)
    return common.report("B4 exp_onehot", dev, rows)


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
