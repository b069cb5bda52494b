"""B1: the one-hot tensor-core sorted segment-sum prototype on the card.

    python -m allset_tpu_torch.experiments.pallas_segsum_proto [--device cpu]

Port of ``benchmarks/pallas_segsum_proto.py``'s main: 524,288 sorted
random entries (1,024 rows of padding, id 32,768) over 32,768 segments, F
256 f32, blocks of 64 segments, chunks of 512 rows; the kernel
(``ops/cuda_onehot.py``, build A, 2 stages) against its plain version
and torch.segment_reduce (the counterpart of the script's XLA scatter).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from allset_tpu_torch.experiments import common


def main(argv=None) -> dict:
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    nnz, m, f = (1 << 19, 1 << 15, 256) if dev.type == "cuda" else (4096, 512, 64)
    s_blk, chunk, pad = 64, 512, 1024
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, m, nnz)).astype(np.int32)
    dst = torch.from_numpy(np.concatenate([ids, np.full(pad, m, np.int32)])).to(dev)
    msgs = rng.normal(size=(nnz + pad, f)).astype(np.float32)
    msgs[nnz:] = 0
    msgs = torch.from_numpy(msgs).to(dev)
    bip = torch.from_numpy(np.searchsorted(dst.cpu().numpy(), np.arange(0, m + s_blk, s_blk))
                           .astype(np.int32)).to(dev)
    rows = common.onehot_rows(msgs, dst, bip, m, s_blk, chunk,
                              [(f"B1 s_blk={s_blk} chunk={chunk}", {})], dev, args.iters, nnz)
    return common.report("B1 pallas_segsum_proto", dev, rows)


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
