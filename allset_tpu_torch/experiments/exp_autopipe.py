"""B8: streaming through a warp-specialised TMA ring, on the card.

    python -m allset_tpu_torch.experiments.exp_autopipe [--device cpu] [--body fold|first16]

Port of ``benchmarks/exp_autopipe.py``'s main: x [524,288, 384] bf16,
chunks of 512, 1,024 and 2,048 rows, each folded 16 rows at a time into a
[16, 384] f32 accumulator (``--body fold``; ``first16``: each chunk's
first 16 rows, the script's other ``AUTOPIPE_BODY``, which reads only
those rows). The card's counterpart of Mosaic's automatic pipeline is the
fold's TMA ring (``ops/cuda_stream.py``); per chunk size the kernel's
event and device times, its bound, its share of it, and the library
call's (a sum over a view) event and device times.
"""

from __future__ import annotations

import sys

import torch

from allset_tpu_torch.experiments import common
from allset_tpu_torch.ops import cuda_stream as cst


def main(argv=None) -> dict:
    p = common.parser(__doc__)
    p.add_argument("--body", default="fold", choices=cst.BODIES)
    args = p.parse_args(argv)
    dev = common.device(args.device)
    f, rows_n = (384, 512 * 1024) if dev.type == "cuda" else (128, 8 * 2048)
    x = common.normal((rows_n, f), torch.bfloat16, dev, 0)
    seed = torch.zeros(16, f, device=dev)
    rows = []
    for chunk in (512, 1024, 2048):
        n = rows_n // chunk
        if args.body == "fold":
            lib = lambda: x[: n * chunk].view(-1, 16, f).sum(0, dtype=torch.float32)
            need = n * chunk * f * 2
        else:
            lib = lambda: x[: n * chunk].view(n, chunk, f)[:, :16].sum(0, dtype=torch.float32)
            need = n * 16 * f * 2
        rows.append(common.stream_row(
            f"{args.body} chunk={chunk}", "stream_fold",
            lambda: cst.stream_fold(x, seed, chunk, args.body),
            lambda: cst.stream_fold_plain(x, seed, chunk, args.body), lib,
            need + 2 * 16 * f * 4, need, dev, args.iters))
    return common.report(f"B8 exp_autopipe ({args.body})", dev, rows)


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
