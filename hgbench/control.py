"""The comparison's two readings for a cell, at the cell's own size, seed
after seed in one process:

  * the program's: the numbers a run compares (``compare.py``) from the
    check job of ``Trainer.fit`` against the reference, for each seed;
  * the control's: the reference itself in the program's place, computed
    in TF32, the precision just below the configuration's float32 with
    TF32 off (every dense layer's product, forward and backward, takes
    operands rounded to TF32's 10-bit mantissa, to nearest even, and
    accumulates in f32, as the tensor cores do);
  * a fault's: the reference with each loss taken over the first half of
    the training rows only.

    python3 -m hgbench.control --workload NAME --seeds 1 2 3 ... [--faults K]

prints one JSON line per seed (the control and the fault on the first K
seeds) and writes them to ``chiprun_out/control_<workload>.jsonl``.
The limits in ``limits/<workload>.json`` are set from these readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from hgbench import compare, graphs, manifest
from hgbench.reference.follow import follow


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest even."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lsb = (bits >> 13) & 1
    bits = ((bits + 0xFFF + lsb) & 0xFFFFE000) & 0xFFFFFFFF
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32).view(t.shape)


class _TF32Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).transpose(-1, -2), to_tf32(a).transpose(-1, -2) @ g


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _TF32Product.apply(a, b)


def versus(other: dict, ref: dict) -> dict:
    """The numbers of another reading of the reference's (the control's, a
    fault's) in the program's place."""
    return compare.numbers([{k: other[k] for k in ("train_loss", "eval_loss")}],
                           {k: other[k] for k in ("grad", "update")}, ref)


def program_numbers(cell, seed: int, device, steps: int, ref: dict) -> dict:
    from hgbench import program

    job = cell.traffic["job"]
    g = graphs.make_graph(cell.traffic["graph"], seed)
    system = program.prepare_system(cell.config, job, g, seed, steps, device)
    with program.Capture(steps) as cap:
        res = system.check.fit()
    nums = compare.numbers([program.losses(res, steps)], cap.readings(), ref)
    nums["worst"] = compare.worst(cap.readings(), ref)
    del system
    return nums


def main(argv=None) -> int:
    from hgbench.run import CHECK_STEPS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", type=int, default=3, help="seeds that also read the control "
                   "and the fault")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="chiprun_out")
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    job = cell.traffic["job"]
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"control_{args.workload}.jsonl")
    for i, seed in enumerate(args.seeds):
        t0 = time.time()
        g = graphs.make_graph(cell.traffic["graph"], seed)
        ref = follow(cell.config, job, g, seed, CHECK_STEPS, args.device)
        row = {"seed": seed, "program": program_numbers(cell, seed, args.device, CHECK_STEPS,
                                                        ref)}
        if i < args.faults:
            row["control"] = versus(follow(cell.config, job, g, seed, CHECK_STEPS, args.device,
                                           mm=tf32_mm), ref)
            row["half_batch"] = versus(follow(cell.config, job, g, seed, CHECK_STEPS,
                                              args.device, half_batch=True), ref)
        row["seconds"] = time.time() - t0
        line = json.dumps(row)
        print(line, flush=True)
        with open(path, "a") as f:
            f.write(line + "\n")
        if args.device == "cuda":
            torch.cuda.empty_cache()
    for who in ("program", "control", "half_batch"):
        rows = [json.loads(l)[who] for l in open(path) if who in json.loads(l)]
        if rows:
            print(who, {k: [float(np.min([r[k] for r in rows])), float(np.max([r[k] for r in rows]))]
                        for k in compare.NAMES}, file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
