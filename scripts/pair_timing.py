"""Time two trees of this repository on one card, in alternating pairs.

    python3 scripts/pair_timing.py OTHER_TREE [--pairs N]

OTHER_TREE is another checkout of the repository (for example an earlier
commit unpacked with ``git archive`` into an ignored directory). For each
pair the script runs one worker process in OTHER_TREE, two in this tree
and one more in OTHER_TREE, so that drift on the card falls on both
sides. A worker imports its own tree's package and ``chip_smoke.py``
(this script is a developer tool beside the smoke script; the package
never imports either), builds its own kernels and measures, on the card:

  * the bench step (bf16, the bench graph of ``chip_smoke.bench_batch``):
    the median of 8 training steps (``chip_smoke.main_path``, with its
    launch and repeatability checks), and per step at the main path's
    shapes (CUDA events): the gather inside K1 over _Spmm's 4 passes, K4
    through its wrapper (``gmax_cuda``) and the pack's forward (K4 and K5,
    ``pack_fwd``) over the 2 packs;
  * the runs protocol (f32, synthetic-walmart preset, 20 runs folded):
    the same per epoch (the gather inside K1 over 6 passes, K4 and the
    pack's forward over 4 packs), and a warm epoch through the CLI (one
    epoch to warm up, then 6 timed).

Each worker prints one JSON line; the script prints them and, per tree,
the mean, lowest and highest reading of each number, with the card's name
and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

WALMART = "synthetic-walmart"


def _kernel_ms(cs, batch, W, dtype, fwd, R, dev):
    """(the gather inside K1, K4, the pack's forward) in ms summed over
    _Spmm's passes and the packs of a step (fwd 1, R None) or an epoch
    (fwd 2: train and eval forwards, R runs)."""
    import torch

    from allset_tpu_torch.experiments.exp_fused_gather import spmm_passes
    from allset_tpu_torch.ops import cuda_pack as ck, cuda_segment as cseg

    gather = 0.0
    for table, ids, ip, nseg, plan, n in spmm_passes(batch, W, dtype, fwd):
        gather += n * cs.cuda_ms(lambda: cseg.gather_segment_sum_cuda(table, ids, ip, nseg, plan))
    del table, ids
    k4 = pack = 0.0
    gen = torch.Generator().manual_seed(0)
    for rows in (batch.num_nodes, batch.inc.real.num_edges + batch.num_nodes):
        yf, bV, ba = cs.pack_inputs(rows, 256, 8, dtype, dev, gen, R=R)
        k4 += fwd * cs.cuda_ms(lambda: ck.gmax_cuda(yf, ba, 8, 256), iters=50)
        pack += fwd * cs.cuda_ms(lambda: ck.pack_fwd(yf, bV, ba, 8), iters=20)
        del yf
    torch.cuda.empty_cache()
    return gather, k4, pack


def worker() -> None:
    """Measure the tree in the working directory (see the module note)."""
    tree = os.getcwd()
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from allset_tpu_torch import cli
    from allset_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    _kernels.build(force=True)
    _kernels.lib()
    out = {"tree": tree}
    batch = cs.bench_batch(dev)
    _, out["bench_step_ms"] = cs.main_path(batch, dev, cs.card_line())
    (out["gather_ms_per_step"], out["k4_ms_per_step"],
     out["pack_fwd_ms_per_step"]) = _kernel_ms(cs, batch, 264, torch.bfloat16, 1, None, dev)
    del batch
    torch.cuda.empty_cache()
    wb = cs.walmart_batch(dev)
    (out["gather_ms_per_epoch"], out["k4_ms_per_epoch"],
     out["pack_fwd_ms_per_epoch"]) = _kernel_ms(cs, wb, 20 * 264, torch.float32, 2, 20, dev)
    del wb
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--dname", WALMART, "--preset", "--dtype", "float32", "--device", "cuda",
                "--res_root", tmp]
        cli.run(base + ["--epochs", "1"])
        res = cli.run(base + ["--epochs", "6"])
    out["epoch_ms"] = res.wall_time / 6 * 1e3
    out["final_loss"] = float(res.metrics[:, -1, 3].mean())
    print("PAIR " + json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another checkout of the repository")
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(args.other)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    script = os.path.abspath(__file__)
    rows = []
    for _ in range(args.pairs):
        for tree in (other, here, here, other):
            r = subprocess.run([sys.executable, script, "--worker"], cwd=tree,
                               capture_output=True, text=True)
            lines = [x for x in r.stdout.splitlines() if x.startswith("PAIR ")]
            if r.returncode != 0 or not lines:
                print(r.stdout[-3000:], r.stderr[-3000:], sep="\n")
                raise SystemExit(f"worker in {tree} failed ({r.returncode})")
            rows.append(json.loads(lines[-1][5:]))
            print(lines[-1], flush=True)
    keys = [k for k in rows[0] if k != "tree"]
    for tree in (other, here):
        mine = [r for r in rows if r["tree"] == tree]
        means = {k: [sum(r[k] for r in mine) / len(mine), min(r[k] for r in mine),
                     max(r[k] for r in mine)] for k in keys}
        print(f"MEAN {tree} ({len(mine)} workers; mean, lowest, highest) [{card}]: "
              + json.dumps(means), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        sys.path.pop(0)  # this file's directory; the worker imports its own tree
        worker()
    else:
        sys.exit(main())
