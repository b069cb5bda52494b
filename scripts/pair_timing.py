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
    launch and repeatability checks), and K1's, K2's and K3's kernel time
    per step at the main path's shapes (CUDA events);
  * the runs protocol (f32, synthetic-walmart preset, 20 runs folded):
    K1's, K2R's and K3R's kernel time per epoch at its shapes, and a warm
    epoch through the CLI (one epoch to warm up, then 6 timed).

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


def _segment_ms(cs, cseg, inc, order, W, dtype, dev):
    import torch

    indptr = getattr(inc, f"{order}_indptr")
    # a tree from before the chunk plan launches K1 without one
    plan = [getattr(inc, f"{order}_plan")] if hasattr(inc, f"{order}_plan") else []
    msgs = torch.randn(inc.nnz, W, device=dev, dtype=dtype)
    return cs.cuda_ms(lambda: cseg.segment_sum_cuda(msgs, indptr, indptr.shape[0] - 1, *plan))


def worker() -> None:
    """Measure the tree in the working directory (see the module note)."""
    tree = os.getcwd()
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from allset_tpu_torch import cli
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp, cuda_segment as cseg

    dev = torch.device("cuda", 0)
    _kernels.build(force=True)
    _kernels.lib()
    gen = torch.Generator().manual_seed(0)
    HC, H, WP, L = 256, 8, 264, 2
    out = {"tree": tree}
    batch = cs.bench_batch(dev)
    _, out["bench_step_ms"] = cs.main_path(batch, dev, cs.card_line())
    inc = batch.inc.real
    out["k1_ms_per_step"] = sum(2 * _segment_ms(cs, cseg, inc, o, WP, torch.bfloat16, dev)
                                for o in ("edge", "node"))
    k2 = k3 = 0.0
    for M in (inc.num_edges + batch.inc.num_nodes, batch.inc.num_nodes):
        agg, gy, p = cs.epi_inputs(M, HC, H, WP, L, torch.bfloat16, dev, gen, floor_rows=False)
        k2 += cs.cuda_ms(lambda: cp.epilogue_fwd_cuda(agg, *p, H, True), iters=20)
        k3 += cs.cuda_ms(lambda: cp.epilogue_bwd_cuda(agg, gy, *p, H, True))
    out["k2_ms_per_step"] = k2
    out["k3_ms_per_step"] = k3
    del batch, agg, gy, p
    torch.cuda.empty_cache()
    wb = cs.walmart_batch(dev)
    inc = wb.inc.real
    out["k1_ms_per_epoch"] = sum(3 * _segment_ms(cs, cseg, inc, o, 20 * WP, torch.float32, dev)
                                 for o in ("edge", "node"))
    k2r = k3r = 0.0
    for M in (inc.num_edges + wb.num_nodes, wb.num_nodes):
        agg, gy, p = cs.runs_inputs(M, HC, H, WP, L, 20, torch.float32, dev, gen,
                                    floor_rows=False)
        # an epoch launches K2R twice per half-layer (train and eval), K3R once
        k2r += 2 * cs.cuda_ms(lambda: cp.epilogue_fwd_runs_cuda(agg, *p, H, True), iters=5)
        k3r += cs.cuda_ms(lambda: cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, True), iters=3)
        del agg, gy, p
        torch.cuda.empty_cache()
    out["k2r_ms_per_epoch"] = k2r
    out["k3r_ms_per_epoch"] = k3r
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
