"""Time two trees of this repository on one card, in alternating pairs.

    python3 scripts/pair_timing.py OTHER_TREE [--pairs N]

OTHER_TREE is another checkout of the repository (for example an earlier
commit unpacked with ``git archive`` into an ignored directory). For each
pair the script runs one worker process in OTHER_TREE, two in this tree
and one more in OTHER_TREE, so that drift on the card falls on both
sides. A worker imports its own tree's package and ``chip_smoke.py``
(this script is a developer tool beside the smoke script; the package
never imports either), builds its own kernels and measures, on the card:

  * the bench step (bf16, the bench graph of ``chip_smoke.bench_batch``)
    at hidden 256 and 512: the median of 8 training steps
    (``chip_smoke.main_path``, with its launch and repeatability checks,
    K3's parts counted where the tree routes K3 at 512 to the warpgroup
    or cluster kernels), and the last of 8 steps' losses from the same
    seeds, so that two trees' losses can be held to the same bits;
  * K2, the PMA epilogue's forward, at hidden 384 and 512 (8 heads, 2
    layers; CUDA events, inputs made on the card): in bf16 summed over a
    bench step's 2 launches (its 196,608 and 131,072 rows), and K2R in f32
    over a 20-run epoch's 4 launches (the walmart preset's 158,766 and
    88,860 rows, twice each);
  * the runs protocol (f32, synthetic-walmart preset, 20 runs folded) at
    hidden 256 and 512: a warm epoch through the CLI (one epoch to warm
    up, then 6 timed at 256 and 4 at 512);
  * above HC 512 (the wide route): K2 and K3 at hidden 640 and 1024 in
    bf16 per bench step, K2R and K3R at 1024 in f32 per 2-run epoch (K2R
    twice and K3R once per row count), the bench step at hidden 1024
    (main_path, as at 512), and the peak device memory per folded run of
    ``--MLP_hidden 1024`` through the CLI (walmart preset, f32, 2 runs x 1
    epoch; ``chip_smoke.cli_peak``).

With ``--set narrow`` a worker measures instead B9 and B13 with
``scripts/ln_gather_probe.py``'s functions (this tree's script, the
worker's tree's package and ``chip_smoke.py``):

  * B9 at each shape of a CEGAT bench step's and a HAN step's sorted
    gathers, and per step: the event time of 20 calls back to back, the
    device time from a CUDA graph and the host time of a call, beside B10
    and index_select at the same shapes;
  * B13 per AllDeepSets bench step (bf16) and per 20-run epoch (walmart
    preset, f32), event and device times, and at ``[196608, 256]`` bf16;
  * the AllDeepSets bench step and the CEGAT bench step end to end (the
    median of 8 training steps, ``chip_smoke.main_path`` and
    ``chip_smoke.zoo_path`` with their launch and repeatability checks).

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
BENCH_ROWS = (196_608, 131_072)  # a bench step's two half-layers (one K2 each)
EPOCH_ROWS = (158_766, 88_860)  # the walmart preset's half-layers


def _k2_ms(cs, HC, rows, R, dtype, dev, bwd=False):
    """K2 (R None: a launch per row count) or K2R (R runs: 2 launches per
    row count, train and eval) at width HC with 8 heads and 2 layers, in
    ms summed over the launches; with ``bwd`` K3 or K3R instead (one
    launch per row count); the inputs are made on the card."""
    import torch

    from allset_tpu_torch.ops import cuda_pma as cp

    H, L, WP, runs = 8, 2, HC + 8, R or 1
    g = torch.Generator(device=dev).manual_seed(HC)
    total = 0.0
    for M in rows:
        agg = torch.zeros(M, runs, WP, device=dev)
        agg[:, :, :HC] = torch.randn(M, runs, HC, device=dev, generator=g)
        agg[:, :, HC:HC + H] = torch.rand(M, runs, H, device=dev, generator=g) * 2.7 + 0.3
        agg = agg.reshape(M, runs * WP).to(dtype)
        r = lambda *s: torch.randn(runs, *s, device=dev, generator=g)
        p = [0.1 * r(HC), 1 + 0.1 * r(HC), 0.1 * r(HC), 0.05 * r(L, HC, HC), 0.1 * r(L, HC),
             1 + 0.1 * r(HC), 0.1 * r(HC)]
        gy = torch.randn(M, runs * HC, device=dev, generator=g).to(dtype)
        if R is None:
            p = [t[0] for t in p]
            if bwd:
                total += cs.cuda_ms(lambda: cp.epilogue_bwd_cuda(agg, gy, *p, H, True))
            else:
                total += cs.cuda_ms(lambda: cp.epilogue_fwd_cuda(agg, *p, H, True))
        elif bwd:
            total += cs.cuda_ms(lambda: cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, True), iters=3)
        else:
            total += 2 * cs.cuda_ms(lambda: cp.epilogue_fwd_runs_cuda(agg, *p, H, True), iters=3)
        del agg, gy, p
        torch.cuda.empty_cache()
    return total


def _last_loss(cs, batch, dev, hidden):
    """The last loss of 8 bench steps at ``hidden`` from chip_smoke's
    seeded bench model (main_path's first run)."""
    import torch

    mask = torch.arange(batch.num_nodes, device=dev) % 2 == 0
    model = cs.bench_model(0, batch.inc.nnz_padded, hidden).to(dev)
    losses, _ = cs.run_steps(model, batch, mask, 8)
    return float(losses[-1])


def _warm_epoch(cli, tmp, hidden, epochs):
    """ms per epoch of the walmart preset at ``hidden`` (20 runs folded,
    f32) over ``epochs`` epochs after one to warm up, and the final mean
    training loss."""
    base = ["--dname", WALMART, "--preset", "--dtype", "float32", "--device", "cuda",
            "--MLP_hidden", str(hidden), "--res_root", tmp]
    cli.run(base + ["--epochs", "1"])
    res = cli.run(base + ["--epochs", str(epochs)])
    return res.wall_time / epochs * 1e3, float(res.metrics[:, -1, 3].mean())


def worker() -> None:
    """Measure the tree in the working directory (see the module note)."""
    tree = os.getcwd()
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from allset_tpu_torch import cli
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    dev = torch.device("cuda", 0)
    _kernels.build(force=True)
    _kernels.lib()
    out = {"tree": tree}
    card = cs.card_line()
    batch = cs.bench_batch(dev)
    _, out["bench_step_ms"] = cs.main_path(batch, dev, card)
    parts512 = hasattr(cp, "bwd_kernel") and cp.bwd_kernel(512, torch.bfloat16) != "tiled"
    _, out["bench_step_hc512_ms"] = cs.main_path(
        batch, dev, card, cs.PER_STEP if parts512 else cs.off_wg(cs.PER_STEP), hidden=512)
    _, out["bench_step_hc1024_ms"] = cs.main_path(batch, dev, card,
                                                  cs.off_wg(cs.PER_STEP, 1024), hidden=1024)
    out["bench_final_loss"] = _last_loss(cs, batch, dev, 256)
    out["bench_final_loss_hc512"] = _last_loss(cs, batch, dev, 512)
    del batch
    torch.cuda.empty_cache()
    for HC in (384, 512):
        out[f"k2_bf16_hc{HC}_ms_per_step"] = _k2_ms(cs, HC, BENCH_ROWS, None, torch.bfloat16,
                                                    dev)
        out[f"k2r_f32_hc{HC}_ms_per_epoch"] = _k2_ms(cs, HC, EPOCH_ROWS, 20, torch.float32,
                                                     dev)
    for HC in (640, 1024):
        for name, bwd in (("k2", False), ("k3", True)):
            out[f"{name}_bf16_hc{HC}_ms_per_step"] = _k2_ms(cs, HC, BENCH_ROWS, None,
                                                            torch.bfloat16, dev, bwd)
    for name, bwd in (("k2r", False), ("k3r", True)):
        out[f"{name}_f32_hc1024_ms_per_2run_epoch"] = _k2_ms(cs, 1024, EPOCH_ROWS, 2,
                                                             torch.float32, dev, bwd)
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--dname", WALMART, "--preset", "--MLP_hidden", "1024", "--dtype", "float32",
                "--device", "cuda", "--runs", "2", "--epochs", "1", "--res_root", tmp]
        _, _, peak, _ = cs.cli_peak(argv, 1, cs.off_wg(cs.pma_group_epoch()), dev,
                                    mlp_hidden=1024)
        out["cli_hc1024_peak_gib_per_run"] = peak / 2**30
        out["epoch_ms"], out["final_loss"] = _warm_epoch(cli, tmp, 256, 6)
        out["epoch_hc512_ms"], out["final_loss_hc512"] = _warm_epoch(cli, tmp, 512, 4)
    print("PAIR " + json.dumps(out), flush=True)


def narrow_worker() -> None:
    """B9 and B13 in the tree in the working directory (see the module
    note, ``--set narrow``)."""
    import importlib.util

    tree = os.getcwd()
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from allset_tpu_torch.graph import Batch
    from allset_tpu_torch.ops import _kernels
    from allset_tpu_torch.train.factory import v2v_incidence

    spec = importlib.util.spec_from_file_location(
        "ln_gather_probe", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "ln_gather_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    dev = torch.device("cuda", 0)
    _kernels.build(force=True)
    _kernels.lib()
    card = cs.card_line()
    out = {"tree": tree}
    b9, b9_sums = probe.probe_b9(cs, dev, probe.sorted_gather_calls(cs, dev))
    for key, r in b9.items():
        for k in ("b9", "b10", "index_select"):
            for t in ("event_ms", "device_ms", "host_us"):
                out[f"{key} {k} {t}"] = r[f"{k}_{t}"]
    for what, r in b9_sums.items():
        for k, v in r.items():
            out[f"{what} {k}"] = v
    b13, b13_sums = probe.probe_b13(cs, dev, None, probe.step_shapes(cs))
    for what, r in b13_sums.items():
        for k, v in r.items():
            out[f"b13 per {what} {k}"] = v
    for key, r in b13.items():
        for k in ("event_ms", "device_ms"):
            out[f"b13 {key} {k}"] = r[k]
    batch = cs.bench_batch(dev)
    _, out["deepsets_step_ms"] = cs.main_path(batch, dev, card, cs.PER_STEP_DEEPSETS, pma=False,
                                              aggregate="add")
    del batch
    raw = cs.bench_raw()
    batches = {"CEGAT": Batch.from_incidence(raw, v2v_incidence(raw, "CEGAT", bucket=1024), dev)}
    _, out["cegat_step_ms"] = cs.zoo_path(batches, dev, card, "CEGAT", dict(cs.CE)["CEGAT"])
    print("PAIR " + json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another checkout of the repository")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--set", choices=("full", "narrow"), default="full",
                    help="what each worker measures (see the module note)")
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
            r = subprocess.run([sys.executable, script, f"--worker={args.set}"], cwd=tree,
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
    if sys.argv[1:2] in (["--worker=full"], ["--worker=narrow"]):
        sys.path.pop(0)  # this file's directory; the worker imports its own tree
        narrow_worker() if sys.argv[1] == "--worker=narrow" else worker()
    else:
        sys.exit(main())
