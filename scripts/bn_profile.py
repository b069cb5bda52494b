"""Where a training step with batch norm spends the card's time.

    python3 scripts/bn_profile.py [--steps N]

Builds the port's kernels, then, on the bench graph of
``chip_smoke.bench_batch`` (bf16, 131,072 nodes), times training steps
(``chip_smoke.run_train_steps``: batch statistics, Adam) of AllDeepSets
and AllSetTransformer at the bench width with ``--normalization`` 'ln' and
'bn' (VARIANTS; AllSetTransformer's 1-layer classifier has no norm, so
its variants differ in the exchange alone: 'ln' on the self-loop split
and on the unsplit exchange, 'bn' unsplit), each variant twice in
mirrored order (A B C C B A): the median step on the host clock to a
synchronize, and under ``torch.profiler`` the device time of ``--steps``
steps summed by kernel name (the profiler's CUDA rows; the top 12).
Prints the card's name and power limit and one JSON line. Needs one CUDA
card (about 2 minutes with the build).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

# (model, its SetGNN mode, the norm, whether the exchange is unsplit): 'bn'
# always takes the unsplit exchange; 'ln' the self-loop split, and
# unsplit where the batch's incidence has its split dropped, which
# isolates the exchange from the norm
VARIANTS = (
    ("AllDeepSets", dict(pma=False, aggregate="add"), "ln", False),
    ("AllDeepSets", dict(pma=False, aggregate="add"), "bn", True),
    ("AllSetTransformer", {}, "ln", False),
    ("AllSetTransformer", {}, "ln", True),
    ("AllSetTransformer", {}, "bn", True),
)


def profile_steps(model, batch, mask, steps):
    """Device time (ms) of ``steps`` training steps by kernel name (the
    profiler's CUDA rows only), and their total."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cs.run_train_steps(model, batch, mask, steps, seed=1)
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # an operator's row repeats its kernels' time
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        by_name[ev.key] = by_name.get(ev.key, 0.0) + t / 1e3
    return by_name, sum(by_name.values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bn_profile: no CUDA device", file=sys.stderr)
        return 1
    from allset_tpu_torch.ops import _kernels

    card = cs.card_line()
    print(card, flush=True)
    _kernels.build()
    _kernels.lib()
    dev = torch.device("cuda", 0)
    batch = cs.bench_batch(dev)
    mask = torch.arange(batch.num_nodes, device=dev) % 2 == 0
    nnz = batch.inc.nnz_padded
    unsplit = dataclasses.replace(batch, inc=dataclasses.replace(batch.inc, real=None))
    out = {"card": card, "steps": args.steps}
    labels = [f"{m} {norm}{' unsplit' if u else ''}" for m, _, norm, u in VARIANTS]
    times = {k: [] for k in labels}
    order = list(range(len(VARIANTS)))
    for i in order + order[::-1]:  # each variant twice, in mirrored order
        _, mode, norm, u = VARIANTS[i]
        model = cs.bench_model(0, nnz, normalization=norm, **mode).to(dev)
        b = unsplit if u else batch
        cs.run_train_steps(model, b, mask, 1)  # warm-up
        _, t = cs.run_train_steps(model, b, mask, 8)
        times[labels[i]].append(statistics.median(t) * 1e3)
        del model
    for label, (_, mode, norm, u) in zip(labels, VARIANTS):
        model = cs.bench_model(0, nnz, normalization=norm, **mode).to(dev)
        b = unsplit if u else batch
        cs.run_train_steps(model, b, mask, 1)
        by_name, total = profile_steps(model, b, mask, args.steps)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        per_step = total / args.steps
        print(f"[{label}] host-clock median step {[round(v, 3) for v in times[label]]} ms; "
              f"device time {per_step:.3f} ms per step (profiler, kernels only) [{card}]",
              flush=True)
        for k, v in top:
            print(f"    {v / args.steps:9.3f} ms/step  {k[:110]}", flush=True)
        out[label] = dict(host_ms=times[label], device_ms_per_step=per_step,
                          top={k[:80]: v / args.steps for k, v in top})
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
