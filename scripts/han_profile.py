"""Where HAN's training steps spend the card's time.

    python3 scripts/han_profile.py [--steps N]

Builds the port's kernels, then on HAN's graph (``chip_smoke.han_graphs``:
``benchmarks/han_bench.py``'s shape, f32, 8 heads of 8) profiles under
``torch.profiler``, after a warm-up: ``--steps`` full-batch HAN training
steps (``chip_smoke.run_steps``: forward, backward, Adam; dropout 0) and
``--steps`` SampledHAN steps at B 32 and 4096 (``han_trainer.sampled_step``
on one batch's blocks). For each: the host-clock median step (to a
synchronize), the device time per step summed by kernel name (the
profiler's CUDA rows; the top 12), its share of the host-clock step (the
device's busy share), and the share of B10, B9 and K1 (the kernels of
``csrc/gather.cu``, ``gather_sorted.cu`` and ``segment_sum.cu``). Prints
the card's name and power limit and one JSON line. Needs one CUDA card
(about a minute with the build).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

OURS = {"gather_kernel": "B10", "gather_sorted_kernel": "B9", "segment_chunks_kernel": "K1",
        "segment_combine_kernel": "K1"}


def device_ms(step, steps):
    """Device time (ms) of ``steps`` calls of ``step()`` by kernel name (the
    profiler's CUDA rows only: an operator's row repeats its kernels'
    time; the optimizer's annotation row is a range, not a kernel)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False) or ev.key.startswith("Optimizer.")):
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        by_name[ev.key] = by_name.get(ev.key, 0.0) + t / 1e3
    return by_name


def host_ms(step, steps):
    """Median host-clock time (ms) of ``step()`` to a synchronize."""
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def report(label, step, steps, card):
    step()  # warm-up
    torch.cuda.synchronize()
    host = host_ms(step, steps)
    by_name = {k: v / steps for k, v in device_ms(step, steps).items()}
    dev = sum(by_name.values())
    ours = {}
    for k, v in by_name.items():
        for name, tag in OURS.items():
            if name in k:
                ours[tag] = ours.get(tag, 0.0) + v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"[{label}] host-clock median step {host:.3f} ms; device {dev:.3f} ms per step "
          f"(busy {dev / host:.1%}); B10 {ours.get('B10', 0.0):.3f}, B9 {ours.get('B9', 0.0):.3f}, "
          f"K1 {ours.get('K1', 0.0):.3f} ms [{card}]", flush=True)
    for k, v in top:
        print(f"    {v:9.4f} ms/step  {k[:110]}", flush=True)
    return dict(host_ms=host, device_ms=dev, ours=ours, top={k[:80]: v for k, v in top})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("han_profile: no CUDA device", file=sys.stderr)
        return 1
    from allset_tpu_torch.data.sampler import HANNeighborSampler
    from allset_tpu_torch.models.han import SampledHAN
    from allset_tpu_torch.ops import _kernels
    from allset_tpu_torch.train import han_trainer as ht
    from allset_tpu_torch.train.factory import make_optimizer
    from allset_tpu_torch.train.trainer import train_steps

    card = cs.card_line()
    print(card, flush=True)
    _kernels.build()
    _kernels.lib()
    dev = torch.device("cuda", 0)
    hd, batch = cs.han_graphs(dev)
    out = {"card": card, "steps": args.steps}
    model = cs.han_model(0, dev)
    mask = cs.han_loss_mask(batch)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    out["HAN"] = report("HAN step", lambda: train_steps(model, batch, mask, 1, optimizer=opt),
                        args.steps, card)
    del model, opt
    sampler = HANNeighborSampler(hd, num_neighbors=20, seed=0)
    for B in (32, 4096):
        seeds = np.arange(B) % hd.num_nodes
        blocks = ht.block_tensors(sampler.sample(seeds), dev)
        sd, valid = torch.as_tensor(seeds).to(dev), torch.ones(B, dtype=torch.bool, device=dev)
        m = SampledHAN(cs.han_config(), torch.Generator().manual_seed(0)).to(dev)
        o = make_optimizer(m, 0.005, 0.001)
        out[f"SampledHAN_B{B}"] = report(
            f"SampledHAN B={B}",
            lambda: ht.sampled_step(m, o, batch.x, batch.y, sd, blocks, valid, None),
            args.steps, card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
