"""The trainer's spans against the device trace of one benchmark cell.

    python3 scripts/trainer_spans.py --workload ast-walmart-r20 --seed 7 [--out DIR]

On a machine with the card: first the host cost of the spans a
group-epoch opens, with the profiler off (a loop of the epoch's five
spans and its launch count against the bare loop); then one traced run of
the cell, as ``python3 -m hgbench.run --trace 1`` makes it, whose Chrome
trace events are kept in memory. From the run's recorder
(``allset_tpu_torch/utils/profiling.py``) and those events it prints, and
writes as JSON into ``--out`` (default ``chiprun_out/``):

  * the run's per-layer metrics and its ``window_s``;
  * the four phases' device ms per epoch against the epochs' (the
    timing events), and the epochs' device ms plus ``runs_init_ms``
    against ``window_s``;
  * per phase, the recorder's device ms against the device span of the
    kernels, copies and fills launched inside the phase's host ranges
    (matched by their correlation ids; the backward's launches come from
    autograd's thread while the trainer's range is open), which holds the
    timing events to the profiler's clock;
  * the device's idle time inside the job by the innermost ``trainer.*``
    range open on the trainer's thread (``outside`` where none is), and
    the harness's own idle breakdown (innermost host event of any kind);
  * the host seconds of the process's first epoch and of its phases,
    and of the process's first fit (the harness's check job) by span.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PHASES = ("trainer.forward", "trainer.backward", "trainer.optimizer", "trainer.eval")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span_cost_us(device, n: int = 20000, repeats: int = 5) -> dict:
    """Host microseconds a group-epoch's spans cost with the profiler off:
    the epoch span, its four phases and the launch count, against the same
    loop without them; the least of ``repeats`` loops each."""
    from allset_tpu_torch.ops import _kernels
    from allset_tpu_torch.utils import profiling as prof

    launches = _kernels.launches

    def spans():
        rec = prof.Recorder(cap=n * 5)
        t0 = time.perf_counter_ns()
        for _ in range(n):
            n0 = sum(launches.values())
            with rec.span("trainer.epoch", device) as epoch:
                for name in PHASES:
                    with rec.span(name, device):
                        pass
                epoch.counts["launches"] = sum(launches.values()) - n0
        return (time.perf_counter_ns() - t0) / n / 1e3

    def bare():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            for _name in PHASES:
                pass
        return (time.perf_counter_ns() - t0) / n / 1e3

    with_us = min(spans() for _ in range(repeats))
    without_us = min(bare() for _ in range(repeats))
    return {"with_us": with_us, "without_us": without_us, "spans_us": with_us - without_us}


def innermost_segments(ranges: list) -> list:
    """[(start, end, name)] pieces of time, each labelled by the innermost
    of the nested ``ranges`` open then."""
    cuts = sorted({t for e in ranges for t in (e["ts"], e["ts"] + e["dur"])})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        m = (a + b) / 2
        open_ = [e for e in ranges if e["ts"] <= m < e["ts"] + e["dur"]]
        if open_:
            out.append((a, b, max(open_, key=lambda e: (e["ts"], -e["dur"]))["name"]))
    return out


def idle_by_range(idle: list, segments: list) -> dict:
    """Idle microseconds by the segment's name; ``outside`` where no
    segment covers them."""
    got = {}
    for a, b in idle:
        covered = 0.0
        for s0, s1, name in segments:
            lo, hi = max(a, s0), min(b, s1)
            if hi > lo:
                got[name] = got.get(name, 0.0) + hi - lo
                covered += hi - lo
        if b - a - covered > 0:
            got["outside"] = got.get("outside", 0.0) + (b - a - covered)
    return got


def analyse(events: list, fit: list, epochs: int) -> dict:
    from hgbench import trace as tr

    job = [e for e in events if e.get("name") == tr.SPAN and e.get("cat") == "user_annotation"][0]
    w0, w1 = job["ts"], job["ts"] + job.get("dur", 0)
    pid, tid = job.get("pid"), job.get("tid")
    dev = [e for e in events if e.get("cat") in tr.DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0]
    by_corr = {}
    for e in dev:
        c = (e.get("args") or {}).get("correlation")
        if c is not None:
            by_corr.setdefault(c, []).append(e)
    launches = [e for e in events if e.get("cat") in LAUNCH_CATS and e.get("pid") == pid
                and w0 <= e["ts"] <= w1]
    ranges = [dict(e, dur=e.get("dur", 0)) for e in events
              if e.get("cat") == "user_annotation" and e.get("pid") == pid
              and e.get("tid") == tid and e.get("name", "").startswith("trainer.")
              and w0 <= e["ts"] <= w1]

    # per phase: the device span of what was launched inside each host range
    kernel_span = {}
    for name in PHASES:
        total = 0.0
        for r in (r for r in ranges if r["name"] == name):
            corr = {(e.get("args") or {}).get("correlation") for e in launches
                    if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]}
            ops = [d for c in corr if c in by_corr for d in by_corr[c]]
            if ops:
                total += (max(d["ts"] + d.get("dur", 0) for d in ops)
                          - min(d["ts"] for d in ops))
        kernel_span[name] = total / 1e3  # ms

    spans_ms = {name: sum(s.device_ms for s in fit if s.name == name) for name in PHASES}
    epoch_ms = sum(s.device_ms for s in fit if s.name == "trainer.epoch")
    init_ms = sum(s.seconds for s in fit if s.name in ("trainer.masks", "trainer.init")) * 1e3
    busy = tr._union([(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)) for e in dev])
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle_us = sum(b - a for a, b in idle)
    by_range = idle_by_range(idle, innermost_segments(ranges))
    window_ms = (w1 - w0) / 1e3
    return {
        "window_ms": window_ms,
        "phases_ms_per_epoch": {k: v / epochs for k, v in spans_ms.items()},
        "epoch_ms_per_epoch": epoch_ms / epochs,
        "phases_over_epochs": sum(spans_ms.values()) / epoch_ms,
        "epochs_plus_init_over_window": (epoch_ms + init_ms) / window_ms,
        "phase_over_kernel_span": {k: spans_ms[k] / kernel_span[k] if kernel_span[k] else None
                                   for k in PHASES},
        "kernel_span_ms": kernel_span,
        "idle_s": idle_us / 1e6,
        "idle_s_by_trainer_range": dict(sorted(((k, v / 1e6) for k, v in by_range.items()),
                                               key=lambda kv: -kv[1])),
        "idle_share_outside_trainer_ranges": by_range.get("outside", 0.0) / idle_us
        if idle_us else 0.0,
    }


def by_name(spans: list) -> dict:
    """Host seconds of ``spans`` summed by name, with their count."""
    got = {}
    for s in spans:
        n, t = got.get(s.name, (0, 0.0))
        got[s.name] = (n + 1, t + s.seconds)
    return {k: {"n": n, "s": t} for k, (n, t) in got.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=os.path.join(HERE, "chiprun_out"))
    args = p.parse_args(argv)

    import torch

    from hgbench import manifest, run, spans
    from hgbench import trace as tr
    from allset_tpu_torch.utils import profiling as prof

    torch.set_num_threads(1)  # as the harness runs the program
    if not torch.cuda.is_available():
        print("trainer_spans: needs a CUDA card", file=sys.stderr)
        return 2
    cost = span_cost_us(torch.device("cuda"))
    summarize, kept = tr.summarize, {}

    def keep(events):
        kept["events"] = events
        return summarize(events)

    tr.summarize = keep
    cell = manifest.cell(args.workload)
    out = run.run(cell, args.seed, 30.0, True)
    epochs = cell.traffic["job"]["epochs"]
    sp, fit = prof.spans(), spans.traced_fit()
    first = [s for s in sp if s.name == "trainer.epoch"][0]
    res = {
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(0),
        "span_cost_us_per_group_epoch": cost,
        "metrics": {k: v["value"] for k, v in out["metrics"].items()},
        "window_s": out["device"]["window_s"], "busy_s": out["device"]["busy_s"],
        "correct": out["correct"],
        "harness_idle_gaps": out["breakdown"]["idle_gaps"],
        "first_epoch_s": first.seconds,
        "first_epoch_phases_s": {s.name: s.seconds for s in sp if s.parent == first.id},
        "first_fit_s": by_name([s for s in sp if s.fit == first.fit]),
        **analyse(kept["events"], fit, epochs),
    }
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"trainer_spans_{args.workload}_{args.seed}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
