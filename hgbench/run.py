"""Runs one cell once:

    python3 -m hgbench.run --workload NAME --seed N --seconds S --trace 0|1

Set-up: the graph from the traffic file and the seed; the program's
``prepare`` on its arrays; one check job of CHECK_STEPS epochs through
``Trainer.fit`` at the cell's job, runs and fold, whose optimizer steps
``program.Capture`` reads. That job builds every shape the window uses.

``--trace 0``: the window runs the cell's job through ``Trainer.fit``
back to back until ``--seconds`` have passed, and finishes the last job
it started; it prints ``run_epochs_per_s`` (all run-epochs over the time
from the first job's start to the last one's end) and ``setup_s`` (from
the process's start to the first job's start). ``--trace 1``: one job
under the profiler instead, and the cell's per-layer metrics read from
its trace.

After the window: the peak device memory is read, the program's state is
freed, and the reference follows the first CHECK_STEPS steps of every
run; each job's first CHECK_STEPS epochs of losses and the check job's
gradients and changes are compared with it (``compare.py``). The numbers
and their limits go to standard error as its last lines and into the
result's ``checks``; the result is the last line of standard output.

The run exits with another code than 0 and prints no result where no
card is present, where the cell asks for more cards than there are, and
where the process holds a module of JAX or of the JAX package once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()  # the process's start, before the heavy imports

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

CHECK_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "allset_tpu")


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package in this process, compared by
    their whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def shapes_of(cell, graph, groups):
    from hgbench import costs
    from hgbench.graphs import self_loop_nodes

    c = cell.config
    return costs.Shapes(N=graph.num_nodes, E=graph.num_hyperedges, nnz=graph.nnz,
                        n_sl=int(self_loop_nodes(graph).sum()), F=graph.num_features,
                        classes=graph.num_classes, method=c["method"],
                        layers=c["All_num_layers"], mlp_layers=c["MLP_num_layers"],
                        HC=c["MLP_hidden"], heads=c["heads"],
                        cls_layers=c["Classifier_num_layers"],
                        cls_hidden=c["Classifier_hidden"], groups=tuple(groups),
                        dtype=c["dtype"])


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float = T_START, root=None) -> dict:
    """One run of ``cell``; returns the result's fields."""
    import numpy as np
    import torch

    from hgbench import compare, graphs, manifest, program
    from hgbench.reference.follow import follow

    seed = seed % (1 << 63)  # numpy seeds with whole numbers from 0 up
    cuda = torch.device(device).type == "cuda"
    job = cell.traffic["job"]
    steps = [("imports", time.time())]
    graph = graphs.make_graph(cell.traffic["graph"], seed)
    steps.append(("graph", time.time()))
    system = program.prepare_system(cell.config, job, graph, seed, CHECK_STEPS, device)
    steps.append(("prepare", time.time()))
    with program.Capture(CHECK_STEPS) as cap:
        check = system.check.fit()
    leaves = cap.readings()
    steps.append(("check job", time.time()))
    prev = t_start
    for name, t in steps:
        print(f"[hgbench] set-up: {name} {t - prev:.3f} s", file=sys.stderr)
        prev = t
    print(f"[hgbench] check job: optimizer steps at {[round(t - steps[-2][1], 3) for t in cap.times]}"
          f" s", file=sys.stderr)

    out: dict = {"device": {}}
    if trace:
        from hgbench import trace as tr
        from hgbench.readers import Context

        res, summ = tr.traced(lambda: system.job.fit())
        jobs = [res]
        ctx = Context(device_s=summ["device_s"], busy_s=summ["busy_s"],
                      window_s=summ["window_s"], epochs=job["epochs"], groups=res.groups,
                      shapes=shapes_of(cell, graph, res.groups))
        metrics = {}
        for m in cell.per_layer:
            v = manifest.reader(m["name"], root or manifest.ROOT).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["device"].update(busy_s=summ["busy_s"], window_s=summ["window_s"])
        out["breakdown"] = {"device_ops": summ["device_ops"], "idle_gaps": summ["idle_gaps"]}
        from hgbench.costs import epoch_flops

        print(f"[hgbench] traced job: busy {summ['busy_s']:.4f} of {summ['window_s']:.4f} s; "
              f"{epoch_flops(ctx.shapes):.6e} matrix-product FLOPs an epoch; device ops by time:",
              file=sys.stderr)
        for name, s in sorted(summ["device_s"].items(), key=lambda kv: -kv[1])[:40]:
            print(f"[hgbench]   {s * 1e3:12.3f} ms  {name[:150]}", file=sys.stderr)
    else:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.time()
        setup_s = t0 - t_start
        jobs, ends = [], []
        while True:
            jobs.append(system.job.fit())
            t1 = time.time()
            ends.append(t1)
            if t1 - t0 >= seconds:
                break
        run_epochs = sum(job["runs"] * r.metrics.shape[1] for r in jobs)
        metrics = {"run_epochs_per_s": {"value": run_epochs / (t1 - t0), "unit": "run-epochs/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        print(f"[hgbench] set-up {setup_s:.3f} s; {len(jobs)} jobs, {run_epochs} run-epochs in "
              f"{t1 - t0:.3f} s; groups {jobs[0].groups}; each job "
              f"{[round(b - a, 3) for a, b in zip([t0] + ends, ends)]} s", file=sys.stderr)
    if cuda:
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": 1,
                         "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
                         **out["device"]}
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0,
                         **out["device"]}
    out["forbidden"] = forbidden_modules()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.time()
    ref = follow(cell.config, job, graph, seed, CHECK_STEPS, device)
    results = [check] + jobs
    got = [program.losses(r, CHECK_STEPS) for r in results]
    nums = compare.numbers(got, leaves, ref)
    limits = cell.limits or {}
    failed = sum(1 for r, g in zip(results, got)
                 if not (limits and compare.job_ok(g, ref, limits))
                 or not np.all(np.isfinite(r.metrics)))
    correct = bool(limits) and failed == 0 and compare.judge(nums, limits)
    print(f"[hgbench] reference: {time.time() - t_ref:.3f} s for {job['runs']} runs x "
          f"{CHECK_STEPS} steps; worst leaves {compare.worst(leaves, ref)}", file=sys.stderr)
    out.update(correct=correct, attempted=len(results), failed=failed, metrics=metrics,
               checks={k: {"value": nums[k], "limit": limits.get(k)} for k in compare.NAMES})
    return out


def emit(out: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, its ``checks`` last."""
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']:.6e} limit {c['limit']}", file=sys.stderr)
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from hgbench import manifest

    # one host thread for the program's CPU work (the runs' parameter
    # draws, the splits): a pool of threads on a shared host made whole
    # jobs swing by some percent from one to the next
    torch.set_num_threads(1)

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[hgbench] {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace))
    found = sorted(set(out["forbidden"]) | set(forbidden_modules()))
    if found:
        print(f"[hgbench] the process holds {found} after the window: no result",
              file=sys.stderr)
        return 3
    emit(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
