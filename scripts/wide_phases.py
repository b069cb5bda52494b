"""Time the wide route of the PMA epilogue (K2/K3 above HC 512) and its
phases on one card.

    python3 scripts/wide_phases.py [--hc 640,1024] [--iters 5]

For each width the script builds the package's kernels, then, with CUDA
events, on inputs made on the card (8 heads, an rFF of 2 layers):

  * per bench step (bf16, the two half-layers' 196,608 and 131,072 rows):
    K2 and K3, each as the whole call and as its plain version (the
    PyTorch composition the CPU runs), and their phases one after another
    (K2: LN0, the products, LN1; K3: LN0, the forward products, LN1's
    backward, dW, dp @ W^T, LN0's backward, the reduce; each phase the
    median of ``--iters`` calls);
  * at 1024 also per 2-run epoch (f32, R = 2, the walmart preset's
    158,766 and 88,860 rows; K2R twice and K3R once per row count), the
    same numbers;

each beside its bound (``chip_smoke.epi_cost``: the bytes over 3.35 TB/s
or the products over the tensor cores). It prints a line per shape and
one JSON line with the card's name and power limit. Needs one CUDA card;
the card's tree imports ``chip_smoke.py`` beside the package (a developer
tool: the package never imports it).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

BENCH_ROWS = (196_608, 131_072)
EPOCH_ROWS = (158_766, 88_860)


def _inputs(M, HC, R, dtype, dev, g):
    """agg [M, R*WP], gy [M, R*HC] and the parameters (a leading [R] axis
    unless R is None), 8 heads, 2 layers."""
    import torch

    H, L, WP, runs = 8, 2, HC + 8, R or 1
    agg = torch.zeros(M, runs, WP, device=dev)
    agg[:, :, :HC] = torch.randn(M, runs, HC, device=dev, generator=g)
    agg[:, :, HC:HC + H] = torch.rand(M, runs, H, device=dev, generator=g) * 2.7 + 0.3
    agg = agg.reshape(M, runs * WP).to(dtype)
    gy = torch.randn(M, runs * HC, device=dev, generator=g).to(dtype)
    r = lambda *s: torch.randn(runs, *s, device=dev, generator=g)
    p = [0.1 * r(HC), 1 + 0.1 * r(HC), 0.1 * r(HC), 0.05 * r(L, HC, HC), 0.1 * r(L, HC),
         1 + 0.1 * r(HC), 0.1 * r(HC)]
    if R is None:
        p = [t[0] for t in p]
    return agg, gy, p


def _phases(call, iters):
    """{phase: median ms} of a wide K2's or K3's phases (``call(mark=f)``)
    over ``iters`` calls."""
    import torch

    call()
    runs = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))
        call(mark=mark)
        torch.cuda.synchronize()
        got, prev = {}, start
        for name, e in marks:
            got[name] = got.get(name, 0.0) + prev.elapsed_time(e)
            prev = e
        runs.append(got)
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def measure(cs, cp, HC, rows, R, dtype, dev, iters):
    """Times summed over a step's or an epoch's launches at width HC."""
    import torch

    g = torch.Generator(device=dev).manual_seed(HC)
    fwd_n = 1 if R is None else 2  # K2R runs in training and in evaluation
    out = {"k2_ms": 0.0, "k2_plain_ms": 0.0, "k3_ms": 0.0, "k3_plain_ms": 0.0,
           "k2_bound_ms": 0.0, "k3_bound_ms": 0.0, "k2_phases_ms": {}, "k3_phases_ms": {}}
    for M in rows:
        agg, gy, p = _inputs(M, HC, R, dtype, dev, g)
        if R is None:
            f, fp = cp.epilogue_fwd_cuda, cp.epilogue_fwd_plain
            b, bp = cp.epilogue_bwd_cuda, cp.epilogue_bwd_plain
        else:
            f, fp = cp.epilogue_fwd_runs_cuda, cp.epilogue_fwd_runs_plain
            b, bp = cp.epilogue_bwd_runs_cuda, cp.epilogue_bwd_runs_plain
        kf = cs.cuda_ms(lambda: f(agg, *p, 8, True), iters)
        pf = cs.cuda_ms(lambda: fp(agg, *p, 8, True), 2)
        kb = cs.cuda_ms(lambda: b(agg, gy, *p, 8, True), iters)
        pb = cs.cuda_ms(lambda: bp(agg, gy, *p, 8, True), 2)
        M_, WP_, HC_, L_ = cp._check_cuda_args(agg, p[0], p[3], 8, R)
        ph2 = _phases(cp._wide_fwd_setup(agg.contiguous(), *p, 8, True, R or 1, M_, WP_, HC_,
                                         L_)[0], iters)
        ph = _phases(cp._bwd_setup(agg, gy, *p, 8, True, R)[0], iters)
        for bwd, n, k, pl in ((False, fwd_n, kf, pf), (True, 1, kb, pb)):
            nbytes, ops = cs.epi_cost(M, HC, HC + 8, 2, dtype, bwd, R or 1)
            t_bytes = nbytes / cs.HBM * 1e3
            t_ops = sum(fl / cs.PEAK[key] for fl, key in ops) * 1e3
            key = "k3" if bwd else "k2"
            out[f"{key}_ms"] += n * k
            out[f"{key}_plain_ms"] += n * pl
            out[f"{key}_bound_ms"] += n * max(t_bytes, t_ops)
        for key, phs, n in (("k2_phases_ms", ph2, fwd_n), ("k3_phases_ms", ph, 1)):
            for name, ms in phs.items():
                out[key][name] = out[key].get(name, 0.0) + n * ms
        print(f"  HC={HC} M={M} R={R or 1} {str(dtype)[6:]}: K2 {kf:.3f} ms (plain {pf:.3f}; "
              + ", ".join(f"{k} {v:.3f}" for k, v in ph2.items())
              + f"), K3 {kb:.3f} ms (plain {pb:.3f}; "
              + ", ".join(f"{k} {v:.3f}" for k, v in ph.items()) + ")", flush=True)
        del agg, gy, p
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hc", default="640,1024", help="widths above 512, comma-separated")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import torch

    import chip_smoke as cs
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    if not torch.cuda.is_available():
        print("wide_phases: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    _kernels.build(force=True)
    _kernels.lib()
    for name, regs, st, ld in cs.ptxas_summary(_kernels.build_log):
        if "wide" in name:
            print(f"  ptxas {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    result = {"card": card}
    for HC in (int(h) for h in args.hc.split(",")):
        result[f"bench_step_hc{HC}"] = measure(cs, cp, HC, BENCH_ROWS, None, torch.bfloat16,
                                               dev, args.iters)
        if HC == 1024:
            result["epoch_2run_hc1024"] = measure(cs, cp, HC, EPOCH_ROWS, 2, torch.float32,
                                                  dev, args.iters)
    print("WIDE " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
