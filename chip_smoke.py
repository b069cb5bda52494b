"""Build and run the PyTorch port on one CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
  2. build the CUDA kernels from allset_tpu_torch/csrc (nvcc, sm_90a);
  3. compare each kernel with its plain PyTorch version on the card, in
     f32 and bf16: K1 segment_sum (empty segments, one huge segment,
     unread padded tail rows; widths up to 20 runs x 264), K2/K3 the PMA
     epilogue and K2R/K3R its runs grids (R in {2, 5}; L in {1, 2}, relu
     on/off, rows not a multiple of the tile; each run of K2R/K3R also
     bit for bit against a K2/K3 launch on its slice), and at the main
     paths' shapes, with the kernel and plain times;
  4. the benchmark step at its size and width (bf16): the
     AllSetTransformer training step on scale_free_hypergraph(131072
     nodes, 65536 edges, edge size 12, 256 features), 8 Adam steps:
     the loss is finite and falls, each step launches K1 4 times and
     K2, K3 twice, and two runs from one state give identical losses;
  5. a small f32 graph: one step through the kernels against one step
     of the plain versions (on the CPU) from the same parameters;
  6. the runs protocol through the CLI (allset_tpu_torch.cli) on
     synthetic-walmart with the tuned preset (hidden 256, 8 heads, f32):
     20 runs folded into each launch for a few epochs; per group and
     epoch 6 K1, 4 K2R and 2 K3R launches whatever the number of runs;
     finite metrics, a falling training loss; 2 runs folded against 2
     runs one by one: equal accuracies, losses within rtol 2e-3;
  7. the accuracy band: 5 runs x 500 epochs of the same preset; the mean
     final test accuracy within band_tolerance(std, 5, 20) of the 20-run
     band in BANDS.json (scripts/record_bands.py).
The line before the last is a JSON object of per-kernel results (K1,
K2R, K3R from phase 6's run, K2, K3 from phase 4's); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

TOL = {  # (forward, gradient) tolerance, scaled by the reference's max |.|
    torch.float32: (1e-4, 1e-4),
    torch.bfloat16: (1e-2, 6e-2),
}
EPI_FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
WALMART = "synthetic-walmart"  # the runs protocol's dataset (phases 6, 7)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() in ms (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def scaled_err(got, want):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return float("inf"), float("inf")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    return err, err / max(want.abs().max().item() if want.numel() else 0.0, 1.0)


def require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def check_bwd(got, want, gtol, what) -> str:
    """K3's outputs (dagg, dW, dsmall) against the plain version, each
    scaled by the reference's max |.|. A sparse tail of elements may
    differ by a few rounding steps of the products' inputs, so the rule
    is the JAX package's test rule: under 1e-3 of the elements beyond
    gtol (2 * gtol for dW). Rows at the 1e-16 denominator floor carry
    dvals ~1e16 and are checked apart, so their scale hides nothing."""
    floor = want[0].float().abs().amax(dim=1) >= 1e6
    pairs = (("dagg", got[0][~floor], want[0][~floor]),
             ("dagg@floor", got[0][floor], want[0][floor]),
             ("dW", got[1], want[1]), ("dsmall", got[2], want[2]))
    msg = []
    for name, a, bref in pairs:
        if not bref.numel():
            continue
        a, bref = a.float(), bref.float()
        require(bool(torch.isfinite(a).all()), f"K3 {name} not finite ({what})")
        diff = (a - bref).abs() / max(bref.abs().max().item(), 1e-3)
        tol = 2 * gtol if name == "dW" else gtol
        bad = (diff > tol).float().mean().item()
        require(bad < 1e-3, f"K3 {name} disagrees ({what}): {bad}")
        msg.append(f"{name} {diff.max().item():.2e}")
    return ", ".join(msg) + f" (tol {gtol:g}, dW {2 * gtol:g}, bad fraction < 1e-3)"


# --- phase 3: kernels against their plain versions --------------------------


def check_segment_sum(dev, gen):
    from allset_tpu_torch.ops import _kernels, cuda_segment as cs

    for dtype in (torch.float32, torch.bfloat16):
        for W in (8, 264, 384, 4 * 264, 20 * 264):  # up to 20 runs folded
            counts = torch.randint(0, 7, (3000,), generator=gen)
            counts[torch.rand(3000, generator=gen) < 0.3] = 0  # empty segments
            counts[1234] = 100_000  # one huge segment
            indptr = torch.zeros(3001, dtype=torch.int32)
            indptr[1:] = torch.cumsum(counts, 0)
            n = int(indptr[-1])
            msgs = torch.randn(n + 37, W, generator=gen).to(dtype)
            msgs[n:] = float("nan")  # padded tail: must never be read
            msgs, indptr = msgs.to(dev), indptr.to(dev)
            got = cs.segment_sum_cuda(msgs, indptr, 3000)
            want = cs.segment_sum_plain(msgs, indptr, 3000)
            torch.cuda.synchronize()
            err, rel = scaled_err(got, want)
            tol = TOL[dtype][0]
            log(f"  K1 segment_sum {str(dtype)[6:]:8s} W={W:4d}: max_abs_err={err:.3e} "
                f"scaled={rel:.3e} (tol {tol:g})")
            require(rel <= tol, f"K1 disagrees ({dtype}, W={W})")
    _kernels.reset_launches()


def epi_inputs(M, HC, H, WP, L, dtype, dev, gen, floor_rows=True):
    r = lambda *s: torch.randn(*s, generator=gen)
    den = torch.rand(M, H, generator=gen) * 2.7 + 0.3
    agg = torch.cat([r(M, HC), den, torch.zeros(M, WP - HC - H)], 1)
    if floor_rows:  # empty segments: the 1e-16 floor and masked dden
        agg[:: 97, : HC + H] = 0.0
    params = [0.1 * r(HC), 1 + 0.1 * r(HC), 0.1 * r(HC), 0.05 * r(L, HC, HC),
              0.1 * r(L, HC), 1 + 0.1 * r(HC), 0.1 * r(HC)]
    gy = r(M, HC)
    agg, gy, params = agg.to(dtype).to(dev), gy.to(dtype).to(dev), [p.to(dev) for p in params]
    return agg, relu_safe(agg, gy, params, H), params


def relu_safe(agg, gy, params, H, margin=1e-4):
    """gy with the rows zeroed whose relu arguments (the rFF outputs and
    the output y) lie within ``margin`` of 0. There the derivative jumps,
    and the kernel and the plain version, which round their products in
    another order, may take opposite sides: one such element changes a
    whole row of dp and so every element of dW. A zero upstream gradient
    makes those rows' masks irrelevant; 5% (L=1) to 9% (L=2) of phase 3's
    rows go."""
    from allset_tpu_torch.ops import cuda_pma as cp

    rec = cp._fwd_recompute(agg, *params, H)
    near = (rec["y"].abs() < margin).any(dim=1)
    for p in rec["pres"]:
        near |= (p.abs() < margin).any(dim=1)
    return gy.masked_fill(near[:, None], 0)


def check_epilogue(dev, gen):
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    HC, H, WP = 256, 8, 264
    for dtype in (torch.float32, torch.bfloat16):
        for L in (1, 2):
            for relu in (False, True):
                M = 1000  # not a multiple of the 16-row tile
                agg, gy, p = epi_inputs(M, HC, H, WP, L, dtype, dev, gen)
                seed, g0, b0, W, b, g1, b1 = p
                y = cp.epilogue_fwd_cuda(agg, seed, g0, b0, W, b, g1, b1, H, relu)
                y_ref = cp.epilogue_fwd_plain(agg, seed, g0, b0, W, b, g1, b1, H, relu)
                got = cp.epilogue_bwd_cuda(agg, gy, seed, g0, b0, W, b, g1, b1, H, relu)
                want = cp.epilogue_bwd_plain(agg, gy, seed, g0, b0, W, b, g1, b1, H, relu)
                torch.cuda.synchronize()
                err, rel = scaled_err(y, y_ref)
                ftol = EPI_FWD_TOL[dtype]
                require(rel <= ftol, f"K2 disagrees ({dtype}, L={L}, relu={relu})")
                msg = check_bwd(got, want, TOL[dtype][1], f"{dtype}, L={L}, relu={relu}")
                log(f"  K2/K3 {str(dtype)[6:]:8s} L={L} relu={int(relu)}: fwd max_abs_err={err:.3e} "
                    f"scaled={rel:.3e} (tol {ftol:g}); bwd scaled max {msg}")
    _kernels.reset_launches()


def runs_inputs(M, HC, H, WP, L, R, dtype, dev, gen, floor_rows=True):
    """R runs of epi_inputs folded: agg [M, R*WP], gy [M, R*HC], params
    with a leading [R] axis."""
    per = [epi_inputs(M, HC, H, WP, L, dtype, dev, gen, floor_rows) for _ in range(R)]
    agg = torch.cat([a for a, _, _ in per], 1)
    gy = torch.cat([g for _, g, _ in per], 1)
    params = [torch.stack(ps) for ps in zip(*(p for _, _, p in per))]
    return agg, gy, params


def check_runs_epilogue(dev, gen):
    """K2R/K3R against their plain versions (phase 3's tolerances) and, run
    by run, bit for bit against K2/K3 launched on the run's slice."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    HC, H, WP, M = 256, 8, 264, 1000  # M not a multiple of the 16-row tile
    for dtype in (torch.float32, torch.bfloat16):
        for R in (2, 5):
            for L in (1, 2):
                for relu in (False, True):
                    agg, gy, p = runs_inputs(M, HC, H, WP, L, R, dtype, dev, gen)
                    y = cp.epilogue_fwd_runs_cuda(agg, *p, H, relu)
                    y_ref = cp.epilogue_fwd_runs_plain(agg, *p, H, relu)
                    got = cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, relu)
                    want = cp.epilogue_bwd_runs_plain(agg, gy, *p, H, relu)
                    what = f"{dtype}, R={R}, L={L}, relu={relu}"
                    err, rel = scaled_err(y, y_ref)
                    require(rel <= EPI_FWD_TOL[dtype], f"K2R disagrees ({what})")
                    msg = check_bwd(got, want, TOL[dtype][1], what)
                    for r in range(R):
                        a = agg[:, r * WP:(r + 1) * WP].contiguous()
                        g = gy[:, r * HC:(r + 1) * HC].contiguous()
                        q = [t[r] for t in p]
                        y1 = cp.epilogue_fwd_cuda(a, *q, H, relu)
                        d1 = cp.epilogue_bwd_cuda(a, g, *q, H, relu)
                        require(torch.equal(y[:, r * HC:(r + 1) * HC], y1),
                                f"K2R run {r} differs from K2 on its slice ({what})")
                        require(torch.equal(got[0][:, r * WP:(r + 1) * WP], d1[0])
                                and torch.equal(got[1][r], d1[1])
                                and torch.equal(got[2][r], d1[2]),
                                f"K3R run {r} differs from K3 on its slice ({what})")
                    log(f"  K2R/K3R {str(dtype)[6:]:8s} R={R} L={L} relu={int(relu)}: fwd "
                        f"max_abs_err={err:.3e} scaled={rel:.3e}; bwd scaled max {msg}; "
                        f"every run bit-identical to K2/K3 on its slice")
    _kernels.reset_launches()


def time_main_shapes(batch, dev, gen):
    """Kernel and plain times at the main path's shapes (bf16): K1 on the
    two reduce orders of the real incidence at the packed width, K2/K3 at
    the two half-layers' row counts. Times are summed over one training
    step's launches (K1: 4, K2: 2, K3: 2). Each kernel is held to its
    plain version with phase 3's tolerances; the reported max_abs_err is
    K1's and K2's output and K3's dagg. No row sits at the 1e-16 floor
    here, as none does on the main path."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp, cuda_segment as cs

    inc = batch.inc.real
    HC, H, WP, L = 256, 8, 264, 2
    out = {}
    t_k = t_p = 0.0
    err = 0.0
    for indptr, nseg in ((inc.edge_indptr, inc.num_edges), (inc.node_indptr, batch.inc.num_nodes)):
        msgs = torch.randn(inc.nnz, WP, device=dev, dtype=torch.bfloat16)
        k = cuda_ms(lambda: cs.segment_sum_cuda(msgs, indptr, nseg))
        p = cuda_ms(lambda: cs.segment_sum_plain(msgs, indptr, nseg))
        e, rel = scaled_err(cs.segment_sum_cuda(msgs, indptr, nseg),
                            cs.segment_sum_plain(msgs, indptr, nseg))
        require(rel <= TOL[torch.bfloat16][0], f"K1 disagrees at main shapes: {rel}")
        err = max(err, e)
        t_k, t_p = t_k + 2 * k, t_p + 2 * p
        counts = (indptr[1:] - indptr[:-1]).float()
        log(f"  K1 at [{inc.nnz}, {WP}] -> {nseg} segments: kernel {k:.3f} ms, plain {p:.3f} ms; "
            f"max_abs_err {e:.3e} (scaled {rel:.2e}); segment length mean "
            f"{counts.mean().item():.2f}, max {int(counts.max().item())}")
    out["segment_sum"] = (t_k, t_p, err)
    tf = tb = pf = pb = 0.0
    errf = errb = 0.0
    for M in (inc.num_edges + batch.inc.num_nodes, batch.inc.num_nodes):
        agg, gy, p = epi_inputs(M, HC, H, WP, L, torch.bfloat16, dev, gen, floor_rows=False)
        args = (agg, *p)
        kf = cuda_ms(lambda: cp.epilogue_fwd_cuda(*args, H, True))
        pf_ = cuda_ms(lambda: cp.epilogue_fwd_plain(*args, H, True))
        kb = cuda_ms(lambda: cp.epilogue_bwd_cuda(agg, gy, *p, H, True))
        pb_ = cuda_ms(lambda: cp.epilogue_bwd_plain(agg, gy, *p, H, True))
        ef, rf = scaled_err(cp.epilogue_fwd_cuda(*args, H, True),
                            cp.epilogue_fwd_plain(*args, H, True))
        require(rf <= EPI_FWD_TOL[torch.bfloat16], f"K2 disagrees at M={M}: {rf}")
        got = cp.epilogue_bwd_cuda(agg, gy, *p, H, True)
        want = cp.epilogue_bwd_plain(agg, gy, *p, H, True)
        bmsg = check_bwd(got, want, TOL[torch.bfloat16][1], f"M={M}")
        eb, rb = scaled_err(got[0], want[0])
        errf, errb = max(errf, ef), max(errb, eb)
        tf, pf, tb, pb = tf + kf, pf + pf_, tb + kb, pb + pb_
        log(f"  K2 at M={M}: kernel {kf:.3f} ms, plain {pf_:.3f} ms, max_abs_err {ef:.3e} "
            f"(scaled {rf:.2e}); K3: kernel {kb:.3f} ms, plain {pb_:.3f} ms, dagg "
            f"max_abs_err {eb:.3e}; scaled max {bmsg}")
    out["pma_epilogue_fwd"] = (tf, pf, errf)
    out["pma_epilogue_bwd"] = (tb, pb, errb)
    _kernels.reset_launches()
    return out


# --- phases 4 and 5: the training step --------------------------------------


def bench_batch(dev):
    from allset_tpu_torch.data import scale_free_hypergraph
    from allset_tpu_torch.graph import Batch, add_self_loops, norm_construction

    hd = scale_free_hypergraph(num_nodes=131072, num_hyperedges=65536,
                               avg_edge_size=12, feature_dim=256, seed=0)
    hd = norm_construction(add_self_loops(hd), "all_one")
    return Batch.from_hyperdata(hd, device=dev, bucket=1024)


def bench_model(seed: int):
    from allset_tpu_torch.models import SetGNN, SetGNNConfig

    cfg = SetGNNConfig(
        num_features=256, num_classes=8, all_num_layers=1, mlp_hidden=256,
        classifier_num_layers=1, heads=8, dropout=0.0,
        dtype="bfloat16",
    )
    return SetGNN(cfg, torch.Generator().manual_seed(seed))


def run_steps(model, batch, mask, steps):
    """steps Adam steps, each timed on the host clock to a synchronize."""
    from allset_tpu_torch.train import train_steps

    opt = torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=0.0)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(train_steps(model, batch, mask, 1, optimizer=opt))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return torch.cat(losses), times


def main_path(batch, dev, card):
    from allset_tpu_torch.ops import _kernels

    steps = 8
    mask = torch.arange(batch.num_nodes, device=dev) % 2 == 0
    model = bench_model(0).to(dev)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    # warm-up on a throwaway copy: first-call allocations, cuBLAS handles
    warm = bench_model(0).to(dev)
    run_steps(warm, batch, mask, 1)
    del warm
    _kernels.reset_launches()
    losses, times = run_steps(model, batch, mask, steps)
    counts = dict(_kernels.launches)
    log(f"  launches over {steps} steps: {counts}")
    per_step = {"segment_sum": 4, "pma_epilogue_fwd": 2, "pma_epilogue_bwd": 2}
    for k, n in per_step.items():
        require(counts[k] == n * steps, f"{k}: {counts[k]} launches, expected {n * steps}")
    lo = losses.cpu()
    log(f"  losses: {[round(v, 6) for v in lo.tolist()]}")
    require(bool(torch.isfinite(lo).all()), "non-finite loss")
    require(lo[-1] < lo[0], "loss did not fall")
    model2 = bench_model(1).to(dev)
    model2.load_state_dict(state)
    losses2, _ = run_steps(model2, batch, mask, steps)
    require(torch.equal(losses, losses2), "two runs from one state differ")
    log("  two runs from one state: bit-identical losses")
    ms = statistics.median(times) * 1e3
    nnz = batch.inc.nnz
    log(f"  nnz {nnz}; median step {ms:.3f} ms; {nnz / (ms / 1e3):,.0f} edges/s "
        f"[{card}] (smoke, not a benchmark)")
    return counts, ms


def walmart_batch(dev):
    """The runs protocol's graph, prepared as the CLI prepares it."""
    from allset_tpu_torch.data import load_dataset
    from allset_tpu_torch.train.factory import ExperimentConfig, prepare

    data = load_dataset(WALMART, feature_noise=1.0, seed=0)
    return prepare(ExperimentConfig(dname=WALMART), data, dev)[1]


def time_runs_shapes(batch, dev, gen, R=20):
    """Kernel and plain times at the runs path's shapes (walmart preset,
    f32, R runs folded): K1 on the two reduce orders at width R*264 (an
    epoch launches it 3 times on each: train forward and backward, eval
    forward), K2R at the two half-layers' row counts (twice each per
    epoch: train and eval), K3R once each. Summed per epoch; each kernel
    held to its plain version with phase 3's tolerances."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp, cuda_segment as cs

    inc = batch.inc.real
    HC, H, WP, L, dt = 256, 8, 264, 2, torch.float32
    out = {}
    t_k = t_p = err = 0.0
    for indptr, nseg in ((inc.edge_indptr, inc.num_edges), (inc.node_indptr, batch.num_nodes)):
        msgs = torch.randn(inc.nnz, R * WP, device=dev, dtype=dt)
        k = cuda_ms(lambda: cs.segment_sum_cuda(msgs, indptr, nseg), iters=5)
        p = cuda_ms(lambda: cs.segment_sum_plain(msgs, indptr, nseg), iters=3)
        e, rel = scaled_err(cs.segment_sum_cuda(msgs, indptr, nseg),
                            cs.segment_sum_plain(msgs, indptr, nseg))
        require(rel <= TOL[dt][0], f"K1 disagrees at the runs shapes: {rel}")
        err = max(err, e)
        t_k, t_p = t_k + 3 * k, t_p + 3 * p
        counts = (indptr[1:] - indptr[:-1]).float()
        log(f"  K1 at [{inc.nnz}, {R * WP}] -> {nseg} segments: kernel {k:.3f} ms, plain "
            f"{p:.3f} ms; max_abs_err {e:.3e} (scaled {rel:.2e}); segment length max "
            f"{int(counts.max().item())}")
        del msgs
    out["segment_sum"] = (t_k, t_p, err)
    tf = tb = pf = pb = errf = errb = 0.0
    for M in (inc.num_edges + batch.num_nodes, batch.num_nodes):
        agg, gy, p = runs_inputs(M, HC, H, WP, L, R, dt, dev, gen, floor_rows=False)
        kf = cuda_ms(lambda: cp.epilogue_fwd_runs_cuda(agg, *p, H, True), iters=3)
        pf_ = cuda_ms(lambda: cp.epilogue_fwd_runs_plain(agg, *p, H, True), iters=2)
        kb = cuda_ms(lambda: cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, True), iters=3)
        pb_ = cuda_ms(lambda: cp.epilogue_bwd_runs_plain(agg, gy, *p, H, True), iters=2)
        ef, rf = scaled_err(cp.epilogue_fwd_runs_cuda(agg, *p, H, True),
                            cp.epilogue_fwd_runs_plain(agg, *p, H, True))
        require(rf <= EPI_FWD_TOL[dt], f"K2R disagrees at M={M}: {rf}")
        got = cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, True)
        want = cp.epilogue_bwd_runs_plain(agg, gy, *p, H, True)
        bmsg = check_bwd(got, want, TOL[dt][1], f"runs M={M}")
        eb, _ = scaled_err(got[0], want[0])
        del got, want
        errf, errb = max(errf, ef), max(errb, eb)
        tf, pf, tb, pb = tf + 2 * kf, pf + 2 * pf_, tb + kb, pb + pb_
        log(f"  K2R at M={M}, R={R}: kernel {kf:.3f} ms, plain {pf_:.3f} ms, max_abs_err "
            f"{ef:.3e} (scaled {rf:.2e}); K3R: kernel {kb:.3f} ms, plain {pb_:.3f} ms, dagg "
            f"max_abs_err {eb:.3e}; scaled max {bmsg}")
    out["pma_epilogue_fwd_runs"] = (tf, pf, errf)
    out["pma_epilogue_bwd_runs"] = (tb, pb, errb)
    _kernels.reset_launches()
    return out


PER_GROUP_EPOCH = {"segment_sum": 6, "pma_epilogue_fwd_runs": 4, "pma_epilogue_bwd_runs": 2,
                   "pma_epilogue_fwd": 0, "pma_epilogue_bwd": 0}


def cli_run(argv, epochs):
    """One CLI run with every launch count set to 0 just before; returns
    the Results and the counts of that run, checked per group and epoch."""
    from allset_tpu_torch import cli
    from allset_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    res = cli.run(argv)
    torch.cuda.synchronize()
    counts = dict(_kernels.launches)
    n = len(res.groups) * epochs
    per = {k: counts[k] / n for k in PER_GROUP_EPOCH}
    require(per == PER_GROUP_EPOCH, f"launches per group and epoch {per}, expected "
            f"{PER_GROUP_EPOCH} (groups {res.groups})")
    require(bool(math.isfinite(res.metrics.sum())), "non-finite metrics")
    return res, counts


def runs_protocol(card, tmp):
    base = ["--dname", WALMART, "--preset", "--dtype", "float32", "--device", "cuda",
            "--res_root", tmp]
    epochs = 4
    res, counts = cli_run(base + ["--epochs", str(epochs)], epochs)
    loss = res.metrics[:, :, 3].mean(axis=0)
    log(f"  {res.metrics.shape[0]} runs in groups {res.groups}; launches {counts} "
        f"(per group and epoch {PER_GROUP_EPOCH})")
    log(f"  mean training loss per epoch {[round(float(v), 6) for v in loss]}")
    require(loss[-1] < loss[0], "training loss did not fall")
    with open(os.path.join(tmp, f"{WALMART}_noise_1.csv")) as f:
        log(f"  CSV: {f.read().splitlines()[-1]}")
    per_epoch = res.wall_time / epochs
    log(f"  20-run protocol: {per_epoch * 1e3:.1f} ms per epoch over {epochs} epochs "
        f"(first epoch included) [{card}]")
    short = base + ["--runs", "2", "--epochs", "3"]
    folded, _ = cli_run(short, 3)
    seq, _ = cli_run(short + ["--no_vmap_runs"], 3)
    require(folded.groups == [2] and seq.groups == [1, 1], "2-run groups")
    import numpy as np

    require(np.array_equal(folded.metrics[..., :3], seq.metrics[..., :3]),
            "folded and sequential accuracies differ")
    rel = np.abs(folded.metrics[..., 3:] - seq.metrics[..., 3:]) / np.abs(seq.metrics[..., 3:])
    require(rel.max() <= 2e-3, f"folded and sequential losses differ: {rel.max()}")
    log(f"  2 runs x 3 epochs folded vs one by one: equal accuracies, losses within "
        f"{rel.max():.2e} (rtol 2e-3)")
    return counts, per_epoch


def band_replay(card, tmp, runs=5):
    """The walmart preset's 5-run x 500-epoch replay against BANDS.json."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "BANDS.json")) as f:
        band = json.load(f)[f"{WALMART}/AllSetTransformer"]
    std, n = band["final_test_std"], band["runs"]
    # scripts/record_bands.py::band_tolerance
    tol = max(2.0 * std * math.sqrt(1 / runs + 1 / n) + std, 1.0)
    t0 = time.perf_counter()
    res, _ = cli_run(["--dname", WALMART, "--preset", "--dtype", "float32", "--device",
                      "cuda", "--runs", str(runs), "--epochs", str(band["epochs"]),
                      "--res_root", tmp], band["epochs"])
    wall = time.perf_counter() - t0
    mean, sd = res.best_by_valid()["final_test"]
    log(f"  {runs} runs x {band['epochs']} epochs: final test {mean:.3f} ± {sd:.3f} "
        f"against the band {band['final_test_mean']} (tol {tol:.3f}); {wall:.1f} s, "
        f"{res.wall_time / band['epochs'] * 1e3:.1f} ms per epoch [{card}]")
    require(abs(mean - band["final_test_mean"]) <= tol, "outside the accuracy band")


def small_parity(dev):
    """One f32 step through the kernels (card) against one through the
    plain versions (CPU), from the same parameters."""
    from allset_tpu_torch.data import synthetic_hypergraph
    from allset_tpu_torch.graph import Batch, add_self_loops, norm_construction
    from allset_tpu_torch.models import SetGNN, SetGNNConfig
    from allset_tpu_torch.train import masked_nll

    hd = synthetic_hypergraph(num_nodes=3000, num_hyperedges=1500,
                              feature_dim=64, seed=3)
    hd = norm_construction(add_self_loops(hd), "all_one")
    cfg = SetGNNConfig(num_features=64, num_classes=4, all_num_layers=1,
                       mlp_hidden=128, classifier_num_layers=1, heads=4,
                       dropout=0.0)
    out = {}
    for device in ("cpu", dev):
        model = SetGNN(cfg, torch.Generator().manual_seed(5)).to(device)
        batch = Batch.from_hyperdata(hd, device=device)
        mask = torch.arange(batch.num_nodes, device=device) % 2 == 0
        loss = masked_nll(model(batch, False), batch.y, mask)
        loss.backward()
        out[str(device)] = (loss.item(),
                            {k: p.grad.cpu() for k, p in model.named_parameters()})
    (l_ref, g_ref), (l_k, g_k) = out["cpu"], out[str(dev)]
    rel = abs(l_k - l_ref) / abs(l_ref)
    log(f"  small f32 step: loss kernel {l_k:.7f} plain {l_ref:.7f} rel {rel:.2e} (tol 1e-5)")
    require(rel <= 1e-5, "small-graph loss disagrees")
    worst = 0.0
    for k in g_ref:
        scale = max(g_ref[k].abs().max().item(), 1e-6)
        e = (g_k[k] - g_ref[k]).abs().max().item() / scale
        worst = max(worst, e)
        require(e <= 1e-3, f"gradient {k} disagrees: {e}")
    log(f"  small f32 step: worst scaled gradient error {worst:.2e} (tol 1e-3)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import allset_tpu_torch  # noqa: F401  (the port; imports no jax)
    from allset_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    log("phase 2: build")
    _kernels.build(force=True)
    _kernels.lib()
    log(f"  nvcc build {_kernels.build_seconds:.1f} s into {_kernels.BUILD_DIR}")

    gen = torch.Generator().manual_seed(0)
    log("phase 3: kernels against their plain versions")
    check_segment_sum(dev, gen)
    check_epilogue(dev, gen)
    check_runs_epilogue(dev, gen)

    log("phase 4: main path at bench size (bf16)")
    t0 = time.perf_counter()
    batch = bench_batch(dev)
    log(f"  graph built in {time.perf_counter() - t0:.1f} s: nodes {batch.num_nodes}, "
        f"nnz {batch.inc.nnz}, real edges {batch.inc.real.num_edges}")
    timings = time_main_shapes(batch, dev, gen)
    counts, _ = main_path(batch, dev, card)
    require("jax" not in sys.modules, "the port loaded jax")

    log("phase 5: small f32 graph, kernels against plain")
    small_parity(dev)

    del batch
    torch.cuda.empty_cache()
    log("phase 6: the runs protocol through the CLI (synthetic-walmart preset, f32)")
    t0 = time.perf_counter()
    wb = walmart_batch(dev)
    log(f"  graph built in {time.perf_counter() - t0:.1f} s: nodes {wb.num_nodes}, "
        f"nnz {wb.inc.real.nnz}, real edges {wb.inc.real.num_edges}")
    timings.update(time_runs_shapes(wb, dev, gen))
    del wb
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        runs_counts, _ = runs_protocol(card, tmp)
        require("jax" not in sys.modules, "the port loaded jax")
        log("phase 7: the accuracy band (5 runs x 500 epochs)")
        band_replay(card, tmp)

    sources = {  # name -> (source, TPU kernel replaced, launches of its path)
        "segment_sum": ("allset_tpu_torch/csrc/segment_sum.cu",
                        "allset_tpu/ops/pallas_segment.py:39", runs_counts),
        "pma_epilogue_fwd": ("allset_tpu_torch/csrc/pma_epilogue.cu",
                             "allset_tpu/ops/pallas_pma.py:170", counts),
        "pma_epilogue_bwd": ("allset_tpu_torch/csrc/pma_epilogue.cu",
                             "allset_tpu/ops/pallas_pma.py:185", counts),
        "pma_epilogue_fwd_runs": ("allset_tpu_torch/csrc/pma_epilogue.cu",
                                  "allset_tpu/ops/pallas_pma.py:365", runs_counts),
        "pma_epilogue_bwd_runs": ("allset_tpu_torch/csrc/pma_epilogue.cu",
                                  "allset_tpu/ops/pallas_pma.py:424", runs_counts),
    }
    kernels = []
    for name, (src, rep, cnt) in sources.items():
        ms, plain_ms, err = timings[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": cnt[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
