"""Build and run the PyTorch port on one CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
  2. build the CUDA kernels from allset_tpu_torch/csrc (nvcc, sm_90a);
  3. compare each kernel with its plain PyTorch version on the card, in
     f32 and bf16: K1 segment_sum (empty segments, one huge segment,
     unread padded tail rows), K2/K3 the PMA epilogue (L in {1, 2}, relu
     on/off, rows not a multiple of the tile) and at the main path's
     shapes, with the kernel and plain times;
  4. the main path at the benchmark's size and width (bf16): the
     AllSetTransformer training step on scale_free_hypergraph(131072
     nodes, 65536 edges, edge size 12, 256 features), 8 Adam steps:
     the loss is finite and falls, each step launches K1 4 times and
     K2, K3 twice, and two runs from one state give identical losses;
  5. a small f32 graph: one step through the kernels against one step
     of the plain versions (on the CPU) from the same parameters.
The line before the last is a JSON object of per-kernel results; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

TOL = {  # (forward, gradient) tolerance, scaled by the reference's max |.|
    torch.float32: (1e-4, 1e-4),
    torch.bfloat16: (1e-2, 6e-2),
}
EPI_FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


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
        for W in (8, 264, 384):
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
            log(f"  K1 segment_sum {str(dtype)[6:]:8s} W={W:3d}: max_abs_err={err:.3e} "
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
    return agg.to(dtype).to(dev), gy.to(dtype).to(dev), [p.to(dev) for p in params]


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

    sources = {
        "segment_sum": ("allset_tpu_torch/csrc/segment_sum.cu", "allset_tpu/ops/pallas_segment.py:39"),
        "pma_epilogue_fwd": ("allset_tpu_torch/csrc/pma_epilogue.cu", "allset_tpu/ops/pallas_pma.py:170"),
        "pma_epilogue_bwd": ("allset_tpu_torch/csrc/pma_epilogue.cu", "allset_tpu/ops/pallas_pma.py:185"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        ms, plain_ms, err = timings[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": counts[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
