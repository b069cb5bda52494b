"""Build and run the PyTorch port on one CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
  2. build the CUDA kernels from allset_tpu_torch/csrc (nvcc, sm_90a);
  3. compare each kernel with its plain PyTorch version on the card, in
     f32 and bf16: K1 segment_sum (empty segments, one huge segment over
     1,563 chunks, unread padded tail rows; widths up to 20 runs x 264;
     bit for bit against the plain version in the kernel's order of
     additions, and at 4 and 20 runs x 264 run by run against launches
     on each run's slice), K2/K3 the PMA epilogue (HC in {64, 128, 192,
     256, 384, 512} and, through the wide pair, 640, 768 and 1024; heads
     1 to HC, rows below one tile (64 rows, 32 above HC 256, 16 above 512)
     and not a multiple of it; the widest the wide pair takes, 1536 with 2
     layers in f32 and 2048 with 1 layer in bf16) and K2R/K3R its runs
     grids (HC 256, 512, 640, 768 and 1024, R in {2, 5}; L in {1, 2},
     relu on/off; the widest two at R=2; each run of K2R/K3R also bit for
     bit against a K2/K3 launch on its slice), K4/K5
     the PMA score+pack ((HC, H) in {(256, 8), (64, 1), (128, 4), (512,
     8)}, rows not a multiple of the tile; gmax bit-equal, w within 2 f32
     / 1 bf16 ulps, a NaN score reaching gmax, R in {2, 5} bit for bit
     against single launches), B12/B13 the LayerNorm (f32, bf16, f32 ->
     bf16; F in {7, 64, 256, 512}, rows not a multiple of the 64-row
     block; R in {2, 5} and an input shared by the runs, each run bit for
     bit against a launch on it alone), the epilogue's route by shape (an
     rFF of 3 layers and HC 96, which the JAX package composes too, on the
     plain version with no launch; HC 256, 512, 640 and 1024 on K2/K3 and
     K2R/K3R; HC 2048 in f32, whose JAX kernel exceeds its VMEM cap,
     raises before any launch), B10 the row gather (bit for bit: f32 and
     bf16, widths 1, 8, 256, 264, 5,280 and 20 x 264, int32 and int64 ids,
     clamped ids, narrow rows on an unaligned view), B9 the sorted gather
     (bit for bit: f32 and bf16 rows of 2 B to 1 KiB, sorted ids with
     gaps, a hub run of 10,000 equal ids and ids past both ends, the same
     ids unsorted, int32 and int64), the gather inside K1
     (segment_sum_gather, B11's port: bit for bit against B10 + the scale
     + K1 and against its plain version in its order; f32 and bf16, W 8,
     264, 384 and 20 x 264, no norm, a per-entry norm and a [20, k] runs
     norm, empty segments, a 50,000-entry hub, ids with gaps and clamped;
     W 13 through the padding wrapper; the identity CSR against
     index_select), the one-hot family (segsum_onehot: B1, B2 at nbuf 2,
     3, 4, 6, B3 at nacc 1, 2, 4, B4's builds A, B, C, B6's seven modes;
     f32 and bf16 within 1e-5 of the plain versions, rows not a multiple of
     the chunk, segments padded to the block, msgs with and without the
     spare chunk), the streaming probes (B5 stream_flat, B7 stream_dual,
     B8 stream_fold with both bodies, within 1e-5), and at the main
     paths' shapes (the gather inside K1 on _Spmm's passes of a bench step
     and a 20-run epoch, bit for bit against B10 + K1; K1 and B10 at a
     UniGAT step's sums and gathers, K1 bit for bit to its order; K3R at
     R=20 on the walmart rows, each run bit for bit against K3; B12/B13 at
     the AllDeepSets step's [131072, 256] and [196608, 256] bf16 launches
     and at an AllDeepSets 20-run epoch's; B9 at a CEGAT step's, against
     B10 as well), with the kernel, plain and library times and the
     kernel's bound;
  3b. each experiment of allset_tpu_torch.experiments (the TPU round's
     B1-B8 and B11 scripts) through its main at its script's shapes, with
     every launch count set to 0 just before: B1, B2, B3 and B6 on the
     bench graph's node side, B4, B5, B7, B8 (both bodies), B11 with B10,
     B9 and index_select on the identity CSR and _Spmm's passes, the gather
     inside K1 against B10 + K1 in alternating pairs (the route's
     measurement); each new kernel must launch, each held to its plain
     version;
  4. the benchmark step at its size and width (bf16): the
     AllSetTransformer training step on scale_free_hypergraph(131072
     nodes, 65536 edges, edge size 12, 256 features), 8 Adam steps, as
     the bench step, with GPR and with LearnMask (the unsplit exchange
     over all 582,248 entries), and the AllDeepSets step on the same
     graph, also with LearnMask: the loss is finite and falls, each step
     launches the gather inside K1 4 times (_Spmm's passes; no B10 and no
     K1) and K2, K3, K4, K5 twice (AllDeepSets: the gather inside K1 4 and
     B12, B13 8 times; GPR adds one B12 and one B13 for gpr_mlp), the
     bench step from the same state through the pair the gather inside K1
     replaced (B10 + K1) gives bit-identical losses, and two runs from
     one state give identical losses; the bench step also at hidden 384,
     512 and 1024 (K2/K3 at those widths, timed at its shapes too); then
     the conv zoo on the same graph (2 layers, hidden 256, bf16): HCHA,
     HGNN, HNHN, UniGCNII, MLP and UniGNN with each of its five convs
     (UniGAT at 8 heads of 32; UniGIN and UniSAGE with --UniGNN_use_norm,
     see ZOO), 8 steps each with the same checks and launch counts as the
     code predicts (zoo_launches), the step time and edges/s; CEGCN
     (hidden 256), CEGAT (8 heads of 32) on the bench graph's clique
     expansion (279,962 entries with the self-loops) and HyperGCN (its
     Laplacian with mediators, built once on the host), 8 steps each with
     the same checks (CEGAT's sorted narrow gathers on B9); 2 steps of
     HyperGCN's reapprox path (f32), its host build time per step;
  5. a small f32 graph, as the bench step, with GPR, with LearnMask,
     AllDeepSets with and without LearnMask, and each zoo model (UniGIN
     and UniSAGE also without the norm; CEGCN, CEGAT, HyperGCN): one step
     through the kernels against one step of the plain versions (on the
     CPU) from the same parameters, on a loss without the nodes a relu,
     ELU or leaky_relu argument within rounding of 0 reaches;
  6. the runs protocol through the CLI (allset_tpu_torch.cli) on
     synthetic-walmart with the tuned preset (hidden 256, 8 heads, f32):
     20 runs folded into each launch for a few
     epochs; per group and epoch 6 launches of the gather inside K1, 4
     K2R, 2 K3R, 4 K4 and 4 K5
     launches whatever the number of runs (and B12/B13 where a LayerNorm
     runs outside the epilogue: GPR's gpr_mlp, a 2-layer classifier);
     finite metrics, a falling training loss; 2 runs folded against 2
     runs one by one: equal accuracies, losses within rtol 2e-3; 20 runs
     x 2 epochs with --GPR, --LearnMask and --add_self_loop false, and one
     run of --exclude_self on synthetic; --MLP_hidden 512 (20 runs x 2
     epochs: 4 K2R and 2 K3R at HC 512 per group and epoch, timed at its
     shapes too; the peak per run against the trainer's estimate; 2
     folded against 2 one by one); --MLP_hidden 1024 (2 runs x 1 epoch
     through the wide pair, timed at its shapes); --method AllDeepSets
     with the same preset, 20 runs x 3 epochs (6 K1, 16 B12 and 8 B13 per
     group and epoch: 6 of the gather inside K1), then three warm runs of
     4 epochs, 20 runs x 2
     epochs with --LearnMask (the peak device memory per run of both
     against the trainer's estimate, which must not be lower) and 2
     folded against 2 one by one; one AllDeepSets epoch whose LayerNorm
     launches are recorded and timed; --MLP_num_layers 3 (2 runs x 2
     epochs) with the epilogue on its plain route (K2R/K3R never launch);
     the zoo without the preset (--MLP_hidden 256, f32, 20 runs x 2
     epochs): --method HGNN, HCHA, HNHN, UniGCNII, UniGNN (each of its
     five convs) and MLP, launches per group and epoch as predicted, finite
     metrics, each peak per run against the trainer's estimate, HCHA's 2
     runs folded against 2 one by one; --method CEGCN, CEGAT and HyperGCN
     the same way (CEGAT's routes by each group's folded width), CEGAT's 2
     runs folded against 2 one by one, and --HyperGCN_fast false on
     synthetic (2 runs x 2 epochs, each run on its own structures);
  7. the accuracy band: 5 runs x 500 epochs of the same preset; the mean
     final test accuracy within band_tolerance(std, 5, 20) of the 20-run
     band in BANDS.json (scripts/record_bands.py).
The line before the last is a JSON object of per-kernel results (K2R,
K3R from phase 6's run, the gather inside K1 ("segment_sum_gather"), K2,
K3, K4, K5 from phase 4's bench step and the gather inside K1 again,
"_epoch", per 20-run epoch from phase 6's run; B12, B13 from phase 4's
AllDeepSets step and again, "_epoch", per AllDeepSets 20-run epoch; K1
and B10 from phase 4's UniGAT step, B9 ("gather_sorted") from its CEGAT
step; K2 and K3 again at HC 384, 512 and 1024, K2R and K3R at 512 and
1024, "_hc...", from the bench steps and CLI runs at those widths; the
one-hot family ("segsum_onehot": B1; "_b2", "_b3", "_b4", "_b6": B2 at
nbuf 2, B3 at nacc 1, B4's build A, B6's full mode) and the streaming
probes (B5 "stream_flat", B7 "stream_dual", B8 "stream_fold", fold at
chunk 512) from phase 3b, with its launches): launches, the kernel's
time and its plain version's summed over a bench step or an epoch (phase
3b: one call at the script's shapes), the bound (the larger of the bytes
over 3.35 TB/s and the products over the tensor cores: bf16 at 989
TFLOP/s, f32 products at 3xTF32, 495 / 3 TFLOP/s, the one-hot family's
f32 at two TF32 products, 495 / 2; other arithmetic at 67 TFLOP/s) and
one library call's time where one computes the same function (K1 and the
B1 family: torch.segment_reduce; the gather inside K1: index_select then
torch.segment_reduce; B12/B13: F.layer_norm and its autograd backward;
B10, B9: index_select; B5, B7, B8: a sum over a view); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
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


def rng(lo_hi) -> str:
    return f"[{lo_hi[0]:.4f}, {lo_hi[1]:.4f}]"


def cuda_ms_spread(fn, iters: int = 20, repeats: int = 5):
    """(median, lowest, highest) of ``repeats`` readings of cuda_ms(fn,
    iters)."""
    ms = [cuda_ms(fn, iters) for _ in range(repeats)]
    return statistics.median(ms), min(ms), max(ms)


def scaled_err(got, want):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return float("inf"), float("inf")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    return err, err / max(want.abs().max().item() if want.numel() else 0.0, 1.0)


HBM = 3.35e12  # H100 SXM bytes/s (NVIDIA data sheet)
PEAK = {"bf16": 989e12, "f32x3": 495e12 / 3, "f32": 67e12}  # FLOP/s


class Tally:
    """Times, error and bound of one kernel summed over the launches of a
    step or an epoch; the bound keeps its bytes and operations terms
    apart and takes the larger of the two sums."""

    def __init__(self):
        self.ms = self.plain_ms = self.err = self.t_bytes = self.t_ops = 0.0
        self.library_ms = None

    def add(self, n, ms, plain_ms, err, nbytes, ops, library_ms=None):
        """n launches of ms each; ops: [(flops, PEAK key)]."""
        self.ms += n * ms
        self.plain_ms += n * plain_ms
        self.err = max(self.err, err)
        self.t_bytes += n * nbytes / HBM * 1e3
        self.t_ops += n * sum(f / PEAK[k] for f, k in ops) * 1e3
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + n * library_ms

    def row(self):
        return {"ms": self.ms, "plain_ms": self.plain_ms, "max_abs_err": self.err,
                "bound_ms": max(self.t_bytes, self.t_ops),
                "bound_by": "bytes" if self.t_bytes >= self.t_ops else "operations",
                "library_ms": self.library_ms}


def epi_cost(M, HC, WP, L, dtype, bwd, R=1):
    """(bytes, ops) of K2 (bwd=False) or K3 on M rows and R runs: agg in,
    y out (K2) or agg and gy in, dagg out (K3), the parameters; the rFF
    products (K3: the forward's, dp @ W^T and h^T dp)."""
    item = 2 if dtype == torch.bfloat16 else 4
    rows = M * ((2 * WP + HC) if bwd else (WP + HC)) * item
    params = L * HC * HC * (4 + (2 if item == 2 else 0)) + (6 + L) * HC * 4
    fwd = 2 * L * HC * HC * M * R
    ops = [(fwd, "bf16" if item == 2 else "f32x3")]
    if bwd:
        ops.append((2 * fwd, "f32x3"))
    return R * (rows + params), ops


def seg_cost(nnz, nseg, W, dtype):
    """(bytes, ops) of K1: every message row in once, every segment row out
    once, indptr; one f32 add per message element."""
    item = 2 if dtype == torch.bfloat16 else 4
    return (nnz + nseg) * W * item + 4 * (nseg + 1), [(nnz * W, "f32")]


def library_segment_sum(msgs, indptr, nseg):
    """One PyTorch call for K1's function, for its time only (the port
    never calls it): torch.segment_reduce; where the build refuses the
    dtype, index_add_ into an f32 buffer with ids computed beforehand.
    Returns (fn, name)."""
    try:
        want = torch.segment_reduce(msgs, "sum", offsets=indptr, axis=0)
        require(want.shape == (nseg, msgs.shape[1]), "segment_reduce shape")
        return (lambda: torch.segment_reduce(msgs, "sum", offsets=indptr, axis=0),
                "torch.segment_reduce")
    except (RuntimeError, NotImplementedError, AssertionError) as e:
        log(f"  torch.segment_reduce refused ({str(e).splitlines()[0][:80]}); index_add_ instead")
    counts = (indptr[1:] - indptr[:-1]).long()
    ids = torch.repeat_interleave(torch.arange(nseg, device=msgs.device), counts)

    def call():
        out = torch.zeros(nseg, msgs.shape[1], dtype=torch.float32, device=msgs.device)
        return out.index_add_(0, ids, msgs)
    return call, "index_add_ (f32 buffer)"


def ptxas_summary(text: str):
    """(kernel, registers, spill stores, spill loads) per compiled kernel
    from nvcc -Xptxas -v."""
    import re

    out, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    try:
        names = subprocess.run(["c++filt"], input="\n".join(o[0] for o in out),
                               capture_output=True, text=True, check=True).stdout.split("\n")
        out = [(n[:110], *o[1:]) for n, o in zip(names, out)]
    except (OSError, subprocess.CalledProcessError):
        pass
    return out


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
    """K1 against its plain version (tolerance) and against the plain
    version in the kernel's order of additions (bit for bit); the folded
    widths run by run against launches on each run's slice."""
    from allset_tpu_torch.graph.incidence import chunk_plan
    from allset_tpu_torch.ops import _kernels, cuda_segment as cs

    for dtype in (torch.float32, torch.bfloat16):
        for W in (8, 264, 384, 4 * 264, 20 * 264):  # up to 20 runs folded
            counts = torch.randint(0, 7, (3000,), generator=gen)
            counts[torch.rand(3000, generator=gen) < 0.3] = 0  # empty segments
            counts[1234] = 100_000  # one huge segment, over 1,563 chunks
            indptr = torch.zeros(3001, dtype=torch.int32)
            indptr[1:] = torch.cumsum(counts, 0)
            n = int(indptr[-1])
            plan = chunk_plan(indptr.numpy()).to(dev)
            msgs = torch.randn(n + 37, W, generator=gen).to(dtype)
            msgs[n:] = float("nan")  # padded tail: must never be read
            msgs, indptr = msgs.to(dev), indptr.to(dev)
            got = cs.segment_sum_cuda(msgs, indptr, 3000, plan)
            want = cs.segment_sum_plain(msgs, indptr, 3000)
            ordered = cs.segment_sum_planned(msgs, indptr, 3000, plan)
            torch.cuda.synchronize()
            err, rel = scaled_err(got, want)
            tol = TOL[dtype][0]
            require(rel <= tol, f"K1 disagrees ({dtype}, W={W})")
            require(torch.equal(got, ordered), f"K1 differs from its order of additions "
                    f"({dtype}, W={W})")
            runs = ""
            if W % 264 == 0 and W > 264:
                for r in range(W // 264):
                    one = cs.segment_sum_cuda(msgs[:, r * 264:(r + 1) * 264].contiguous(),
                                              indptr, 3000, plan)
                    require(torch.equal(got[:, r * 264:(r + 1) * 264], one),
                            f"K1 run {r} differs from a launch on its slice ({dtype}, W={W})")
                runs = f"; each of {W // 264} runs bit-identical to a launch on its slice"
            log(f"  K1 segment_sum {str(dtype)[6:]:8s} W={W:4d}: max_abs_err={err:.3e} "
                f"scaled={rel:.3e} (tol {tol:g}); bit-equal to the planned order{runs}")
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


# (HC, H, WP): the bench and walmart width, the other widths the kernels
# take (cuda_pma.KERNEL_WIDTHS), and heads up to one column per head (the
# denominators leave shared memory (DG) for f32 from 192 heads in K2 at
# HC 192, from 32 heads in K3 and 64 in K2 at HC 256, from 384 in K3 and
# 128 in K2 at HC 384, from 256 in K3 and 128 in K2 at HC 512)
EPI_SHAPES = ((256, 8, 264), (256, 32, 288), (256, 128, 384), (192, 8, 200), (192, 192, 384),
              (128, 4, 136),
              (64, 1, 72), (64, 64, 128), (384, 1, 392), (384, 8, 392), (384, 384, 768),
              (512, 1, 520), (512, 8, 520), (512, 512, 1024),
              # the wide pair (csrc/pma_epilogue_wide.cu): HC above 512
              (640, 8, 648), (768, 1, 776), (768, 768, 1536), (1024, 8, 1032),
              (1024, 64, 1088))
# (HC, H, WP, dtype, L): the widest shapes the wide pair takes, where the
# JAX kernel's scoped VMEM (cuda_pma.jax_vmem_need) is just under its cap
WIDEST = ((1536, 8, 1544, torch.float32, 2), (2048, 8, 2056, torch.bfloat16, 1))


def check_epilogue(dev, gen):
    """K2/K3 against their plain versions at EPI_SHAPES (f32 and bf16, L 1
    and 2) and at WIDEST, each shape routed to the kernels."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    cases = [(shape, dtype, L) for shape in EPI_SHAPES
             for dtype in (torch.float32, torch.bfloat16) for L in (1, 2)]
    cases += [((HC, H, WP), dtype, L) for HC, H, WP, dtype, L in WIDEST]
    for (HC, H, WP), dtype, L in cases:
        item = torch.empty((), dtype=dtype).element_size()
        require(cp.epilogue_route(HC, H, L, WP, 1, item) == "kernel",
                f"HC={HC}, L={L}, {dtype} is not routed to the kernels")
        small = cp.tile_rows(HC) * 5 // 8  # below one tile (64, 32 or 16 rows)
        for M in (1000, small):  # not a multiple of the tile; below one tile
            for relu in (False, True):
                if M == small and relu:
                    continue
                agg, gy, p = epi_inputs(M, HC, H, WP, L, dtype, dev, gen)
                seed, g0, b0, W, b, g1, b1 = p
                y = cp.epilogue_fwd_cuda(agg, seed, g0, b0, W, b, g1, b1, H, relu)
                y_ref = cp.epilogue_fwd_plain(agg, seed, g0, b0, W, b, g1, b1, H, relu)
                got = cp.epilogue_bwd_cuda(agg, gy, seed, g0, b0, W, b, g1, b1, H, relu)
                want = cp.epilogue_bwd_plain(agg, gy, seed, g0, b0, W, b, g1, b1, H, relu)
                torch.cuda.synchronize()
                what = f"{dtype}, HC={HC}, H={H}, M={M}, L={L}, relu={relu}"
                err, rel = scaled_err(y, y_ref)
                ftol = EPI_FWD_TOL[dtype]
                require(rel <= ftol, f"K2 disagrees ({what}): {rel}")
                msg = check_bwd(got, want, TOL[dtype][1], what)
                log(f"  K2/K3 {str(dtype)[6:]:8s} HC={HC:3d} H={H:2d} M={M:4d} L={L} "
                    f"relu={int(relu)}: fwd max_abs_err={err:.3e} scaled={rel:.3e} "
                    f"(tol {ftol:g}); bwd scaled max {msg}")
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
    by run, bit for bit against K2/K3 launched on the run's slice, at HC
    256 and 512, at 640, 768 and 1024 (the wide pair; R 2 and 5, L 1 and
    2), and at WIDEST (R 2)."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    M = 1000  # not a multiple of the 64-, 32- or 16-row tile
    cases = [(shape, dtype, R, L)
             for shape in ((256, 8, 264), (512, 8, 520), (640, 8, 648), (768, 8, 776),
                           (1024, 8, 1032))
             for dtype in (torch.float32, torch.bfloat16) for R in (2, 5) for L in (1, 2)]
    cases += [((HC, H, WP), dtype, 2, L) for HC, H, WP, dtype, L in WIDEST]
    for (HC, H, WP), dtype, R, L in cases:
        for relu in (False, True):
            agg, gy, p = runs_inputs(M, HC, H, WP, L, R, dtype, dev, gen)
            y = cp.epilogue_fwd_runs_cuda(agg, *p, H, relu)
            y_ref = cp.epilogue_fwd_runs_plain(agg, *p, H, relu)
            got = cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, relu)
            want = cp.epilogue_bwd_runs_plain(agg, gy, *p, H, relu)
            what = f"{dtype}, HC={HC}, R={R}, L={L}, relu={relu}"
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
            log(f"  K2R/K3R {str(dtype)[6:]:8s} HC={HC} R={R} L={L} relu={int(relu)}: fwd "
                f"max_abs_err={err:.3e} scaled={rel:.3e}; bwd scaled max {msg}; "
                f"every run bit-identical to K2/K3 on its slice")
    _kernels.reset_launches()


def ulps(got, want) -> float:
    """Max |got - want| in units in the last place of want (in want's
    dtype); an exact 0 must come out 0."""
    bits = {torch.float32: 23, torch.bfloat16: 7}[want.dtype]
    g, w = got.float(), want.float()
    exp = torch.frexp(w).exponent
    ulp = torch.ldexp(torch.ones_like(w), exp - 1 - bits)
    ulp = torch.where(w == 0, torch.full_like(w, torch.finfo(want.dtype).tiny), ulp)
    return ((g - w).abs() / ulp).max().item() if w.numel() else 0.0


PACK_ULPS = {torch.float32: 2, torch.bfloat16: 1}


def pack_inputs(M, HC, H, dtype, dev, gen, R=None):
    """yf as the padded GEMM emits it, [M, WP] ([M, R, WP] with runs):
    values, scores and zero pad; bV, ba with a leading [R] with runs."""
    from allset_tpu_torch.nn.modules import packed_width

    lead = () if R is None else (R,)
    WP = packed_width(HC, H)
    yf = torch.zeros((M,) + lead + (WP,))
    yf[..., :HC] = torch.randn((M,) + lead + (HC,), generator=gen)
    yf[..., HC:HC + H] = 2.0 * torch.randn((M,) + lead + (H,), generator=gen)
    bV = 0.1 * torch.randn(lead + (HC,), generator=gen)
    ba = 0.1 * torch.randn(lead + (H,), generator=gen)
    return yf.to(dtype).to(dev), bV.to(dev), ba.to(dev)


def check_pack(dev, gen):
    """K4/K5 against their plain versions: gmax bit-equal, w within
    PACK_ULPS, a NaN score propagated to gmax; the runs grid (R in {2, 5})
    bit for bit against single-run launches on each slice."""
    from allset_tpu_torch.ops import _kernels, cuda_pack as ck

    M = 1000  # not a multiple of K5's 32-row tile
    for dtype in (torch.float32, torch.bfloat16):
        for HC, H in ((256, 8), (64, 1), (128, 4), (512, 8)):
            yf, bV, ba = pack_inputs(M, HC, H, dtype, dev, gen)
            g = ck.gmax_cuda(yf, ba, H, HC)
            w = ck.pack_cuda(yf, bV, ba, g, H)
            g_ref = ck.gmax_plain(yf, ba, H, HC)
            w_ref = ck.pack_plain(yf, bV, ba, H)
            torch.cuda.synchronize()
            require(torch.equal(g, g_ref), f"K4 gmax differs ({dtype}, HC={HC}, H={H})")
            u = ulps(w, w_ref)
            err, _ = scaled_err(w, w_ref)
            require(u <= PACK_ULPS[dtype], f"K5 off by {u} ulps ({dtype}, HC={HC}, H={H})")
            require(not w[:, HC + H:].any(), "K5 pad columns not zero")
            yf[123, HC + H - 1] = float("nan")
            g_nan, g_nan_ref = ck.gmax_cuda(yf, ba, H, HC), ck.gmax_plain(yf, ba, H, HC)
            require(bool(torch.isnan(g_nan[H - 1])) and bool(torch.isnan(g_nan_ref[H - 1]))
                    and torch.equal(g_nan[:H - 1], g_nan_ref[:H - 1]),
                    f"K4 does not propagate NaN ({dtype}, HC={HC}, H={H})")
            msg = []
            for R in (2, 5):
                yr, bVr, bar = pack_inputs(M, HC, H, dtype, dev, gen, R=R)
                gr = ck.gmax_cuda(yr, bar, H, HC)
                wr = ck.pack_cuda(yr, bVr, bar, gr, H)
                WP = yr.shape[-1]
                ur = ulps(wr, ck.pack_runs_plain(yr, bVr, bar, H))
                require(ur <= PACK_ULPS[dtype], f"K5 runs off by {ur} ulps (R={R})")
                for r in range(R):
                    y1 = yr[:, r].contiguous()
                    g1 = ck.gmax_cuda(y1, bar[r], H, HC)
                    require(torch.equal(gr[r], g1) and torch.equal(
                        wr[:, r * WP:(r + 1) * WP], ck.pack_cuda(y1, bVr[r], bar[r], g1, H)),
                        f"K4/K5 run {r} of {R} differs from a single launch ({dtype}, HC={HC})")
                msg.append(f"R={R} {ur:g} ulps")
            log(f"  K4/K5 {str(dtype)[6:]:8s} HC={HC:3d} H={H}: gmax bit-equal, NaN "
                f"propagated; w max_abs_err={err:.3e}, {u:g} ulps (tol {PACK_ULPS[dtype]}); "
                f"runs {', '.join(msg)}, every run bit-identical to a single launch")
    _kernels.reset_launches()


LN_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.bfloat16))  # (x, y): the first input norm of bf16


def ln_inputs(rows, F, xdt, ydt, dev, gen, R=None, shared=False):
    """x (rows of 2z+1, z ~ N(0, 1)), gamma, beta, g for B12/B13; with R
    runs x is [rows, R, F] (or [rows, F] shared) and gamma, beta [R, F]."""
    lead = () if R is None else (R,)
    xs = (rows, F) if R is None or shared else (rows, R, F)
    x = (2 * torch.randn(xs, generator=gen) + 1).to(xdt).to(dev)
    gamma = (1 + 0.3 * torch.randn(lead + (F,), generator=gen)).to(dev)
    beta = (0.2 * torch.randn(lead + (F,), generator=gen)).to(dev)
    g = torch.randn((rows,) + lead + (F,), generator=gen).to(ydt).to(dev)
    return x, gamma, beta, g


def check_ln_pair(x, gamma, beta, g, ydt, what):
    """B12 and B13 against their plain versions -> (y err, dx err) scaled."""
    from allset_tpu_torch.ops import cuda_ln as cl

    y = cl.ln_fwd_cuda(x, gamma, beta, ydt)
    dx, dg, db = cl.ln_bwd_cuda(g, x, gamma)
    y_ref = cl.ln_fwd_plain(x, gamma, beta, ydt)
    dx_ref, dg_ref, db_ref = cl.ln_bwd_plain(g, x, gamma)
    torch.cuda.synchronize()
    ftol, gtol = TOL[ydt]
    out = []
    for name, a, b, tol in (("y", y, y_ref, ftol), ("dx", dx, dx_ref, gtol),
                            ("dgamma", dg, dg_ref, gtol), ("dbeta", db, db_ref, gtol)):
        require(a.dtype == b.dtype and a.shape == b.shape, f"B12/B13 {name} shape ({what})")
        err, rel = scaled_err(a, b)
        require(rel <= tol, f"B12/B13 {name} disagrees ({what}): {rel}")
        out.append(f"{name} {rel:.2e}")
    return (y, dx, dg, db), ", ".join(out)


def check_layer_norm(dev, gen):
    """B12/B13 against their plain versions in f32, bf16 and f32 -> bf16,
    at F in {7, 64, 256, 512} (7: the scalar path), rows not a multiple of
    the backward's 64-row block; runs R in {2, 5} (and an x shared by the
    runs) bit for bit against launches on each run alone."""
    from allset_tpu_torch.ops import _kernels, cuda_ln as cl

    for xdt, ydt in LN_DTYPES:
        for F in (7, 64, 256, 512):
            for rows in (1000, 37):
                what = f"{str(xdt)[6:]}->{str(ydt)[6:]}, F={F}, rows={rows}"
                _, msg = check_ln_pair(*ln_inputs(rows, F, xdt, ydt, dev, gen), ydt, what)
                log(f"  B12/B13 {what}: scaled errors {msg} (tol {TOL[ydt]})")
            for R, shared in ((2, False), (5, False), (5, True)):
                x, gamma, beta, g = ln_inputs(1000, F, xdt, ydt, dev, gen, R=R, shared=shared)
                what = f"{str(xdt)[6:]}->{str(ydt)[6:]}, F={F}, R={R}{' shared' if shared else ''}"
                (y, dx, dg, db), msg = check_ln_pair(x, gamma, beta, g, ydt, what)
                for r in range(R):
                    xr = x if shared else x[:, r].contiguous()
                    gr = g[:, r].contiguous()
                    y1 = cl.ln_fwd_cuda(xr, gamma[r], beta[r], ydt)
                    dx1, dg1, db1 = cl.ln_bwd_cuda(gr, xr, gamma[r])
                    require(torch.equal(y[:, r], y1) and torch.equal(dx[:, r], dx1)
                            and torch.equal(dg[r], dg1) and torch.equal(db[r], db1),
                            f"B12/B13 run {r} differs from a launch on it alone ({what})")
                log(f"  B12/B13 {what}: scaled errors {msg}; every run bit-identical to a "
                    f"launch on it alone")
    _kernels.reset_launches()


def check_routes(dev, gen):
    """The epilogue's route on the card is chosen by shape: an rFF of 3
    layers and HC 96 (shapes the JAX package composes too) take the plain
    version and launch no kernel; HC 256 and 512 with 2 layers launch K2/K3
    (K2R/K3R with runs), and so do HC 640 and 1024 (the wide pair); HC
    2048 with 2 layers in f32, where the JAX kernel's scoped VMEM exceeds
    its cap, raises before any launch."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    for R in (None, 2):
        agg, gy, p = (epi_inputs(300, 2048, 8, 2056, 2, torch.float32, dev, gen) if R is None
                      else runs_inputs(300, 2048, 8, 2056, 2, R, torch.float32, dev, gen))
        _kernels.reset_launches()
        for fn, args in (((cp.epilogue_fwd, (agg,)), (cp.epilogue_bwd, (agg, gy))) if R is None
                         else ((cp.epilogue_fwd_runs, (agg,)), (cp.epilogue_bwd_runs, (agg, gy)))):
            try:
                fn(*args, *p, 8, True)
            except ValueError as e:
                msg = str(e)
                continue
            require(False, f"HC 2048 (R={R or 1}) did not raise")
        require(not any(_kernels.launches.values()), "HC 2048: a launch before the raise")
        log(f"  route HC=2048, H=8, L=2, R={R or 1}, f32: raises, no launch ({msg[:150]}...)")
        del agg, gy, p
    for HC, H, WP, L, want in ((256, 8, 264, 3, "plain"), (96, 4, 104, 2, "plain"),
                               (256, 8, 264, 2, "kernel"), (512, 8, 520, 2, "kernel"),
                               (640, 8, 648, 2, "kernel"), (1024, 16, 1040, 1, "kernel")):
        for R in (None, 2):
            _kernels.reset_launches()
            if R is None:
                agg, gy, p = epi_inputs(300, HC, H, WP, L, torch.float32, dev, gen)
                y = cp.epilogue_fwd(agg, *p, H, True)
                d = cp.epilogue_bwd(agg, gy, *p, H, True)
                y_ref = cp.epilogue_fwd_plain(agg, *p, H, True)
                names = ("pma_epilogue_fwd", "pma_epilogue_bwd")
            else:
                agg, gy, p = runs_inputs(300, HC, H, WP, L, R, torch.float32, dev, gen)
                y = cp.epilogue_fwd_runs(agg, *p, H, True)
                d = cp.epilogue_bwd_runs(agg, gy, *p, H, True)
                y_ref = cp.epilogue_fwd_runs_plain(agg, *p, H, True)
                names = ("pma_epilogue_fwd_runs", "pma_epilogue_bwd_runs")
            torch.cuda.synchronize()
            launched = sum(_kernels.launches[k] for k in names)
            what = f"HC={HC}, H={H}, L={L}, R={R or 1}"
            require(cp.epilogue_route(HC, H, L, WP, R or 1) == want, f"route for {what}")
            require(launched == (2 if want == "kernel" else 0), f"{launched} launches for {what}")
            require(scaled_err(y, y_ref)[1] <= EPI_FWD_TOL[torch.float32] and
                    bool(torch.isfinite(d[0]).all()), f"epilogue on the {want} route ({what})")
            log(f"  route {what}: {want} ({launched} kernel launches)")
    _kernels.reset_launches()


def time_pack(rows_list, R, dtype, dev, gen, per_launch):
    """K4 and K5 against their plain versions at the given row counts (one
    pack per half-layer), HC 256, 8 heads; times summed over a step's or
    an epoch's launches (per_launch of each half-layer). K4's plain
    version is the column max, K5's the whole plain chain (which takes
    its own column max). Returns {name: Tally}."""
    from allset_tpu_torch.ops import _kernels, cuda_pack as ck

    HC, H = 256, 8
    item = 2 if dtype == torch.bfloat16 else 4
    runs = 1 if R is None else R
    tot = {"pma_gmax": Tally(), "pma_pack": Tally()}
    for rows in rows_list:
        yf, bV, ba = pack_inputs(rows, HC, H, dtype, dev, gen, R=R)
        WP = yf.shape[-1]
        plain = ck.pack_plain if R is None else ck.pack_runs_plain
        gplain = (ck.gmax_plain if R is None else
                  lambda y, a, h, c: torch.stack([ck.gmax_plain(y[:, r], a[r], h, c)
                                                  for r in range(R)]))
        g = ck.gmax_cuda(yf, ba, H, HC)
        k4 = cuda_ms(lambda: ck.gmax_cuda(yf, ba, H, HC))
        p4 = cuda_ms(lambda: gplain(yf, ba, H, HC), iters=3)
        k5 = cuda_ms(lambda: ck.pack_cuda(yf, bV, ba, g, H))
        p5 = cuda_ms(lambda: plain(yf, bV, ba, H), iters=3)
        w, w_ref = ck.pack_cuda(yf, bV, ba, g, H), plain(yf, bV, ba, H)
        g_ref = gplain(yf, ba, H, HC)
        require(torch.equal(g, g_ref), f"K4 differs at rows={rows}")
        err4 = (g - g_ref).abs().max().item()
        u = ulps(w, w_ref)
        require(u <= PACK_ULPS[dtype], f"K5 off by {u} ulps at rows={rows}")
        err, _ = scaled_err(w, w_ref)
        del w, w_ref
        # K4 reads the H score columns, K5 reads yf and writes w
        tot["pma_gmax"].add(per_launch, k4, p4, err4, runs * (rows * H * item + 4 * H),
                            [(runs * rows * H * 2, "f32")])
        tot["pma_pack"].add(per_launch, k5, p5, err,
                            runs * (2 * rows * WP * item + 4 * (HC + 2 * H)),
                            [(runs * rows * (HC + H) * 4, "f32")])
        runs_s = "" if R is None else f", R={R}"
        log(f"  K4 at [{rows}, {'' if R is None else f'{R}x'}{WP}]{runs_s}: kernel "
            f"{k4:.3f} ms, plain {p4:.3f} ms; K5: kernel {k5:.3f} ms, plain chain {p5:.3f} ms, "
            f"max_abs_err {err:.3e} ({u:g} ulps)")
        del yf
    _kernels.reset_launches()
    return tot


def spmm_cost(table_rows, k, nseg, W, dtype, id_item=8):
    """(bytes, ops) of the gather inside K1: the [table_rows, W] table read
    once and the k ids (gather_cost without output rows), every segment
    row written once and indptr (seg_cost without message rows); one f32
    add per gathered element."""
    item = 2 if dtype == torch.bfloat16 else 4
    return (gather_cost(table_rows, 0, W, item)[0] + k * id_item
            + seg_cost(0, nseg, W, dtype)[0]), [(k * W, "f32")]


def time_spmm_passes(batch, W, dtype, fwd_times):
    """The gather inside K1 on _Spmm's passes over one V->E and one E->V
    exchange of the self-loop split at width W (forward counted
    ``fwd_times``, backward once), on random tables: kernel, plain and
    library times (index_select, then torch.segment_reduce, on the ids
    clamped beforehand) and the bound, summed; each pass held bit for bit
    to B10 + K1 and to the plain version in the kernel's order. Returns a
    Tally."""
    from allset_tpu_torch.experiments.exp_fused_gather import spmm_passes
    from allset_tpu_torch.ops import _kernels, cuda_gather as cg, cuda_segment as cs

    t = Tally()
    for table, ids, ip, nseg, plan, n in spmm_passes(batch, W, dtype, fwd_times):
        k = cuda_ms(lambda: cs.gather_segment_sum_cuda(table, ids, ip, nseg, plan), iters=10)
        p = cuda_ms(lambda: cs.gather_segment_sum_plain(table, ids, ip, nseg), iters=3)
        clamped = ids.clamp(0, table.shape[0] - 1)
        lib = cuda_ms(lambda: torch.segment_reduce(table.index_select(0, clamped), "sum",
                                                   offsets=ip, axis=0), iters=3)
        got = cs.gather_segment_sum_cuda(table, ids, ip, nseg, plan)
        require(torch.equal(got, cs.segment_sum_cuda(cg.gather_fwd_cuda(table, ids), ip, nseg,
                                                     plan)),
                f"segment_sum_gather differs from B10 + K1 at [{ids.shape[0]}, {W}]")
        require(torch.equal(got, cs.gather_segment_sum_planned(table, ids, ip, nseg, plan)),
                f"segment_sum_gather differs from its order of additions at [{ids.shape[0]}, {W}]")
        e, rel = scaled_err(got, cs.gather_segment_sum_plain(table, ids, ip, nseg))
        require(rel <= TOL[dtype][0], f"segment_sum_gather disagrees at [{ids.shape[0]}, {W}]")
        t.add(n, k, p, e, *spmm_cost(table.shape[0], ids.shape[0], nseg, W, dtype),
              library_ms=lib)
        log(f"  segment_sum_gather at [{ids.shape[0]}, {W}] {str(dtype)[6:]} from {table.shape[0]} "
            f"rows -> {nseg} segments (x{n}): kernel {k:.4f} ms, plain {p:.3f} ms, index_select + "
            f"segment_reduce {lib:.4f} ms; bit-equal to B10 + K1 and to its order; max_abs_err "
            f"{e:.3e} (scaled {rel:.2e})")
        del got
    _kernels.reset_launches()
    return t


def ln_cost(rows, F, xdt, ydt, bwd, need_dx=True, R=1):
    """(bytes, ops) of B12 (bwd=False: x in, y out, gamma and beta) or B13
    (g and x in, dx out where asked, gamma in, dgamma and dbeta out); about
    8 (B12) and 12 (B13) f32 operations per element."""
    xi, yi = (2 if t == torch.bfloat16 else 4 for t in (xdt, ydt))
    n = rows * R * F
    if bwd:
        return n * (yi + xi + (xi if need_dx else 0)) + 3 * 4 * R * F, [(12 * n, "f32")]
    return n * (xi + yi) + 2 * 4 * R * F, [(8 * n, "f32")]


# the LayerNorm launches of an AllDeepSets bench step (one layer, 2-layer
# MLPs with input norms): (rows, x dtype, dx needed), each once forward and
# once backward; the first reads the f32 features and needs no dx
def ln_step_shapes(batch):
    N, E = batch.num_nodes, batch.inc.real.num_edges + batch.num_nodes
    return ([(N, torch.float32, False)] + [(N, torch.bfloat16, True)] * 3
            + [(E, torch.bfloat16, True)] * 4)


def time_layer_norm(shapes, F, dev, gen):
    """B12/B13 against their plain versions at the given launch shapes
    (bf16 output), and F.layer_norm with its autograd backward on the same
    inputs (the parameters in x's dtype, as it requires on the card) as
    the library call; each held to its plain version. The kernels and the
    library are timed as the median of 5 readings of 20 calls, each
    reading after a warm-up call, with the lowest and highest reading
    logged. Returns {"layer_norm_fwd": Tally, "layer_norm_bwd": Tally}."""
    import torch.nn.functional as tf

    from allset_tpu_torch.ops import _kernels, cuda_ln as cl

    out = {"layer_norm_fwd": Tally(), "layer_norm_bwd": Tally()}
    ydt = torch.bfloat16
    for (rows, xdt, need_dx), n in sorted(
            ((k, shapes.count(k)) for k in set(shapes)), key=lambda kn: kn[0][0]):
        x, gamma, beta, g = ln_inputs(rows, F, xdt, ydt, dev, gen)
        kf, *kf_r = cuda_ms_spread(lambda: cl.ln_fwd_cuda(x, gamma, beta, ydt))
        pf = cuda_ms(lambda: cl.ln_fwd_plain(x, gamma, beta, ydt), iters=3)
        kb, *kb_r = cuda_ms_spread(lambda: cl.ln_bwd_cuda(g, x, gamma, need_dx))
        pb = cuda_ms(lambda: cl.ln_bwd_plain(g, x, gamma), iters=3)
        # the library takes the parameters in x's dtype (its f32 statistics
        # and output in x's dtype are the kernels')
        xl = x.detach().requires_grad_(need_dx)
        wl = gamma.to(x.dtype).requires_grad_()
        bl = beta.to(x.dtype).requires_grad_()
        yl = tf.layer_norm(xl, (F,), wl, bl, eps=cl.LN_EPS)
        lf, *lf_r = cuda_ms_spread(lambda: tf.layer_norm(x, (F,), wl, bl, eps=cl.LN_EPS))
        ins = (xl, wl, bl) if need_dx else (wl, bl)
        gl = g.to(yl.dtype)
        lb, *lb_r = cuda_ms_spread(lambda: torch.autograd.grad(yl, ins, gl, retain_graph=True))
        (y, dx, dg, db), msg = check_ln_pair(x, gamma, beta, g, ydt, f"rows={rows}")
        ef = scaled_err(y, cl.ln_fwd_plain(x, gamma, beta, ydt))[0]
        eb = scaled_err(dx, cl.ln_bwd_plain(g, x, gamma)[0])[0]
        del y, dx, yl, xl
        out["layer_norm_fwd"].add(n, kf, pf, ef, *ln_cost(rows, F, xdt, ydt, False),
                                  library_ms=lf)
        out["layer_norm_bwd"].add(n, kb, pb, eb, *ln_cost(rows, F, xdt, ydt, True, need_dx),
                                  library_ms=lb)
        log(f"  B12 at [{rows}, {F}] {str(xdt)[6:]}->bf16 (x{n} per step): kernel {kf:.4f} ms "
            f"{rng(kf_r)}, plain {pf:.3f} ms, F.layer_norm {lf:.4f} ms {rng(lf_r)}; B13 (dx "
            f"{'yes' if need_dx else 'no'}): kernel {kb:.4f} ms {rng(kb_r)}, plain {pb:.3f} ms, "
            f"F.layer_norm backward {lb:.4f} ms {rng(lb_r)}; scaled errors {msg}")
    _kernels.reset_launches()
    return out


def time_main_shapes(batch, dev, gen):
    """Kernel, plain and library times and the bound at the main path's
    shapes (bf16): the gather inside K1 on _Spmm's four passes at the
    packed width (time_spmm_passes), K2/K3 at the two half-layers' row
    counts, K4/K5. Times are summed over one training step's launches
    (the gather inside K1: 4, K2: 2, K3: 2, K4: 2, K5: 2). Each kernel is
    held to its plain version with phase 3's tolerances (the gather inside
    K1 bit for bit to B10 + K1); the reported max_abs_err is that of the
    gather inside K1's and K2's output and K3's dagg. No row sits at the 1e-16 floor here, as none does on the
    main path. Returns {name: Tally}."""
    from allset_tpu_torch.ops import _kernels

    inc = batch.inc.real
    out = {"segment_sum_gather": time_spmm_passes(batch, 264, torch.bfloat16, 1)}
    out.update(time_epilogue_step(batch, dev, gen))
    # K4/K5: V->E packs the N node rows, E->V the real edges + N-slot rows
    out.update(time_pack((batch.inc.num_nodes, inc.num_edges + batch.inc.num_nodes), None,
                         torch.bfloat16, dev, gen, per_launch=1))
    log_tallies(out, "bench step")
    _kernels.reset_launches()
    return out


def time_epilogue_step(batch, dev, gen, HC=256, suffix=""):
    """K2 and K3 at a bench step's two half-layers' row counts, hidden HC
    with 8 heads (bf16): kernel and plain times summed over the step's
    launches (2 each), each held to its plain version with phase 3's
    tolerances. Returns {name + suffix: Tally}."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    inc = batch.inc.real
    H, WP, L, dt = 8, HC + 8, 2, torch.bfloat16
    out = {"pma_epilogue_fwd" + suffix: Tally(), "pma_epilogue_bwd" + suffix: Tally()}
    for M in (inc.num_edges + batch.inc.num_nodes, batch.inc.num_nodes):
        agg, gy, p = epi_inputs(M, HC, H, WP, L, dt, dev, gen, floor_rows=False)
        args = (agg, *p)
        kf = cuda_ms(lambda: cp.epilogue_fwd_cuda(*args, H, True))
        pf = cuda_ms(lambda: cp.epilogue_fwd_plain(*args, H, True))
        kb = cuda_ms(lambda: cp.epilogue_bwd_cuda(agg, gy, *p, H, True))
        pb = cuda_ms(lambda: cp.epilogue_bwd_plain(agg, gy, *p, H, True))
        ef, rf = scaled_err(cp.epilogue_fwd_cuda(*args, H, True),
                            cp.epilogue_fwd_plain(*args, H, True))
        require(rf <= EPI_FWD_TOL[dt], f"K2 disagrees at M={M}, HC={HC}: {rf}")
        got = cp.epilogue_bwd_cuda(agg, gy, *p, H, True)
        want = cp.epilogue_bwd_plain(agg, gy, *p, H, True)
        bmsg = check_bwd(got, want, TOL[dt][1], f"M={M}, HC={HC}")
        eb, _ = scaled_err(got[0], want[0])
        out["pma_epilogue_fwd" + suffix].add(1, kf, pf, ef, *epi_cost(M, HC, WP, L, dt, False))
        out["pma_epilogue_bwd" + suffix].add(1, kb, pb, eb, *epi_cost(M, HC, WP, L, dt, True))
        log(f"  K2 at M={M}, HC={HC}: kernel {kf:.3f} ms, plain {pf:.3f} ms, max_abs_err "
            f"{ef:.3e} (scaled {rf:.2e}); K3: kernel {kb:.3f} ms, plain {pb:.3f} ms, dagg "
            f"max_abs_err {eb:.3e}; scaled max {bmsg}")
        del agg, gy, p, args, got, want
    _kernels.reset_launches()
    return out


class Measured:
    """A kernels-line row measured by an experiment's main (its keys as
    Tally.row() gives them)."""

    KEYS = ("ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by", "library_ms")

    def __init__(self, rec):
        self.rec = {k: rec.get(k) for k in self.KEYS}

    def row(self):
        return dict(self.rec)


def run_experiments(bench, walmart):
    """Phase 3b: each experiment's main (allset_tpu_torch.experiments) at
    its script's shapes on the card, every launch count set to 0 just
    before and read just after (each of the new kernels must have
    launched); returns ({kernels-line name: Measured}, counts)."""
    from allset_tpu_torch.experiments import (exp_acc2, exp_autopipe, exp_fused_gather,
                                              exp_nbuf, exp_onehot, exp_segsum_ablate,
                                              pallas_segsum_proto)
    from allset_tpu_torch.ops import _kernels

    a = ["--iters", "5"]
    _kernels.reset_launches()
    rec = {"B1": pallas_segsum_proto.main(a), "B2": exp_nbuf.main(a),
           "B3": exp_acc2.main(a, batch=bench), "B4": exp_onehot.main(a),
           "B6": exp_segsum_ablate.main(a, batch=bench), "B8": exp_autopipe.main(a),
           "B8 first16": exp_autopipe.main(a + ["--body", "first16"]),
           "B11": exp_fused_gather.main(a, bench=bench, walmart=walmart)}
    torch.cuda.synchronize()
    counts = dict(_kernels.launches)
    for k in ("segsum_onehot", "stream_flat", "stream_dual", "stream_fold", "segment_sum_gather"):
        require(counts[k] > 0, f"phase 3b launched no {k}")
    log(f"  _Spmm's route by the pairs: {rec['B11']['route']} (the code runs the gather inside K1)")
    first = {v: r["variants"][0] for v, r in rec.items()}
    b6 = {r["label"].split()[0]: r for r in rec["B6"]["variants"]}
    out = {"segsum_onehot": first["B1"], "segsum_onehot_b2": first["B2"],
           "segsum_onehot_b3": first["B3"], "segsum_onehot_b4": first["B4"],
           "segsum_onehot_b6": b6["full"], "stream_flat": b6["flat"],
           "stream_dual": b6["dual"], "stream_fold": first["B8"]}
    _kernels.reset_launches()
    return {k: Measured(v) for k, v in out.items()}, counts


def log_tallies(out, per):
    for name, t in out.items():
        r = t.row()
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.3f} ms"
        log(f"  {name} per {per}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{lib}, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")


# --- phases 4 and 5: the training step --------------------------------------


def bench_raw():
    """The bench graph as generated, without self-loops, on the host."""
    from allset_tpu_torch.data import scale_free_hypergraph

    return scale_free_hypergraph(num_nodes=131072, num_hyperedges=65536,
                                 avg_edge_size=12, feature_dim=256, seed=0)


def bench_hyperdata(raw=None):
    """The bench graph (``raw``, or bench_raw()) with its self-loops, on
    the host."""
    from allset_tpu_torch.graph import add_self_loops, norm_construction

    return norm_construction(add_self_loops(bench_raw() if raw is None else raw), "all_one")


def bench_batch(dev, hd=None):
    from allset_tpu_torch.graph import Batch

    return Batch.from_hyperdata(bench_hyperdata() if hd is None else hd, device=dev,
                                bucket=1024)


def bench_model(seed: int, nnz_padded: int, hidden: int = 256, **mode):
    """The bench configuration at ``hidden`` (256; 512 as the 512-wide
    presets); ``mode`` adds gpr=True or learn_mask=True, or pma=False (with
    aggregate='add': AllDeepSets)."""
    from allset_tpu_torch.models import SetGNN, SetGNNConfig

    cfg = SetGNNConfig(
        num_features=256, num_classes=8, all_num_layers=1, mlp_hidden=hidden,
        classifier_num_layers=1, heads=8, dropout=0.0,
        dtype="bfloat16", nnz_padded=nnz_padded, **mode,
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


# _Spmm's passes (V->E, E->V, forward and backward) each launch the gather
# inside K1 (ops/exchange.py's route) and neither B10 nor K1
PER_STEP = {"segment_sum_gather": 4, "pma_epilogue_fwd": 2, "pma_epilogue_bwd": 2,
            "pma_gmax": 2, "pma_pack": 2}
# GPR: gpr_mlp's hidden LayerNorm (MLP_num_layers 2)
PER_STEP_GPR = {**PER_STEP, "layer_norm_fwd": 1, "layer_norm_bwd": 1}
# AllDeepSets: V->E and E->V each run f_enc and f_dec, 2-layer MLPs with an
# input norm: 4 LayerNorms per half-layer
PER_STEP_DEEPSETS = {"segment_sum_gather": 4, "layer_norm_fwd": 8, "layer_norm_bwd": 8}


def pair_route():
    """A context in which ops/exchange.py's _Spmm runs the pair that the
    gather inside K1 replaced (B10's gather, the scale, K1): main_path's
    comparison of losses only."""
    import contextlib

    from allset_tpu_torch.ops import cuda_gather as cg, cuda_segment as cs, exchange

    def pair(w, ids, indptr, nseg, plan, norm=None):
        rows = cg.gather_fwd(w, ids)
        return cs.segment_sum(rows if norm is None else cs.scale_rows(rows, norm), indptr, nseg,
                              plan)

    @contextlib.contextmanager
    def ctx():
        orig = exchange.gather_segment_sum
        exchange.gather_segment_sum = pair
        try:
            yield
        finally:
            exchange.gather_segment_sum = orig
    return ctx()


def main_path(batch, dev, card, per_step=None, hidden=256, against_pair=False, **mode):
    """8 bench steps at ``hidden`` (``mode``: the bench step,
    gpr=True, learn_mask=True, pma=False for AllDeepSets) with every launch
    count set to 0 just before, checked against ``per_step`` (default: the
    bench step's PER_STEP, as ``scripts/pair_timing.py`` calls it in any
    tree); with ``against_pair`` the same steps from the same state through
    the pair the gather inside K1 replaced (pair_route: one B10 and one K1
    launch per pass) give bit-identical losses; returns the counts and the
    median step time."""
    from allset_tpu_torch.ops import _kernels

    steps = 8
    per_step = PER_STEP if per_step is None else per_step
    label = ", ".join(f"{k}={v}" for k, v in mode.items()) or "bench step"
    if hidden != 256:
        label += f", hidden {hidden}"
    mask = torch.arange(batch.num_nodes, device=dev) % 2 == 0
    model = bench_model(0, batch.inc.nnz_padded, hidden, **mode).to(dev)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    # warm-up on a throwaway copy: first-call allocations, cuBLAS handles
    warm = bench_model(0, batch.inc.nnz_padded, hidden, **mode).to(dev)
    run_steps(warm, batch, mask, 1)
    del warm
    _kernels.reset_launches()
    losses, times = run_steps(model, batch, mask, steps)
    counts = dict(_kernels.launches)
    log(f"  [{label}] launches over {steps} steps: {counts}")
    for k in _kernels.KERNELS:
        n = per_step.get(k, 0) * steps
        require(counts[k] == n, f"{label}: {k} launched {counts[k]} times, expected {n}")
    lo = losses.cpu()
    log(f"  [{label}] losses: {[round(v, 6) for v in lo.tolist()]}")
    require(bool(torch.isfinite(lo).all()), f"{label}: non-finite loss")
    require(lo[-1] < lo[0], f"{label}: loss did not fall")
    model2 = bench_model(1, batch.inc.nnz_padded, hidden, **mode).to(dev)
    model2.load_state_dict(state)
    losses2, _ = run_steps(model2, batch, mask, steps)
    require(torch.equal(losses, losses2), f"{label}: two runs from one state differ")
    if against_pair:
        model3 = bench_model(2, batch.inc.nnz_padded, hidden, **mode).to(dev)
        model3.load_state_dict(state)
        _kernels.reset_launches()
        with pair_route():
            losses3, _ = run_steps(model3, batch, mask, steps)
        pc = dict(_kernels.launches)
        n = per_step["segment_sum_gather"] * steps
        require(pc["gather"] == pc["segment_sum"] == n and pc["segment_sum_gather"] == 0,
                f"{label}: the pair route launched {pc}")
        require(torch.equal(losses, losses3), f"{label}: the pair route's losses differ")
        log(f"  [{label}] the pair route (B10 + K1, {n} launches of each) from the same state: "
            f"bit-identical losses")
    ms = statistics.median(times) * 1e3
    nnz = batch.inc.nnz
    log(f"  [{label}] two runs from one state: bit-identical losses; nnz {nnz}; median step "
        f"{ms:.3f} ms; {nnz / (ms / 1e3):,.0f} edges/s [{card}] (smoke, not a benchmark)")
    return counts, ms


def walmart_batch(dev):
    """The runs protocol's graph, prepared as the CLI prepares it."""
    from allset_tpu_torch.data import load_dataset
    from allset_tpu_torch.train.factory import ExperimentConfig, prepare

    data = load_dataset(WALMART, feature_noise=1.0, seed=0)
    return prepare(ExperimentConfig(dname=WALMART), data, dev)[1]


def time_runs_shapes(batch, dev, gen, R=20):
    """Kernel, plain and library times and the bound at the runs path's
    shapes (walmart preset, f32, R runs folded): the gather inside K1 on
    _Spmm's passes at width R*264 (time_spmm_passes; an epoch runs each
    forward twice, train and eval, and each backward once), K2R/K3R
    (time_epilogue_epoch),
    K4/K5. Summed per epoch; each kernel held to its plain version with
    phase 3's tolerances. Returns {name: Tally}."""
    from allset_tpu_torch.ops import _kernels

    inc = batch.inc.real
    dt = torch.float32
    out = {"segment_sum_gather_epoch": time_spmm_passes(batch, R * 264, dt, 2)}
    out.update(time_epilogue_epoch(batch, dev, gen, R))
    pack = time_pack((batch.num_nodes, inc.num_edges + batch.num_nodes), R, dt, dev, gen,
                     per_launch=2)  # train and eval forward
    out.update({f"{k}_runs": v for k, v in pack.items()})
    log_tallies(out, f"{R}-run epoch")
    _kernels.reset_launches()
    return out


def time_epilogue_epoch(batch, dev, gen, R=20, HC=256, suffix=""):
    """K2R and K3R at the runs path's two half-layers' row counts (hidden
    HC, 8 heads, f32, R runs folded): K2R twice each per epoch (train and
    eval), K3R once each, summed per epoch; each held to its plain version
    with phase 3's tolerances, and each run of K3R bit for bit to K3 on
    its slice. Returns {name + suffix: Tally}."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    inc = batch.inc.real
    H, WP, L, dt = 8, HC + 8, 2, torch.float32
    fwd, bwd = "pma_epilogue_fwd_runs" + suffix, "pma_epilogue_bwd_runs" + suffix
    out = {fwd: Tally(), bwd: Tally()}
    for M in (inc.num_edges + batch.num_nodes, batch.num_nodes):
        agg, gy, p = runs_inputs(M, HC, H, WP, L, R, dt, dev, gen, floor_rows=False)
        kf = cuda_ms(lambda: cp.epilogue_fwd_runs_cuda(agg, *p, H, True), iters=3)
        pf = cuda_ms(lambda: cp.epilogue_fwd_runs_plain(agg, *p, H, True), iters=2)
        kb = cuda_ms(lambda: cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, True), iters=3)
        pb = cuda_ms(lambda: cp.epilogue_bwd_runs_plain(agg, gy, *p, H, True), iters=2)
        ef, rf = scaled_err(cp.epilogue_fwd_runs_cuda(agg, *p, H, True),
                            cp.epilogue_fwd_runs_plain(agg, *p, H, True))
        require(rf <= EPI_FWD_TOL[dt], f"K2R disagrees at M={M}, HC={HC}: {rf}")
        got = cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, True)
        want = cp.epilogue_bwd_runs_plain(agg, gy, *p, H, True)
        bmsg = check_bwd(got, want, TOL[dt][1], f"runs M={M}, HC={HC}")
        eb, _ = scaled_err(got[0], want[0])
        del want
        for r in range(R):
            one = cp.epilogue_bwd_cuda(agg[:, r * WP:(r + 1) * WP].contiguous(),
                                       gy[:, r * HC:(r + 1) * HC].contiguous(),
                                       *[t[r] for t in p], H, True)
            require(torch.equal(got[0][:, r * WP:(r + 1) * WP], one[0])
                    and torch.equal(got[1][r], one[1]) and torch.equal(got[2][r], one[2]),
                    f"K3R run {r} differs from K3 on its slice at M={M}, HC={HC}")
        del got, one, agg, gy, p
        torch.cuda.empty_cache()
        out[fwd].add(2, kf, pf, ef, *epi_cost(M, HC, WP, L, dt, False, R))
        out[bwd].add(1, kb, pb, eb, *epi_cost(M, HC, WP, L, dt, True, R))
        log(f"  K2R at M={M}, HC={HC}, R={R}: kernel {kf:.3f} ms, plain {pf:.3f} ms, "
            f"max_abs_err {ef:.3e} (scaled {rf:.2e}); K3R: kernel {kb:.3f} ms, plain {pb:.3f} "
            f"ms, dagg max_abs_err {eb:.3e}; scaled max {bmsg}; each run bit-identical to K3")
    _kernels.reset_launches()
    return out


PER_GROUP_EPOCH = {"segment_sum_gather": 6, "pma_epilogue_fwd_runs": 4, "pma_epilogue_bwd_runs": 2,
                   "pma_epilogue_fwd": 0, "pma_epilogue_bwd": 0, "pma_gmax": 4, "pma_pack": 4}
# AllDeepSets (walmart preset): the gather inside K1 twice per half-layer
# forward (train and eval) and once backward; 4 LayerNorms per half-layer,
# forward in train and eval, backward once
DEEPSETS_GROUP_EPOCH = {"segment_sum_gather": 6, "layer_norm_fwd": 16, "layer_norm_bwd": 8}
# the epilogue on its plain route (an rFF of 3 layers): the gather inside
# K1, K4, K5 and no K2R/K3R
PLAIN_ROUTE_GROUP_EPOCH = {"segment_sum_gather": 6, "pma_gmax": 4, "pma_pack": 4}


def pma_group_epoch(layers=1, ln_fwd=0, ln_bwd=0):
    """AllSetTransformer's launches per group and epoch: PER_GROUP_EPOCH
    for each of ``layers`` V->E, E->V rounds, and the LayerNorms outside
    the epilogue (GPR's gpr_mlp, a classifier of 2 or more layers)."""
    return {**{k: v * layers for k, v in PER_GROUP_EPOCH.items()},
            "layer_norm_fwd": ln_fwd, "layer_norm_bwd": ln_bwd}


def cli_run(argv, epochs, per=None):
    """One CLI run with every launch count set to 0 just before; returns
    the Results and the counts of that run, checked per group and epoch
    against ``per`` (default: pma_group_epoch(); the epilogue's route shows
    in its launches), or, where ``per`` is a function of a group's number
    of runs (routes chosen by the folded width), against its sum over the
    groups."""
    from allset_tpu_torch import cli
    from allset_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    res = cli.run(argv)
    torch.cuda.synchronize()
    counts = dict(_kernels.launches)
    n = len(res.groups) * epochs
    if callable(per):
        total = {k: sum(per(g).get(k, 0) for g in res.groups) * epochs for k in _kernels.KERNELS}
        require(total == counts, f"launches {counts}, expected {total} (groups {res.groups})")
        require(bool(math.isfinite(res.metrics.sum())), "non-finite metrics")
        return res, counts
    per = pma_group_epoch() if per is None else per
    got = {k: counts[k] / n for k in _kernels.KERNELS}
    want = {k: float(per.get(k, 0)) for k in _kernels.KERNELS}
    require(got == want, f"launches per group and epoch {got}, expected {want} "
            f"(groups {res.groups})")
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
    folded_vs_one_by_one(short, 3)
    for flags, per in ((["--GPR"], pma_group_epoch(ln_fwd=2, ln_bwd=1)), (["--LearnMask"], None),
                       (["--add_self_loop", "false"], None)):
        res_m, counts_m = cli_run(base + ["--epochs", "2", *flags], 2, per)
        log(f"  {' '.join(flags)}: {res_m.metrics.shape[0]} runs in groups {res_m.groups}, "
            f"launches {counts_m}; params {res_m.num_params}; "
            f"{res_m.wall_time / 2 * 1e3:.1f} ms per epoch over 2 epochs (first included) "
            f"[{card}]")
    # the CLI's defaults: 2 layers, hidden 64, 1 head (HC + H = 65, WP = 72)
    # (its 2-layer classifier has one LayerNorm)
    res_x, counts_x = cli_run(["--dname", "synthetic", "--exclude_self", "--runs", "1",
                               "--epochs", "2", "--device", "cuda", "--res_root", tmp], 2,
                              pma_group_epoch(layers=2, ln_fwd=2, ln_bwd=1))
    log(f"  --exclude_self on synthetic: 1 run x 2 epochs, launches {counts_x}, final test "
        f"{res_x.best_by_valid()['final_test'][0]:.2f}")
    return counts, per_epoch


def hidden512_protocol(card, tmp, dev):
    """--MLP_hidden 512 through the CLI at the walmart preset (8 heads, f32,
    the width of the 512-wide tuned presets): 20 runs x 2 epochs through
    K2R/K3R at HC 512 (launches per group and epoch as at 256), finite
    metrics, a falling training loss, the peak device memory per folded
    run against the trainer's estimate (which must not be lower), then 2
    runs folded against 2 one by one. Returns the counts."""
    base = ["--dname", WALMART, "--preset", "--MLP_hidden", "512", "--dtype", "float32",
            "--device", "cuda", "--res_root", tmp]
    epochs = 2
    res, counts, peak, est = cli_peak(base + ["--epochs", str(epochs)], epochs, None, dev,
                                      mlp_hidden=512)
    loss = res.metrics[:, :, 3].mean(axis=0)
    log(f"  --MLP_hidden 512: {res.metrics.shape[0]} runs in groups {res.groups}; launches "
        f"{counts}; params {res.num_params}; mean training loss per epoch "
        f"{[round(float(v), 6) for v in loss]}; {res.wall_time / epochs * 1e3:.1f} ms per "
        f"epoch over {epochs} epochs (first included) [{card}]")
    require(loss[-1] < loss[0], "--MLP_hidden 512: training loss did not fall")
    log(f"  --MLP_hidden 512: peak device memory per folded run {peak / 2**30:.3f} GiB; the "
        f"trainer's estimate {est / 2**30:.3f} GiB [{card}]")
    require(est >= peak, "--MLP_hidden 512: the trainer's estimate is below the measured peak")
    folded_vs_one_by_one(base + ["--runs", "2", "--epochs", "2"], 2)
    return counts


def wide_protocol(card, tmp):
    """--MLP_hidden 1024 through the CLI at the walmart preset (8 heads,
    f32): 2 runs x 1 epoch through K2R/K3R's wide pair (launches per group
    and epoch as at 256), finite metrics. Returns the counts."""
    res, counts = cli_run(["--dname", WALMART, "--preset", "--MLP_hidden", "1024", "--dtype",
                           "float32", "--device", "cuda", "--runs", "2", "--epochs", "1",
                           "--res_root", tmp], 1)
    log(f"  --MLP_hidden 1024: {res.metrics.shape[0]} runs in groups {res.groups}; launches "
        f"{counts}; params {res.num_params}; {res.wall_time * 1e3:.1f} ms for the epoch "
        f"[{card}]")
    return counts


def folded_vs_one_by_one(argv, epochs, per=None):
    """2 runs folded into each launch against the same 2 runs one by one:
    equal accuracies, losses within rtol 2e-3."""
    import numpy as np

    folded, _ = cli_run(argv, epochs, per)
    seq, _ = cli_run(argv + ["--no_vmap_runs"], epochs, per)
    require(folded.groups == [2] and seq.groups == [1, 1], "2-run groups")
    require(np.array_equal(folded.metrics[..., :3], seq.metrics[..., :3]),
            "folded and sequential accuracies differ")
    rel = np.abs(folded.metrics[..., 3:] - seq.metrics[..., 3:]) / np.abs(seq.metrics[..., 3:])
    require(rel.max() <= 2e-3, f"folded and sequential losses differ: {rel.max()}")
    log(f"  2 runs x {epochs} epochs folded vs one by one: equal accuracies, losses within "
        f"{rel.max():.2e} (rtol 2e-3)")


def cli_peak(argv, epochs, per, dev, preset=True, **cfg):
    """One checked CLI run (walmart, f32; ``per`` as in cli_run) ->
    (Results, counts, the peak device memory per folded run, the trainer's
    estimate for the same configuration: the preset (unless ``preset`` is
    False) with ``cfg``, fields of ExperimentConfig, over it)."""
    from allset_tpu_torch.data import load_dataset
    from allset_tpu_torch.train import TrainConfig, Trainer
    from allset_tpu_torch.train.factory import ExperimentConfig, prepare
    from allset_tpu_torch.train.presets import preset_for

    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    res, counts = cli_run(argv, epochs, per)
    peak = (torch.cuda.max_memory_allocated(dev) - before) / max(res.groups)
    fields = ExperimentConfig.__dataclass_fields__
    tuned = {k: v for k, v in preset_for(WALMART, 1.0).items() if k in fields} if preset else {}
    data = load_dataset(WALMART, feature_noise=1.0, seed=0)
    mcfg, batch = prepare(ExperimentConfig(dname=WALMART, **{**tuned, **cfg}), data, dev)
    est = Trainer(mcfg, batch, TrainConfig())._bytes_per_run()
    del batch
    return res, counts, peak, est


def deepsets_protocol(card, tmp, dev):
    """AllDeepSets through the CLI at the walmart preset, f32: 20 runs
    folded for a few epochs (launches per group and epoch, finite metrics,
    a falling loss), three warm runs of 4 epochs (ms per epoch, first
    epoch of each included), 20 runs x 2 epochs with --LearnMask; the peak
    device memory per run of both against the trainer's estimate, which
    must not be lower; then 2 runs folded against 2 one by one. Returns
    the counts and the warm runs' median ms per epoch."""
    base = ["--method", "AllDeepSets", "--dname", WALMART, "--preset", "--dtype", "float32",
            "--device", "cuda", "--res_root", tmp]
    epochs = 3
    res, counts, peak, est = cli_peak(base + ["--epochs", str(epochs)], epochs,
                                      DEEPSETS_GROUP_EPOCH, dev, method="AllDeepSets")
    loss = res.metrics[:, :, 3].mean(axis=0)
    log(f"  AllDeepSets: {res.metrics.shape[0]} runs in groups {res.groups}; launches {counts} "
        f"(per group and epoch {DEEPSETS_GROUP_EPOCH}); params {res.num_params}")
    log(f"  mean training loss per epoch {[round(float(v), 6) for v in loss]}")
    require(loss[-1] < loss[0], "AllDeepSets: training loss did not fall")
    log(f"  AllDeepSets 20-run protocol: {res.wall_time / epochs * 1e3:.1f} ms per epoch over "
        f"{epochs} epochs (first epoch of the process included) [{card}]")
    warm = []
    for _ in range(3):
        res_w, _ = cli_run(base + ["--epochs", "4"], 4, DEEPSETS_GROUP_EPOCH)
        warm.append(res_w.wall_time / 4 * 1e3)
    log(f"  AllDeepSets 20-run protocol, warm: {[round(w, 3) for w in warm]} ms per epoch "
        f"(three runs of 4 epochs, groups {res_w.groups}); median {statistics.median(warm):.3f}, "
        f"spread {max(warm) - min(warm):.3f} ms [{card}]")
    res_m, counts_m, peak_m, est_m = cli_peak(base + ["--epochs", "2", "--LearnMask"], 2,
                                              DEEPSETS_GROUP_EPOCH, dev, method="AllDeepSets",
                                              learn_mask=True)
    log(f"  AllDeepSets --LearnMask: {res_m.metrics.shape[0]} runs in groups {res_m.groups}; "
        f"launches {counts_m}; {res_m.wall_time / 2 * 1e3:.1f} ms per epoch over 2 epochs "
        f"(first included) [{card}]")
    for what, pk, e in (("AllDeepSets", peak, est), ("AllDeepSets --LearnMask", peak_m, est_m)):
        log(f"  {what}: peak device memory per folded run {pk / 2**30:.3f} GiB; the trainer's "
            f"estimate {e / 2**30:.3f} GiB [{card}]")
        require(e >= pk, f"{what}: the trainer's estimate is below the measured peak")
    folded_vs_one_by_one(base + ["--runs", "2", "--epochs", "3"], 3, DEEPSETS_GROUP_EPOCH)
    return counts, statistics.median(warm)


def route_runs(card, tmp):
    """A shape the epilogue kernels refuse and the JAX package composes
    too, through the CLI on the card: --MLP_num_layers 3 (walmart preset,
    2 runs x 2 epochs) takes the plain epilogue; K1, K4, K5 still launch,
    K2R/K3R never."""
    base = ["--dname", WALMART, "--preset", "--dtype", "float32", "--device", "cuda",
            "--res_root", tmp, "--runs", "2", "--epochs", "2"]
    flags = ["--MLP_num_layers", "3"]
    res, counts = cli_run(base + flags, 2, PLAIN_ROUTE_GROUP_EPOCH)
    log(f"  {' '.join(flags)}: epilogue on the plain route; launches {counts}; params "
        f"{res.num_params}; final test {res.best_by_valid()['final_test'][0]:.2f}; "
        f"{res.wall_time / 2 * 1e3:.1f} ms per epoch [{card}]")


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


TIE_MARGIN = 1e-5  # a relu or leaky_relu argument closer to 0 is a tie


def tied_nodes(model, batch, margin=TIE_MARGIN):
    """Nodes whose loss reaches a relu or leaky_relu argument within
    ``margin`` of 0 in a forward of ``model`` (one run) on ``batch``.

    At such an argument the derivative jumps, and two correct
    implementations that round in another order may take opposite sides
    (PERF.md, Findings): one element moves the gradient of every
    parameter its row reaches. A loss without these nodes gives the tied
    rows a zero cotangent on both sides, as relu_safe does for K3. The
    arguments: each PMA's seed scores (by source row), its epilogue's rFF
    and folded-relu arguments (by destination row), and the relus of the
    MLPs and of GPR (by node). A destination row is tainted when it holds
    a tie or gathers a tainted source row."""
    from allset_tpu_torch.nn import modules
    from allset_tpu_torch.ops import cuda_pma as cp
    from allset_tpu_torch.ops.exchange import dir_spmm

    def near(t):
        return (t.detach().float().abs() < margin).reshape(t.shape[0], -1).any(dim=1)

    pmas, node_ties = [], []  # per PMA: [score ties, Direction, epilogue ties]
    orig = modules.pma_pack, modules.dir_spmm, modules.pma_epilogue

    def pack(yf, bV, ba, H):
        HC = bV.shape[0]
        pmas.append([near(yf[:, HC:HC + H].float() + ba)])
        return orig[0](yf, bV, ba, H)

    def spmm(w, d):
        pmas[-1].append(d)
        return orig[1](w, d)

    def epilogue(agg, seed, g0, b0, W, b, g1, b1, H, relu):
        rec = cp._fwd_recompute(agg, seed, g0, b0, W, b, g1, b1, H)
        tie = near(rec["y"]) if relu else torch.zeros_like(rec["y"][:, 0], dtype=torch.bool)
        for p in rec["pres"]:
            tie |= near(p)
        pmas[-1].append(tie)
        return orig[2](agg, seed, g0, b0, W, b, g1, b1, H, relu)

    relu_args = [getattr(m, f"lin{i}") for m in model.modules()
                 if isinstance(m, modules.MLP) for i in range(m.num_layers - 1)]
    if hasattr(model, "gpr_mlp"):
        relu_args.append(model.gpr_mlp)
    hooks = [m.register_forward_hook(lambda m, i, o: node_ties.append(near(o)))
             for m in relu_args]
    modules.pma_pack, modules.dir_spmm, modules.pma_epilogue = pack, spmm, epilogue
    try:
        with torch.no_grad():
            model(batch, False)
    finally:
        modules.pma_pack, modules.dir_spmm, modules.pma_epilogue = orig
        for h in hooks:
            h.remove()
    hit = None  # tainted rows of the current activation; the features have none
    for score_tie, d, epi_tie in pmas:
        src = score_tie if hit is None else score_tie | hit
        hit = (dir_spmm(src.float()[:, None].expand(-1, 8).contiguous(), d)[:, 0] > 0) | epi_tie
    if hit is None:
        hit = torch.zeros(batch.num_nodes, dtype=torch.bool, device=batch.x.device)
    for t in node_ties:
        hit |= t
    return hit


def tied_nodes_deepsets(model, batch, margin=TIE_MARGIN):
    """tied_nodes for AllDeepSets: the relu arguments are the outputs of
    every lin a relu follows (the MLPs' hidden lins, and f_enc's and
    f_dec's last lins, which the half-layer's relus follow), taken in the
    order the forward runs them. A tie marks its row of the current table;
    each exchange carries the marks to the destination rows their entries
    reach; the last table is the nodes'."""
    from allset_tpu_torch.nn import modules

    def near(t):
        return (t.detach().float().abs() < margin).reshape(t.shape[0], -1).any(dim=1)

    events = []
    orig = modules.dir_spmm

    def spmm(w, d, **kw):
        events.append(("exchange", d))
        return orig(w, d, **kw)

    ends = {m for h in model.modules() if isinstance(h, modules.HalfNLHconv)
            for m in (getattr(h, "f_enc", None), getattr(h, "f_dec", None)) if m is not None}
    lins = [getattr(m, f"lin{i}") for m in model.modules() if isinstance(m, modules.MLP)
            for i in range(m.num_layers) if i < m.num_layers - 1 or m in ends]
    hooks = [m.register_forward_hook(lambda m, i, o: events.append(("tie", near(o))))
             for m in lins]
    modules.dir_spmm = spmm
    try:
        with torch.no_grad():
            model(batch, False)
    finally:
        modules.dir_spmm = orig
        for h in hooks:
            h.remove()
    hit = torch.zeros(batch.num_nodes, dtype=torch.bool, device=batch.x.device)
    for kind, v in events:
        if kind == "tie":
            require(v.shape == hit.shape, "tied_nodes_deepsets: a tie on another table")
            hit = hit | v
        else:
            hit = orig(hit.float()[:, None].expand(-1, 8).contiguous(), v)[:, 0] > 0
    return hit


def small_parity(dev, **mode):
    """One f32 step through the kernels (card) against one through the
    plain versions (CPU), from the same parameters; ``mode`` as in
    main_path (pma=False: AllDeepSets). The loss is taken on the even nodes less tied_nodes. The
    losses agree to 1e-5, and every gradient, scaled by its tensor's max
    |.|, to 1e-3."""
    from allset_tpu_torch.data import synthetic_hypergraph
    from allset_tpu_torch.graph import Batch, add_self_loops, norm_construction
    from allset_tpu_torch.models import SetGNN, SetGNNConfig
    from allset_tpu_torch.train import masked_nll

    hd = synthetic_hypergraph(num_nodes=3000, num_hyperedges=1500,
                              feature_dim=64, seed=3)
    hd = norm_construction(add_self_loops(hd), "all_one")
    label = ", ".join(f"{k}={v}" for k, v in mode.items()) or "bench step"
    built = {}
    for device in ("cpu", dev):
        batch = Batch.from_hyperdata(hd, device=device)
        cfg = SetGNNConfig(num_features=64, num_classes=4, all_num_layers=1,
                           mlp_hidden=128, classifier_num_layers=1, heads=4,
                           dropout=0.0, nnz_padded=batch.inc.nnz_padded, **mode)
        built[device] = SetGNN(cfg, torch.Generator().manual_seed(5)).to(device), batch
    # a tie on either device: each rounds its arguments its own way
    ties = tied_nodes if mode.get("pma", True) else tied_nodes_deepsets
    tied = torch.stack([ties(*built[d]).cpu() for d in built]).any(dim=0)
    even = torch.arange(hd.num_nodes) % 2 == 0
    mask = even & ~tied
    log(f"  [{label}] {int((even & tied).sum())} of {int(even.sum())} loss nodes left out: "
        f"a relu argument within {TIE_MARGIN:g} of 0 upstream")
    out = {}
    for device, (model, batch) in built.items():
        loss = masked_nll(model(batch, False), batch.y, mask.to(device))
        loss.backward()
        out[str(device)] = (loss.item(),
                            {k: p.grad.cpu() for k, p in model.named_parameters()})
    (l_ref, g_ref), (l_k, g_k) = out["cpu"], out[str(dev)]
    rel = abs(l_k - l_ref) / abs(l_ref)
    log(f"  [{label}] small f32 step: loss kernel {l_k:.7f} plain {l_ref:.7f} rel {rel:.2e} "
        f"(tol 1e-5)")
    require(rel <= 1e-5, f"{label}: small-graph loss disagrees")
    worst = (0.0, "")
    for k in g_ref:
        scale = max(g_ref[k].abs().max().item(), 1e-6)
        e = (g_k[k] - g_ref[k]).abs().max().item() / scale
        require(e <= 1e-3, f"{label}: gradient {k} disagrees: {e}")
        worst = max(worst, (e, k))
    log(f"  [{label}] small f32 step: worst scaled gradient error {worst[0]:.2e} ({worst[1]}; "
        f"tol 1e-3 for each tensor)")


# --- B10, the row gather ----------------------------------------------------


GATHER_WIDTHS = (1, 8, 256, 264, 5280, 20 * 264)


def check_gather(dev, gen):
    """B10 against its plain version bit for bit (a gather is exact): f32
    and bf16, W in GATHER_WIDTHS (20 x 264: a folded table), int32 and
    int64 ids, with ids at -1, at ``rows`` and past it (clamped) among the
    ids below; narrow rows on a view whose rows lose 16-byte alignment
    (the 2- and 4-byte paths)."""
    from allset_tpu_torch.ops import _kernels, cuda_gather as cg

    rows = 3000
    for dtype in (torch.float32, torch.bfloat16):
        for W in GATHER_WIDTHS:
            table = torch.randn(rows, W, generator=gen).to(dtype).to(dev)
            ids = torch.randint(0, rows, (20_011,), generator=gen)
            ids[::97], ids[1::101], ids[2::103] = rows, rows + 5, -1
            for idt in (torch.int32, torch.int64):
                i = ids.to(idt).to(dev)
                got = cg.gather_fwd_cuda(table, i)
                want = cg.gather_fwd_plain(table, i)
                torch.cuda.synchronize()
                require(torch.equal(got, want), f"B10 differs ({dtype}, W={W}, {idt})")
            log(f"  B10 gather {str(dtype)[6:]:8s} W={W:4d}: bit-equal to the plain version "
                f"(int32 and int64 ids, clamped ids at -1, {rows} and {rows + 5})")
        for W in (3, 5):  # rows of 6 to 20 bytes, offset by one row: no 16-byte alignment
            base = torch.randn(rows + 1, W, generator=gen).to(dtype).to(dev)
            table = base[1:]
            i = torch.randint(0, rows + 2, (4099,), generator=gen).to(dev)
            require(torch.equal(cg.gather_fwd_cuda(table, i), cg.gather_fwd_plain(table, i)),
                    f"B10 differs on an unaligned view ({dtype}, W={W})")
        log(f"  B10 gather {str(dtype)[6:]:8s} W=3, 5 on a view offset by one row: bit-equal")
    _kernels.reset_launches()


# B9's row widths in bytes (4 B to 1 KiB), as f32 and bf16 columns
SORTED_ROW_BYTES = (4, 8, 16, 32, 64, 256, 1024)


def sorted_ids_with_hub(rows, n, gen, hub=10_000):
    """n ids sorted ascending: runs of random lengths with gaps between
    them, one run of ``hub`` equal ids, and ids below 0 and at or past
    ``rows`` at the two ends (clamped)."""
    ids = torch.randint(-3, rows + 3, (n - hub,), generator=gen)
    ids = torch.cat([ids, torch.full((hub,), rows // 3)])
    return ids.sort().values


def check_gather_sorted(dev, gen):
    """B9 against its plain version bit for bit (a gather is exact): f32
    and bf16 tables with rows of 4 B to 1 KiB (SORTED_ROW_BYTES; also 2 and
    6 B bf16 rows), sorted ids with gaps, a hub run of 10,000 equal ids and
    ids past both ends, the same ids unsorted, int32 and int64 ids; a
    chunk's rows over the 32 KB stage (1 KiB rows from unsorted ids) in
    passes."""
    from allset_tpu_torch.ops import _kernels, cuda_gather as cg

    rows, n = 5000, 60_013
    sorted_ids = sorted_ids_with_hub(rows, n, gen)
    shuffled = sorted_ids[torch.randperm(n, generator=gen)]
    require(int(sorted_ids[0]) < 0 and int(sorted_ids[-1]) >= rows, "ids past both ends")
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.tensor([], dtype=dtype).element_size()
        widths = sorted({b // item for b in SORTED_ROW_BYTES} | ({1, 3} if item == 2 else set()))
        for W in widths:
            table = torch.randn(rows, W, generator=gen).to(dtype).to(dev)
            for what, ids in (("sorted", sorted_ids), ("unsorted", shuffled)):
                for idt in (torch.int32, torch.int64):
                    i = ids.to(idt).to(dev)
                    got = cg.gather_sorted_fwd_cuda(table, i)
                    want = cg.gather_sorted_fwd_plain(table, i)
                    torch.cuda.synchronize()
                    require(torch.equal(got, want),
                            f"B9 differs ({dtype}, {W * item} B rows, {what}, {idt})")
            log(f"  B9 sorted gather {str(dtype)[6:]:8s} rows of {W * item:4d} B: bit-equal to "
                f"the plain version ({n} ids sorted with a 10,000-id hub run and unsorted; "
                f"int32 and int64; clamped ids below 0 and past {rows})")
    _kernels.reset_launches()


def check_segment_sum_gather(dev, gen):
    """The gather inside K1 bit for bit against the pair it replaces (B10's
    gather, the scale in the rows' dtype, K1) and against its plain
    version in the kernel's order of additions: f32 and bf16; W 8, 264,
    384 and 20 x 264 (with a runs-axis norm [20, k] too); no norm and a
    per-entry norm; empty segments, a hub segment of 50,000 entries (cut
    over 782 chunks), ids with gaps (a third of the table's rows never
    read) and clamped ids at -1 and past the last row; W 13 through the
    padding wrapper against the pair's route; the identity CSR
    (indptr = arange(n + 1)) against index_select, as B11's take."""
    from allset_tpu_torch.graph.incidence import chunk_plan
    from allset_tpu_torch.ops import _kernels, cuda_gather as cg, cuda_segment as cs

    rows, nseg = 3000, 3000
    counts = torch.randint(0, 7, (nseg,), generator=gen)
    counts[torch.rand(nseg, generator=gen) < 0.3] = 0
    counts[1234] = 50_000
    indptr = torch.zeros(nseg + 1, dtype=torch.int32)
    indptr[1:] = torch.cumsum(counts, 0)
    k = int(indptr[-1])
    plan = chunk_plan(indptr.numpy()).to(dev)
    used = torch.randperm(rows, generator=gen)[: 2 * rows // 3]
    ids = used[torch.randint(0, used.shape[0], (k,), generator=gen)]
    ids[::97], ids[1::101] = -1, rows + 5
    ids, ip = ids.to(dev), indptr.to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        for W in (8, 264, 384, 20 * 264):
            w = torch.randn(rows, W, generator=gen).to(dtype).to(dev)
            norms = [None, torch.rand(k, generator=gen).to(dev)]
            if W == 20 * 264:
                norms.append(torch.rand(20, k, generator=gen).to(dev))
            for n in norms:
                got = cs.gather_segment_sum_cuda(w, ids, ip, nseg, plan, n)
                rows_g = cg.gather_fwd_cuda(w, ids)
                pair = cs.segment_sum_cuda(rows_g if n is None else cs.scale_rows(rows_g, n),
                                           ip, nseg, plan)
                ordered = cs.gather_segment_sum_planned(w, ids, ip, nseg, plan, n)
                torch.cuda.synchronize()
                what = f"{dtype}, W={W}, norm {None if n is None else tuple(n.shape)}"
                require(torch.equal(got, pair), f"segment_sum_gather differs from B10 + K1 ({what})")
                require(torch.equal(got, ordered),
                        f"segment_sum_gather differs from its order of additions ({what})")
                del got, rows_g, pair, ordered
            log(f"  segment_sum_gather {str(dtype)[6:]:8s} W={W:4d}: bit-equal to B10 + scale + "
                f"K1 and to the planned order (no norm, per entry{', [20, k]' if W > 384 else ''};"
                f" {k} ids, a 50,000-entry hub, empty segments, clamped ids)")
        w = torch.randn(rows, 13, generator=gen).to(dtype).to(dev)
        n = torch.rand(k, generator=gen).to(dev)
        got = cs.gather_segment_sum(w, ids, ip, nseg, plan, n)
        pair = cs.segment_sum(cs.scale_rows(cg.gather_fwd(w, ids), n), ip, nseg, plan)
        require(torch.equal(got, pair), f"segment_sum_gather differs at W=13 ({dtype})")
        table = torch.randn(rows, 264, generator=gen).to(dtype).to(dev)
        n_id = 20_011
        idn = torch.randint(-3, rows + 3, (n_id,), generator=gen).to(dev)
        eye = torch.arange(n_id + 1, dtype=torch.int32)
        got = cs.gather_segment_sum_cuda(table, idn, eye.to(dev), n_id,
                                         chunk_plan(eye.numpy()).to(dev))
        require(torch.equal(got, table.index_select(0, idn.clamp(0, rows - 1))),
                f"segment_sum_gather on the identity CSR differs from index_select ({dtype})")
        log(f"  segment_sum_gather {str(dtype)[6:]:8s}: W=13 (padded) bit-equal to the pair; the "
            f"identity CSR ({n_id} ids, clamped) bit-equal to index_select")
    _kernels.reset_launches()


def onehot_case(nnz, nseg, s_blk, chunk, F, dtype, dev, gen, padded=True):
    """Sorted random ids over nseg segments padded to a multiple of s_blk
    (padding id past the last block), msgs with the spare chunk
    (``padded``) or ending at the last entry (the kernel's zero rows)."""
    from allset_tpu_torch.ops import cuda_onehot as co

    ids = torch.randint(0, nseg, (nnz,), generator=gen).sort().values.to(torch.int32)
    m_pad = -(-nseg // s_blk) * s_blk
    rows = co.pad_for_kernel(nnz, chunk) if padded else nnz
    dst = torch.full((rows,), m_pad + 7, dtype=torch.int32)
    dst[:nnz] = ids
    msgs = torch.randn(rows, F, generator=gen).to(dtype)
    return (msgs.to(dev), dst.to(dev), co.block_indptr(ids, m_pad, s_blk).to(dev), m_pad)


def onehot_variants():
    """(label, s_blk, keywords) of every B1-family variant: B1, B2's
    buffers, B3's accumulator sets, B4's builds, B6's modes."""
    from allset_tpu_torch.ops import cuda_onehot as co

    return ([("B1", 64, {})] + [(f"B2 nbuf={n}", 256, {"nbuf": n}) for n in co.NBUFS]
            + [(f"B3 nacc={n}", 256, {"nacc": n}) for n in co.NACCS]
            + [(f"B4 build {b}", 256, {"build": b}) for b in co.BUILDS]
            + [(f"B6 {m}", 256, {"mode": m}) for m in co.MODES])


def check_segsum_onehot(dev, gen):
    """Every B1-family variant against its plain version (ONEHOT_TOL):
    f32 and bf16, 30,011 entries over 1,000 segments (padded to the
    block), chunks of 512 rows; msgs with the spare chunk and, for the
    first variant of each block size, ending at the last entry (rows past
    it read as zeros with no id)."""
    from allset_tpu_torch.experiments.common import ONEHOT_TOL
    from allset_tpu_torch.ops import _kernels, cuda_onehot as co

    for dtype, F in ((torch.float32, 192), (torch.bfloat16, 384)):
        cases = {}
        worst = 0.0
        for label, s_blk, kw in onehot_variants():
            for padded in (True, False) if (s_blk, True) not in cases else (True,):
                key = (s_blk, padded)
                if key not in cases:
                    cases[key] = onehot_case(30_011, 1000, s_blk, 512, F, dtype, dev, gen, padded)
                msgs, dst, bip, m_pad = cases[key]
                got = co.segsum_onehot_cuda(msgs, dst, bip, m_pad, s_blk, 512, **kw)
                want = co.segsum_onehot_plain(msgs, dst, bip, m_pad, s_blk, 512, **kw)
                torch.cuda.synchronize()
                _, rel = scaled_err(got, want)
                require(rel <= ONEHOT_TOL, f"segsum_onehot {label} disagrees ({dtype}, "
                        f"{'padded' if padded else 'unpadded'}): {rel}")
                worst = max(worst, rel)
        log(f"  segsum_onehot {str(dtype)[6:]:8s} F={F}: {len(onehot_variants())} variants (B1, "
            f"B2 nbuf {co.NBUFS}, B3 nacc {co.NACCS}, B4 builds {co.BUILDS}, B6 {co.MODES}) "
            f"within {worst:.2e} of the plain versions (tol {ONEHOT_TOL:g})")
    _kernels.reset_launches()


def check_stream(dev, gen):
    """B5, B7 and B8 (fold and first 16 rows) against their plain
    versions within 1e-5 scaled: f32 and bf16, [70 x 512 + 3, 384] rows
    (a ragged tail past the whole blocks), chunks of 512 and 1,024."""
    from allset_tpu_torch.ops import _kernels, cuda_stream as cst

    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(70 * 512 + 3, 384, generator=gen).to(dtype).to(dev)
        y = torch.randn(70 * 512 + 3, 384, generator=gen).to(dtype).to(dev)
        seed = torch.randn(16, 384, generator=gen).to(dev)
        worst = 0.0
        for c in (512, 1024):
            for name, fn, plain in (
                    ("B5", lambda: cst.stream_flat(x, seed, c),
                     lambda: cst.stream_flat_plain(x, seed, c)),
                    ("B7", lambda: cst.stream_dual(x, y, seed, c),
                     lambda: cst.stream_dual_plain(x, y, seed, c)),
                    ("B8 fold", lambda: cst.stream_fold(x, seed, c),
                     lambda: cst.stream_fold_plain(x, seed, c)),
                    ("B8 first16", lambda: cst.stream_fold(x, seed, c, "first16"),
                     lambda: cst.stream_fold_plain(x, seed, c, "first16"))):
                got, want = fn(), plain()
                torch.cuda.synchronize()
                _, rel = scaled_err(got, want)
                require(rel <= 1e-5, f"{name} disagrees ({dtype}, chunk {c}): {rel}")
                worst = max(worst, rel)
        log(f"  stream {str(dtype)[6:]:8s}: B5, B7, B8 fold and first16 at chunks 512 and 1024 "
            f"within {worst:.2e} of the plain versions (tol 1e-5)")
    _kernels.reset_launches()


def gather_cost(rows, n, W, item, id_item=8):
    """(bytes, ops) of B10: the [rows, W] table read once, the [n, W]
    output written once, and the ids."""
    return (rows + n) * W * item + n * id_item, []


def time_gather(tally, table, ids, launches):
    """B10 on ``table`` by ``ids``: kernel, plain and index_select times (the
    library call, on the ids clamped beforehand), held bit for bit to the
    plain version; added to ``tally`` for ``launches`` launches. Returns
    (kernel ms, index_select ms)."""
    from allset_tpu_torch.ops import cuda_gather as cg

    k = cuda_ms(lambda: cg.gather_fwd_cuda(table, ids), iters=20)
    p = cuda_ms(lambda: cg.gather_fwd_plain(table, ids), iters=5)
    clamped = ids.clamp(0, table.shape[0] - 1)
    lib = cuda_ms(lambda: table.index_select(0, clamped), iters=20)
    require(torch.equal(cg.gather_fwd_cuda(table, ids), cg.gather_fwd_plain(table, ids)),
            f"B10 differs at [{ids.shape[0]}, {table.shape[1]}]")
    tally.add(launches, k, p, 0.0, *gather_cost(table.shape[0], ids.shape[0], table.shape[1],
                                               table.element_size(), ids.element_size()),
              library_ms=lib)
    return k, lib


def time_gather_step(batches, dev):
    """B10 and K1 per UniGAT bench step: the row gathers and sorted sums of
    one training step are recorded (shapes and dtype, the ids or the
    indptr and plan), as many as zoo_launches predicts, then each is timed
    at its shape on random inputs, summed per step (K1 also held bit for
    bit to its plain version in its order, with torch.segment_reduce as
    its library call). Returns {"gather": Tally, "segment_sum": Tally}."""
    from allset_tpu_torch.ops import _kernels, cuda_gather as cg, cuda_segment as cs

    model, batch, mask = zoo_model(batches, dev, "UniGAT", dict(ZOO)["UniGAT"])
    calls, sums = [], []
    orig, orig_sum = cg.gather_fwd_cuda, cs.segment_sum_cuda

    def record(table, ids):
        calls.append((tuple(table.shape), table.dtype, ids))
        return orig(table, ids)

    def record_sum(msgs, indptr, nseg, plan):
        sums.append((tuple(msgs.shape), msgs.dtype, indptr, nseg, plan))
        return orig_sum(msgs, indptr, nseg, plan)

    cg.gather_fwd_cuda, cs.segment_sum_cuda = record, record_sum
    try:
        run_steps(model, batch, mask, 1)
    finally:
        cg.gather_fwd_cuda, cs.segment_sum_cuda = orig, orig_sum
    want = zoo_launches("UniGAT")
    require(len(calls) == want["gather"],
            f"a UniGAT step gathered {len(calls)} times, expected {want['gather']}")
    require(len(sums) == want["segment_sum"],
            f"a UniGAT step summed {len(sums)} times, expected {want['segment_sum']}")
    del model
    t = Tally()
    groups = {}
    for shape, dtype, ids in calls:  # the same ids and table shape: timed once
        key = (shape, dtype, ids.data_ptr(), ids.shape[0], ids.dtype)
        groups.setdefault(key, [shape, dtype, ids, 0])[3] += 1
    for shape, dtype, ids, n in groups.values():
        table = torch.randn(shape, device=dev).to(dtype)
        k, lib = time_gather(t, table, ids, n)
        log(f"  B10 at [{ids.shape[0]}, {list(shape[1:])}] {str(dtype)[6:]} from {shape[0]} rows "
            f"(x{n} per step): kernel {k:.4f} ms, index_select {lib:.4f} ms")
    k1 = Tally()
    groups = {}
    for shape, dtype, indptr, nseg, plan in sums:
        key = (shape, dtype, indptr.data_ptr(), nseg)
        groups.setdefault(key, [shape, dtype, indptr, nseg, plan, 0])[5] += 1
    for shape, dtype, indptr, nseg, plan, n in groups.values():
        msgs = torch.randn(shape, device=dev).to(dtype)
        k = cuda_ms(lambda: cs.segment_sum_cuda(msgs, indptr, nseg, plan), iters=10)
        p = cuda_ms(lambda: cs.segment_sum_plain(msgs, indptr, nseg), iters=3)
        lib_fn, lib_name = library_segment_sum(msgs, indptr, nseg)
        lib = cuda_ms(lib_fn, iters=3)
        got = cs.segment_sum_cuda(msgs, indptr, nseg, plan)
        require(torch.equal(got, cs.segment_sum_planned(msgs, indptr, nseg, plan)),
                f"K1 differs from its order of additions at {list(shape)}")
        e, rel = scaled_err(got, cs.segment_sum_plain(msgs, indptr, nseg))
        require(rel <= TOL[dtype][0], f"K1 disagrees at {list(shape)}: {rel}")
        k1.add(n, k, p, e, *seg_cost(int(indptr[-1]), nseg, shape[1], dtype), library_ms=lib)
        log(f"  K1 at {list(shape)} {str(dtype)[6:]} -> {nseg} segments (x{n} per step): kernel "
            f"{k:.4f} ms, plain {p:.3f} ms, {lib_name} {lib:.4f} ms; bit-equal to its order")
        del msgs, got
    _kernels.reset_launches()
    return {"gather": t, "segment_sum": k1}


def time_gather_sorted_step(batches, dev):
    """B9 per CEGAT bench step: the sorted gathers of one training step
    are recorded (table shape and dtype, the ids), as many as
    ce_gat_launches predicts, then each is timed at its shape on a random
    table with B9, B10 and index_select (on the ids clamped beforehand),
    held bit for bit to the plain version, summed per step; the bound
    counts each distinct row read once, each output row written once and
    the ids. Returns {"gather_sorted": Tally} (B10's time at the same
    shapes is logged)."""
    from allset_tpu_torch.ops import _kernels, cuda_gather as cg

    model, batch, mask = zoo_model(batches, dev, "CEGAT", dict(CE)["CEGAT"])
    calls, orig = [], cg.gather_sorted_fwd_cuda

    def record(table, ids):
        calls.append((tuple(table.shape), table.dtype, ids))
        return orig(table, ids)

    cg.gather_sorted_fwd_cuda = record
    try:
        run_steps(model, batch, mask, 1)
    finally:
        cg.gather_sorted_fwd_cuda = orig
    want = zoo_launches("CEGAT")["gather_sorted"]
    require(len(calls) == want, f"a CEGAT step gathered sorted {len(calls)} times, expected {want}")
    del model
    t, b10_total = Tally(), 0.0
    groups = {}
    for shape, dtype, ids in calls:  # the same ids and table shape: timed once
        key = (shape, dtype, ids.data_ptr(), ids.shape[0], ids.dtype)
        groups.setdefault(key, [shape, dtype, ids, 0])[3] += 1
    for shape, dtype, ids, n in groups.values():
        table = torch.randn(shape, device=dev).to(dtype)
        k = cuda_ms(lambda: cg.gather_sorted_fwd_cuda(table, ids), iters=20)
        b10 = cuda_ms(lambda: cg.gather_fwd_cuda(table, ids), iters=20)
        p = cuda_ms(lambda: cg.gather_sorted_fwd_plain(table, ids), iters=5)
        clamped = ids.clamp(0, shape[0] - 1)
        lib = cuda_ms(lambda: table.index_select(0, clamped), iters=20)
        require(torch.equal(cg.gather_sorted_fwd_cuda(table, ids),
                            cg.gather_sorted_fwd_plain(table, ids)),
                f"B9 differs at [{ids.shape[0]}, {list(shape[1:])}]")
        distinct = int(torch.unique(clamped).numel())
        nbytes = table[0].numel() * table.element_size()
        t.add(n, k, p, 0.0, (distinct + ids.shape[0]) * nbytes + ids.shape[0] * ids.element_size(),
              [], library_ms=lib)
        b10_total += n * b10
        log(f"  B9 at [{ids.shape[0]}, {list(shape[1:])}] {str(dtype)[6:]} from {shape[0]} rows "
            f"({distinct} distinct; x{n} per step): kernel {k:.4f} ms, B10 {b10:.4f} ms, "
            f"index_select {lib:.4f} ms, plain {p:.4f} ms")
    log(f"  B9's gathers per CEGAT step: B9 {t.ms:.4f} ms, B10 at the same shapes "
        f"{b10_total:.4f} ms")
    _kernels.reset_launches()
    return {"gather_sorted": t}


# --- the conv zoo ---------------------------------------------------------------

# (name, ExperimentConfig overrides) of the zoo's full-width bench steps
# (phase 4) and small-graph steps (phase 5): UniGAT at 8 heads of 32 (a
# concatenated width of 256). UniGIN and UniSAGE sum over the bench
# graph's hub (node 0, in 64,855 of the 65,536 hyperedges) into logits
# near 5e3, where 8 Adam steps at lr 1e-3 do not lower the loss, as the
# JAX model's do not (tests/test_torch_zoo.py, on a smaller hub graph);
# so their bench steps take the reference's --UniGNN_use_norm (each
# conv's rows L2-normalised), and phase 5 checks them also without it
# (HUB_CONVS). The CLI runs of phase 6 take no norm.
HUB_CONVS = tuple((n, dict(method="UniGNN", unignn_model_name=n)) for n in ("UniGIN", "UniSAGE"))
ZOO = (("HCHA", dict(method="HCHA")), ("HGNN", dict(method="HGNN")),
       ("HNHN", dict(method="HNHN")), ("UniGCNII", dict(method="UniGCNII")),
       ("MLP", dict(method="MLP")),
       ("UniGAT", dict(method="UniGNN", unignn_model_name="UniGAT", heads=8, mlp_hidden=32)),
       ("UniGCN", dict(method="UniGNN", unignn_model_name="UniGCN")),
       ("UniGCN2", dict(method="UniGNN", unignn_model_name="UniGCN2")),
       *((n, dict(over, unignn_use_norm=True)) for n, over in HUB_CONVS))


# the clique expansion's models and HyperGCN, at the bench width (phase 4,
# bf16; UniGAT's CEGAT counterpart at 8 heads of 32) and on the small graph
# (phase 5, f32)
CE = (("CEGCN", dict(method="CEGCN")),
      ("CEGAT", dict(method="CEGAT", heads=8, mlp_hidden=32)),
      ("HyperGCN", dict(method="HyperGCN")))


def zoo_launches(name, epoch=False):
    """The launches the code predicts per training step (forward, backward)
    or, with ``epoch``, per group and epoch (forward twice, train and
    eval, backward once) of a 2-conv zoo model. A dir_spmm pass is one
    launch of the gather inside K1 (``segment_sum_gather``), forward and
    backward, the backward only where its input needs a gradient (not
    UniGCN2's first conv, on the features); the MLP one LayerNorm per
    step; CEGCN and HyperGCN one dir_spmm per conv; UniGAT and CEGAT at
    the bench width as unigat_launches and ce_gat_launches count them (no
    dir_spmm: their sums and gathers are the segment ops' K1, B10, B9)."""
    nf = 2 if epoch else 1
    if name == "MLP":
        return {"layer_norm_fwd": nf, "layer_norm_bwd": 1}
    if name == "UniGAT":
        over = dict(ZOO)["UniGAT"]
        return unigat_launches(1, over["heads"], over["mlp_hidden"], 8, 2, epoch)
    if name in ("CEGCN", "HyperGCN"):
        return {"segment_sum_gather": 2 * nf + 2}
    if name == "CEGAT":
        over = dict(CE)["CEGAT"]
        return ce_gat_launches(1, over["heads"], over["mlp_hidden"], 8, 1, 2, epoch)
    fwd, bwd = 4, 2 if name == "UniGCN2" else 4
    return {"segment_sum_gather": nf * fwd + bwd}


def sorted_route(nbytes):
    """The counter of the kernel that gathers rows of ``nbytes`` bytes by
    sorted ids (cuda_gather.gather_route)."""
    from allset_tpu_torch.ops.cuda_gather import gather_route

    return {"sorted": "gather_sorted", "rows": "gather"}[gather_route(nbytes, True)]


def unigat_launches(R, heads, hidden, classes, item, epoch=False):
    """The launches of a 2-conv UniGAT per step or, with ``epoch``, per
    group of R runs and epoch (see zoo_launches): per conv of H heads of C
    channels, forward K1 3 times and B10 5 times (the node rows, the
    segment max and denominators by entry, the two permutations into the
    node-sorted order) and two gathers by the sorted hyperedge ids, of the
    [E, R*H] f32 edge scores and of the [E, R*H*C] edge rows; backward K1 5
    times, B10 5 times (the three permutations into the node-sorted
    order, the two sums by node's transposes) and one gather of [E,
    R*H*C] rows by the sorted hyperedge ids (the hyperedge reduce's
    transpose). A gather by sorted ids takes B9 where its row is narrow
    (sorted_route), else B10. The hidden conv has ``heads`` heads of
    ``hidden``, the output conv 1 head of ``classes``."""
    nf = 2 if epoch else 1
    out = {"segment_sum": 0, "gather": 0, "gather_sorted": 0}
    for H, C in ((heads, hidden), (1, classes)):
        out["segment_sum"] += 3 * nf + 5
        out["gather"] += 5 * nf + 5
        out[sorted_route(R * H * 4)] += nf
        out[sorted_route(R * H * C * item)] += nf + 1
    return out


def ce_gat_launches(R, heads, hidden, classes, out_heads, item, epoch=False):
    """The launches of a 2-conv CEGAT per step (forward, backward) or, with
    ``epoch``, per group of R runs and epoch (forward twice). Per conv,
    forward: B10 twice (the source scores in the node-sorted order, the
    source rows), K1 twice (the softmax's denominators, the sum by
    destination) and three gathers of [N, R*heads] f32 score rows by the
    sorted destination ids (a_dst, the segment max, the denominators);
    backward: K1 five times (the five gathers' transposes), B10 twice (the
    two permutations into the node-sorted order), and two gathers by the
    sorted destination ids (the denominators' sum's transpose, a score
    row; the sum by destination's transpose, a row of the conv's output).
    A gather by sorted ids takes B9 when its row has at most
    cuda_gather.NARROW_BYTES bytes, else B10 (gather_route)."""
    nf = 2 if epoch else 1
    out = {"segment_sum": 0, "gather": 0, "gather_sorted": 0}
    for H, C in ((heads, hidden), (out_heads, classes)):
        out["segment_sum"] += 2 * nf + 5
        out["gather"] += 2 * nf + 2
        out[sorted_route(R * H * 4)] += 3 * nf + 1
        out[sorted_route(R * H * C * item)] += 1
    return out


def zoo_batches(batch, hd, raw=None):
    """The bench batch with each zoo model's extras (the factory's host
    transforms on the same self-loop graph, without building the
    incidence again): HNHN's norms, UniGNN's degrees; with ``raw`` (the
    bench graph without its self-loops, as the CLI hands the factory
    every graph) also the V2V graphs of CEGCN and CEGAT and HyperGCN's
    Laplacian (its build's host time logged)."""
    import dataclasses

    from allset_tpu_torch.graph import Batch
    from allset_tpu_torch.graph.transforms import (generate_norm_hnhn, hypergcn_edge_dict,
                                                   unignn_degrees)
    from allset_tpu_torch.models.hypergcn import build_hypergcn_laplacian
    from allset_tpu_torch.train.factory import v2v_incidence

    dev = batch.x.device
    hn = {k: torch.as_tensor(v).to(dev) for k, v in generate_norm_hnhn(hd).extras.items()}
    degV, degE = unignn_degrees(hd)
    uni = {"degV": torch.as_tensor(degV).to(dev), "degE": torch.as_tensor(degE).to(dev)}
    out = {"HNHN": dataclasses.replace(batch, extras=hn),
           "Uni": dataclasses.replace(batch, extras=uni), "": batch}
    if raw is not None:
        for m in ("CEGCN", "CEGAT"):
            out[m] = Batch.from_incidence(raw, v2v_incidence(raw, m, bucket=1024), dev)
        t0 = time.perf_counter()
        lap = build_hypergcn_laplacian(raw.num_nodes, hypergcn_edge_dict(raw), raw.x,
                                       mediators=True, seed=0, bucket=1024)
        log(f"  V2V graph: {out['CEGAT'].inc.nnz} entries with the self-loops; HyperGCN's "
            f"Laplacian: {lap.nnz} entries, built on the host in "
            f"{time.perf_counter() - t0:.2f} s")
        out["HyperGCN"] = Batch.from_incidence(raw, lap, dev)
    return out


def zoo_model(batches, dev, name, over, seed=0):
    """Zoo model ``name`` at the bench width (bf16, hidden 256), its batch
    and the even nodes' mask."""
    from allset_tpu_torch.models import build_model
    from allset_tpu_torch.train.factory import ExperimentConfig, zoo_config

    batch = batches.get(name) or batches[
        "HNHN" if name == "HNHN" else "Uni" if name.startswith("Uni") else ""]
    mcfg = zoo_config(ExperimentConfig(**{"mlp_hidden": 256, "dropout": 0.0,
                                          "dtype": "bfloat16", **over}), 256, 8)
    mask = torch.arange(batch.num_nodes, device=dev) % 2 == 0
    return build_model(mcfg, torch.Generator().manual_seed(seed)).to(dev), batch, mask


def zoo_path(batches, dev, card, name, over):
    """8 bf16 bench steps of zoo model ``name`` at full width with every
    launch count set to 0 just before, checked against zoo_launches; a
    finite, falling loss; two runs from one state bit-identical. Returns
    the counts and the median step time."""
    from allset_tpu_torch.ops import _kernels

    steps = 8
    model, batch, mask = zoo_model(batches, dev, name, over)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    run_steps(zoo_model(batches, dev, name, over)[0], batch, mask, 1)
    _kernels.reset_launches()
    losses, times = run_steps(model, batch, mask, steps)
    counts = dict(_kernels.launches)
    per = zoo_launches(name)
    for k in _kernels.KERNELS:
        require(counts[k] == per.get(k, 0) * steps,
                f"{name}: {k} launched {counts[k]} times, expected {per.get(k, 0) * steps}")
    lo = losses.cpu()
    log(f"  [{name}] losses: {[round(v, 6) for v in lo.tolist()]}")
    require(bool(torch.isfinite(lo).all()), f"{name}: non-finite loss")
    require(lo[-1] < lo[0], f"{name}: loss did not fall")
    model2 = zoo_model(batches, dev, name, over, seed=1)[0]
    model2.load_state_dict(state)
    losses2, _ = run_steps(model2, batch, mask, steps)
    require(torch.equal(losses, losses2), f"{name}: two runs from one state differ")
    ms = statistics.median(times) * 1e3
    nnz = batch.inc.nnz
    log(f"  [{name}] launches over {steps} steps {counts}; two runs from one state "
        f"bit-identical; median "
        f"step {ms:.3f} ms; {nnz / (ms / 1e3):,.0f} edges/s [{card}] (smoke, not a benchmark)")
    del model, model2
    torch.cuda.empty_cache()
    return counts, ms


def tied_nodes_zoo(model, batch, margin=TIE_MARGIN):
    """Nodes whose loss reaches a relu, ELU or leaky_relu argument within
    ``margin`` of 0 in a forward of a zoo model (see tied_nodes). Events in
    forward order: a tie marks rows of the current table (nodes, hyperedge
    rows of an exchange's output, or a UniGAT score's entries, which mark
    the entry's node); each dir_spmm carries the marks to the rows its
    entries reach; a UniGAT conv carries its input's marks one hop (node,
    hyperedges, nodes) and adds its entries' marks. Marked nodes stay
    marked (skip connections and residuals keep a node's own value)."""
    from allset_tpu_torch.models import hcha, hnhn, unignn
    from allset_tpu_torch.ops.exchange import dir_spmm

    inc, N = batch.inc, batch.num_nodes

    def near(t):
        return (t.detach().float().abs() < margin).reshape(t.shape[0], -1).any(dim=1)

    events = []
    orig_relu, orig_elu = torch.relu, torch.nn.functional.elu
    orig_leaky, orig_spmm = unignn._leaky_relu, {m: m.dir_spmm for m in (hcha, hnhn, unignn)}

    def relu(x):
        events.append(("tie", near(x)))
        return orig_relu(x)

    def elu(x, *a, **k):
        events.append(("tie", near(x)))
        return orig_elu(x, *a, **k)

    def leaky(x, slope):
        events.append(("entry", near(x)))
        return orig_leaky(x, slope)

    def spmm(w, d, **kw):
        events.append(("exchange", d))
        return orig_spmm[hcha](w, d, **kw)

    hooks = [m.register_forward_pre_hook(lambda m, i: events.append(("gat_in", None)))
             for m in model.modules() if isinstance(m, unignn.UniGATConv)]
    hooks += [m.register_forward_hook(lambda m, i, o: events.append(("gat_out", None)))
              for m in model.modules() if isinstance(m, unignn.UniGATConv)]
    torch.relu, torch.nn.functional.elu, unignn._leaky_relu = relu, elu, leaky
    for m in orig_spmm:
        m.dir_spmm = spmm
    try:
        with torch.no_grad():
            model(batch, False)
    finally:
        torch.relu, torch.nn.functional.elu, unignn._leaky_relu = orig_relu, orig_elu, orig_leaky
        for m, f in orig_spmm.items():
            m.dir_spmm = f
        for h in hooks:
            h.remove()

    def hop(marks):  # nodes -> their hyperedges -> those hyperedges' nodes
        valid = inc.mask
        edges = torch.zeros(inc.num_edges + 1, dtype=torch.bool, device=marks.device)
        edges[inc.edge[valid][marks[inc.node[valid]]]] = True
        out = torch.zeros(N + 1, dtype=torch.bool, device=marks.device)
        out[inc.node[valid][edges[inc.edge[valid]]]] = True
        return out[:N]

    nodes = torch.zeros(N, dtype=torch.bool, device=batch.x.device)
    hit, gat_in, gat_entry = nodes.clone(), None, None
    for kind, v in events:
        if kind == "tie":
            if v.shape[0] == N:
                nodes |= v
                hit = nodes.clone()
            else:
                require(hit.shape == v.shape, "tied_nodes_zoo: a tie on another table")
                hit = hit | v
        elif kind == "exchange":
            src = hit.float()
            if src.shape[0] != v.num_src and v.sl_mode == "none":
                src = src[: v.num_src]
            hit = dir_spmm(src[:, None].expand(-1, 8).contiguous(), v)[:, 0] > 0
            if hit.shape[0] == N:
                nodes |= hit
                hit = nodes.clone()
        elif kind == "gat_in":
            gat_in, gat_entry = nodes.clone(), torch.zeros_like(nodes)
        elif kind == "entry":
            m = v & inc.mask
            gat_entry[inc.node[m]] = True
        else:  # gat_out
            nodes |= hop(gat_in) | gat_entry
            hit = nodes.clone()
    return nodes


def tied_nodes_ce(model, batch, margin=TIE_MARGIN):
    """Nodes whose loss reaches a relu or leaky_relu argument within
    ``margin`` of 0 in a forward of CEGCN, CEGAT or HyperGCN (see
    tied_nodes). A relu tie marks its rows (nodes); a GATConv's
    leaky_relu tie marks the entry's destination (its softmax and output
    row); a conv's output row reads the rows of its sources, so each conv
    carries the marks along the graph's entries (batch.inc: the V2V graph
    or the Laplacian, self-loops included). Marked nodes stay marked."""
    from allset_tpu_torch.models import cegnn, hypergcn

    inc, N = batch.inc, batch.num_nodes
    nodes = torch.zeros(N, dtype=torch.bool, device=batch.x.device)
    entry = nodes.clone()
    valid = inc.mask

    def near(t):
        return (t.detach().float().abs() < margin).reshape(t.shape[0], -1).any(dim=1)

    def hop(marks):  # sources -> destinations
        out = torch.zeros(N + 1, dtype=torch.bool, device=marks.device)
        out[inc.edge[valid][marks[inc.node[valid]]]] = True
        return out[:N]

    orig_relu, orig_leaky = torch.relu, cegnn._leaky_relu

    def relu(x):
        nodes.logical_or_(near(x))
        return orig_relu(x)

    def leaky(x, slope):
        entry[inc.edge[near(x) & valid]] = True
        return orig_leaky(x, slope)

    def conv_out(m, i, o):
        nodes.copy_(nodes | hop(nodes) | entry)
        entry.zero_()

    convs = (cegnn.GCNConv, cegnn.GATConv, hypergcn.HyperGCNLayer)
    hooks = [m.register_forward_hook(conv_out) for m in model.modules()
             if isinstance(m, convs)]
    torch.relu, cegnn._leaky_relu = relu, leaky
    try:
        with torch.no_grad():
            model(batch, False)
    finally:
        torch.relu, cegnn._leaky_relu = orig_relu, orig_leaky
        for h in hooks:
            h.remove()
    return nodes


def zoo_small_parity(dev, name, over):
    """One f32 step of zoo model ``name`` (hidden 64) through the kernels
    (card) against one through the plain versions (CPU), from the same
    parameters, as small_parity: the loss on the even nodes less
    tied_nodes_zoo within 1e-5, every gradient within 1e-3 of its tensor's
    max |.|."""
    from allset_tpu_torch.data import synthetic_hypergraph
    from allset_tpu_torch.models import build_model
    from allset_tpu_torch.train import masked_nll
    from allset_tpu_torch.train.factory import ExperimentConfig, prepare

    hd = synthetic_hypergraph(num_nodes=3000, num_hyperedges=1500, feature_dim=64, seed=3)
    cfg = ExperimentConfig(**{"mlp_hidden": 64, "dropout": 0.0, **over})
    built = {}
    for device in ("cpu", dev):
        mcfg, batch = prepare(cfg, hd, device)
        built[device] = build_model(mcfg, torch.Generator().manual_seed(5)).to(device), batch
    if name == "MLP":
        tied = torch.zeros(hd.num_nodes, dtype=torch.bool)
    else:
        ties = tied_nodes_ce if name in dict(CE) else tied_nodes_zoo
        tied = torch.stack([ties(*built[d]).cpu() for d in built]).any(dim=0)
    even = torch.arange(hd.num_nodes) % 2 == 0
    mask = even & ~tied
    out = {}
    for device, (model, batch) in built.items():
        loss = masked_nll(model(batch, False), batch.y, mask.to(device))
        loss.backward()
        out[str(device)] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()})
    (l_ref, g_ref), (l_k, g_k) = out["cpu"], out[str(dev)]
    rel = abs(l_k - l_ref) / abs(l_ref)
    require(rel <= 1e-5, f"{name}: small-graph loss disagrees: {rel}")
    worst = (0.0, "")
    for k in g_ref:
        scale = max(g_ref[k].abs().max().item(), 1e-6)
        e = (g_k[k] - g_ref[k]).abs().max().item() / scale
        require(e <= 1e-3, f"{name}: gradient {k} disagrees: {e}")
        worst = max(worst, (e, k))
    log(f"  [{name}] small f32 step: {int((even & tied).sum())} of {int(even.sum())} loss nodes "
        f"left out (a tie within {TIE_MARGIN:g} upstream); loss rel {rel:.2e} (tol 1e-5); "
        f"worst scaled gradient error {worst[0]:.2e} ({worst[1]}; tol 1e-3)")


ZOO_CLI = (("HGNN", ["--method", "HGNN"]), ("HCHA", ["--method", "HCHA"]),
           ("HNHN", ["--method", "HNHN"]), ("UniGCNII", ["--method", "UniGCNII"]),
           *((n, ["--method", "UniGNN", "--UniGNN_model_name", n])
             for n in ("UniGCN", "UniGAT", "UniGCN2", "UniGIN", "UniSAGE")),
           ("MLP", ["--method", "MLP"]))


def zoo_protocol(card, tmp, dev):
    """The zoo through the CLI on synthetic-walmart, f32, --MLP_hidden 256,
    20 runs x 2 epochs folded: launches per group and epoch as
    zoo_launches predicts, finite metrics, the peak device memory per
    folded run against the trainer's estimate (which must not be lower);
    HCHA also 2 runs folded against 2 one by one. Returns the counts of
    the UniGAT run."""
    import dataclasses

    from allset_tpu_torch.train.factory import ExperimentConfig

    base = ["--dname", WALMART, "--dtype", "float32", "--device", "cuda", "--MLP_hidden", "256",
            "--res_root", tmp]
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    out = {}
    from allset_tpu_torch.data import load_dataset

    classes = load_dataset(WALMART, feature_noise=1.0, seed=0).num_classes
    for name, flags in ZOO_CLI:
        per = (zoo_launches(name, epoch=True) if name != "UniGAT" else  # 1 head, by group
               lambda R: unigat_launches(R, 1, 256, classes, 4, epoch=True))
        cfg = {"method": flags[1], "mlp_hidden": 256}
        if "--UniGNN_model_name" in flags:
            cfg["unignn_model_name"] = flags[3]
        assert set(cfg) <= fields
        res, counts, peak, est = cli_peak(base + ["--epochs", "2", *flags], 2,
                                          per, dev,
                                          preset=False, **cfg)
        out[name] = counts
        log(f"  {name}: {res.metrics.shape[0]} runs in groups {res.groups}; launches {counts}; "
            f"params {res.num_params}; final test {res.best_by_valid()['final_test'][0]:.2f}; "
            f"{res.wall_time / 2 * 1e3:.1f} ms per epoch over 2 epochs (first included); peak "
            f"{peak / 2**30:.3f} GiB per folded run, estimate {est / 2**30:.3f} GiB [{card}]")
        require(est >= peak, f"{name}: the trainer's estimate is below the measured peak")
    folded_vs_one_by_one(base + ["--runs", "2", "--epochs", "2", "--method", "HCHA"], 2,
                         zoo_launches("HCHA", epoch=True))
    return out


def reapprox_steps(raw, dev, card, steps=2):
    """HyperGCN's reapprox path on the bench graph (f32, as the JAX model):
    ``steps`` training steps, each forward rebuilding both layers'
    Laplacians on the host from the current activations; launches as
    HyperGCN's fast step (one dir_spmm per layer), finite losses; the host
    build time per step is logged."""
    from allset_tpu_torch.graph import Batch
    from allset_tpu_torch.graph.transforms import hypergcn_edge_dict
    from allset_tpu_torch.models import build_model
    from allset_tpu_torch.ops import _kernels
    from allset_tpu_torch.train.factory import ExperimentConfig, zoo_config

    mcfg = zoo_config(ExperimentConfig(method="HyperGCN", hypergcn_fast=False, dropout=0.0), 256,
                      8, edge_dict=hypergcn_edge_dict(raw))
    batch = Batch.from_incidence(raw, None, dev)
    model = build_model(mcfg, torch.Generator().manual_seed(0)).to(dev)
    mask = torch.arange(batch.num_nodes, device=dev) % 2 == 0
    _kernels.reset_launches()
    losses, times = run_steps(model, batch, mask, steps)
    counts = dict(_kernels.launches)
    per = zoo_launches("HyperGCN")
    for k in _kernels.KERNELS:
        require(counts[k] == per.get(k, 0) * steps,
                f"HyperGCN reapprox: {k} launched {counts[k]} times, expected "
                f"{per.get(k, 0) * steps}")
    lo = losses.cpu()
    require(bool(torch.isfinite(lo).all()), "HyperGCN reapprox: non-finite loss")
    log(f"  [HyperGCN reapprox] losses {[round(v, 6) for v in lo.tolist()]}; launches over "
        f"{steps} steps {counts}; step times {[round(x * 1e3, 1) for x in times]} ms, of which "
        f"{model.host_seconds / steps * 1e3:.1f} ms per step rebuild two Laplacians on the "
        f"host [{card}]")
    return counts


def ce_protocol(card, tmp, dev):
    """CEGCN, CEGAT and HyperGCN through the CLI on synthetic-walmart,
    f32, --MLP_hidden 256, 20 runs x 2 epochs folded: launches per group
    and epoch as predicted (CEGAT's routes by each group's folded width),
    finite metrics, the peak device memory per folded run against the
    trainer's estimate (which must not be lower); CEGAT's 2 runs folded
    against 2 one by one; HyperGCN's reapprox path (--HyperGCN_fast false)
    on synthetic, 2 runs x 2 epochs, each run on its own structures.
    Returns the counts of the CEGAT run."""
    from allset_tpu_torch.data import load_dataset

    classes = load_dataset(WALMART, feature_noise=1.0, seed=0).num_classes
    base = ["--dname", WALMART, "--dtype", "float32", "--device", "cuda", "--MLP_hidden", "256",
            "--res_root", tmp]

    def gat(R):
        return ce_gat_launches(R, 1, 256, classes, 1, 4, epoch=True)

    out = {}
    for name in ("CEGCN", "CEGAT", "HyperGCN"):
        per = gat if name == "CEGAT" else zoo_launches(name, epoch=True)
        res, counts, peak, est = cli_peak(base + ["--epochs", "2", "--method", name], 2, per,
                                          dev, preset=False, method=name, mlp_hidden=256)
        out[name] = counts
        log(f"  {name}: {res.metrics.shape[0]} runs in groups {res.groups}; launches {counts}; "
            f"params {res.num_params}; final test {res.best_by_valid()['final_test'][0]:.2f}; "
            f"{res.wall_time / 2 * 1e3:.1f} ms per epoch over 2 epochs (first included); peak "
            f"{peak / 2**30:.3f} GiB per folded run, estimate {est / 2**30:.3f} GiB [{card}]")
        require(est >= peak, f"{name}: the trainer's estimate is below the measured peak")
    folded_vs_one_by_one(base + ["--runs", "2", "--epochs", "2", "--method", "CEGAT"], 2, gat)
    per_run = zoo_launches("HyperGCN", epoch=True)
    res, counts = cli_run(["--dname", "synthetic", "--method", "HyperGCN", "--HyperGCN_fast",
                           "false", "--runs", "2", "--epochs", "2", "--device", "cuda",
                           "--res_root", tmp], 2,
                          lambda R: {k: R * v for k, v in per_run.items()})
    log(f"  HyperGCN --HyperGCN_fast false on synthetic: {res.metrics.shape[0]} runs in groups "
        f"{res.groups}; launches {counts}; final test "
        f"{res.best_by_valid()['final_test'][0]:.2f}; {res.wall_time / 2 * 1e3:.1f} ms per "
        f"epoch [{card}]")
    return out


def time_layer_norm_epoch(tmp, dev, gen):
    """B12/B13 per AllDeepSets 20-run epoch (walmart preset, f32): the
    launches of one CLI epoch are recorded (shape, dtypes, whether dx is
    needed), then each is timed at its shape with inputs from ln_inputs:
    kernel and plain times, the bound, and F.layer_norm's forward (its
    autograd backward for B13) on the run's slice as the library call,
    times the runs. Returns {"layer_norm_fwd_epoch": Tally,
    "layer_norm_bwd_epoch": Tally} and the launches of that epoch."""
    import torch.nn.functional as tf

    from allset_tpu_torch.ops import _kernels, cuda_ln as cl

    calls = []
    orig = cl.ln_fwd_cuda, cl.ln_bwd_cuda

    def fwd(x, gamma, beta, ydt):
        calls.append(("fwd", tuple(x.shape), x.dtype, tuple(gamma.shape), ydt, True))
        return orig[0](x, gamma, beta, ydt)

    def bwd(g, x, gamma, need_dx=True):
        calls.append(("bwd", tuple(x.shape), x.dtype, tuple(gamma.shape), g.dtype, need_dx))
        return orig[1](g, x, gamma, need_dx)

    cl.ln_fwd_cuda, cl.ln_bwd_cuda = fwd, bwd
    try:
        _, counts = cli_run(["--method", "AllDeepSets", "--dname", WALMART, "--preset",
                             "--dtype", "float32", "--device", "cuda", "--epochs", "1",
                             "--res_root", tmp], 1, DEEPSETS_GROUP_EPOCH)
    finally:
        cl.ln_fwd_cuda, cl.ln_bwd_cuda = orig
    out = {"layer_norm_fwd_epoch": Tally(), "layer_norm_bwd_epoch": Tally()}
    for key in sorted(set(calls), key=str):
        kind, xs, xdt, gs, ydt, need_dx = key
        n = calls.count(key)
        R = gs[0] if len(gs) == 2 else None
        rows, F = xs[0], xs[-1]
        shared = R is not None and len(xs) == 2
        x, gamma, beta, g = ln_inputs(rows, F, xdt, ydt, dev, gen, R=R, shared=shared)
        runs = R or 1
        xr = x if R is None or shared else x[:, 0].contiguous()
        wl, bl = gamma.reshape(-1, F)[0].to(xdt), beta.reshape(-1, F)[0].to(xdt)
        if kind == "fwd":
            k = cuda_ms(lambda: cl.ln_fwd_cuda(x, gamma, beta, ydt))
            p = cuda_ms(lambda: cl.ln_fwd_plain(x, gamma, beta, ydt), iters=1)
            lib = runs * cuda_ms(lambda: tf.layer_norm(xr, (F,), wl, bl, eps=cl.LN_EPS))
            e = scaled_err(cl.ln_fwd_cuda(x, gamma, beta, ydt),
                           cl.ln_fwd_plain(x, gamma, beta, ydt))[0]
        else:
            k = cuda_ms(lambda: cl.ln_bwd_cuda(g, x, gamma, need_dx))
            p = cuda_ms(lambda: cl.ln_bwd_plain(g, x, gamma), iters=1)
            xl = xr.detach().requires_grad_(need_dx)
            wq, bq = wl.clone().requires_grad_(), bl.clone().requires_grad_()
            yl = tf.layer_norm(xl, (F,), wq, bq, eps=cl.LN_EPS)
            ins = (xl, wq, bq) if need_dx else (wq, bq)
            gl = (g if R is None else g[:, 0]).to(yl.dtype).contiguous()
            lib = runs * cuda_ms(lambda: torch.autograd.grad(yl, ins, gl, retain_graph=True))
            e = scaled_err(cl.ln_bwd_cuda(g, x, gamma)[1], cl.ln_bwd_plain(g, x, gamma)[1])[0]
        out[f"layer_norm_{kind}_epoch"].add(n, k, p, e, *ln_cost(rows, F, xdt, ydt, kind == "bwd",
                                                                 need_dx, runs),
                                            library_ms=lib)
        log(f"  B1{2 if kind == 'fwd' else 3} at x {list(xs)} {str(xdt)[6:]}, gamma {list(gs)} "
            f"(x{n} per epoch{', dx' if kind == 'bwd' and need_dx else ''}): kernel {k:.4f} ms, "
            f"plain {p:.3f} ms, library {lib:.4f} ms")
    _kernels.reset_launches()
    return out, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    with open(os.path.join(_kernels.BUILD_DIR, "ptxas.log"), "w") as f:
        f.write(_kernels.build_log)
    for name, regs, st, ld in ptxas_summary(_kernels.build_log):
        log(f"  ptxas {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")

    gen = torch.Generator().manual_seed(0)
    log("phase 3: kernels against their plain versions")
    check_segment_sum(dev, gen)
    check_epilogue(dev, gen)
    check_runs_epilogue(dev, gen)
    check_pack(dev, gen)
    check_layer_norm(dev, gen)
    check_routes(dev, gen)

    check_gather(dev, gen)
    check_gather_sorted(dev, gen)
    check_segment_sum_gather(dev, gen)
    check_segsum_onehot(dev, gen)
    check_stream(dev, gen)

    log("phase 3b: the TPU round's experiments at their scripts' shapes")
    t0 = time.perf_counter()
    raw = bench_raw()
    hd = bench_hyperdata(raw)
    batch = bench_batch(dev, hd)
    wb = walmart_batch(dev)
    log(f"  graphs built in {time.perf_counter() - t0:.1f} s: bench nodes {batch.num_nodes}, "
        f"nnz {batch.inc.nnz}, real edges {batch.inc.real.num_edges}; walmart nodes "
        f"{wb.num_nodes}, nnz {wb.inc.real.nnz}")
    t0 = time.perf_counter()
    exp_rows, exp_counts = run_experiments(batch, wb)
    log(f"  experiments ran in {time.perf_counter() - t0:.1f} s; launches {exp_counts}")
    require("jax" not in sys.modules, "the port loaded jax")

    log("phase 4: main path at bench size (bf16)")
    timings = time_main_shapes(batch, dev, gen)
    timings.update(exp_rows)
    timings.update(time_layer_norm(ln_step_shapes(batch), 256, dev, gen))
    log_tallies({k: timings[k] for k in ("layer_norm_fwd", "layer_norm_bwd")},
                "AllDeepSets bench step")
    counts, _ = main_path(batch, dev, card, PER_STEP, against_pair=True)
    wide_counts = {}
    for HC in (384, 512, 1024):  # the 32-row tiles and the wide pair
        suffix = f"_hc{HC}"
        timings.update(time_epilogue_step(batch, dev, gen, HC, suffix))
        log_tallies({k: timings[k] for k in ("pma_epilogue_fwd" + suffix,
                                             "pma_epilogue_bwd" + suffix)},
                    f"bench step at hidden {HC}")
        wide_counts[HC], _ = main_path(batch, dev, card, PER_STEP, hidden=HC)
    main_path(batch, dev, card, PER_STEP_GPR, gpr=True)
    main_path(batch, dev, card, PER_STEP, learn_mask=True)
    deepsets = dict(pma=False, aggregate="add")
    ds_counts, _ = main_path(batch, dev, card, PER_STEP_DEEPSETS, **deepsets)
    main_path(batch, dev, card, PER_STEP_DEEPSETS, **deepsets, learn_mask=True)
    log("phase 4b: the conv zoo at bench size (bf16, 2 layers, hidden 256)")
    batches = zoo_batches(batch, hd, raw)
    timings.update(time_gather_step(batches, dev))
    log_tallies({k: timings[k] for k in ("gather", "segment_sum")}, "UniGAT bench step")
    zoo_counts = {name: zoo_path(batches, dev, card, name, over)[0] for name, over in ZOO}
    log("phase 4c: CEGCN, CEGAT, HyperGCN at bench size (bf16, 2 layers)")
    timings.update(time_gather_sorted_step(batches, dev))
    log_tallies({"gather_sorted": timings["gather_sorted"]}, "CEGAT bench step")
    ce_counts = {name: zoo_path(batches, dev, card, name, over)[0] for name, over in CE}
    del batches
    reapprox_steps(raw, dev, card)
    require("jax" not in sys.modules, "the port loaded jax")

    log("phase 5: small f32 graph, kernels against plain")
    for mode in ({}, dict(gpr=True), dict(learn_mask=True), deepsets,
                 dict(deepsets, learn_mask=True)):
        small_parity(dev, **mode)
    for name, over in ZOO + CE:
        zoo_small_parity(dev, name, over)
    for name, over in HUB_CONVS:
        zoo_small_parity(dev, f"{name}, no norm", over)

    torch.cuda.empty_cache()
    log("phase 6: the runs protocol through the CLI (synthetic-walmart preset, f32)")
    log(f"  walmart graph (built in phase 3b): nodes {wb.num_nodes}, nnz {wb.inc.real.nnz}, "
        f"real edges {wb.inc.real.num_edges}")
    del batch
    timings.update(time_runs_shapes(wb, dev, gen))
    timings.update(time_epilogue_epoch(wb, dev, gen, 20, 512, "_hc512"))
    log_tallies({k: timings[k] for k in ("pma_epilogue_fwd_runs_hc512",
                                         "pma_epilogue_bwd_runs_hc512")},
                "20-run epoch at hidden 512")
    timings.update(time_epilogue_epoch(wb, dev, gen, 2, 1024, "_hc1024"))
    log_tallies({k: timings[k] for k in ("pma_epilogue_fwd_runs_hc1024",
                                         "pma_epilogue_bwd_runs_hc1024")},
                "2-run epoch at hidden 1024")
    del wb
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        runs_counts, _ = runs_protocol(card, tmp)
        runs512_counts = hidden512_protocol(card, tmp, dev)
        runs1024_counts = wide_protocol(card, tmp)
        deepsets_protocol(card, tmp, dev)
        ln_epoch, ln_epoch_counts = time_layer_norm_epoch(tmp, dev, gen)
        timings.update(ln_epoch)
        log_tallies(ln_epoch, "AllDeepSets 20-run epoch")
        route_runs(card, tmp)
        zoo_cli_counts = zoo_protocol(card, tmp, dev)
        ce_cli_counts = ce_protocol(card, tmp, dev)
        require("jax" not in sys.modules, "the port loaded jax")
        log("phase 7: the accuracy band (5 runs x 500 epochs)")
        band_replay(card, tmp)

    onehot = "allset_tpu_torch/csrc/segsum_onehot.cu"
    stream = "allset_tpu_torch/csrc/stream.cu"
    sources = {  # name -> (source, TPU kernel replaced, launches of its path)
        "segment_sum": ("allset_tpu_torch/csrc/segment_sum.cu",
                        "allset_tpu/ops/pallas_segment.py:39", zoo_counts["UniGAT"]),
        "segment_sum_gather": ("allset_tpu_torch/csrc/segment_sum.cu",
                               "benchmarks/exp_fused_gather.py:213", counts),
        "segment_sum_gather_epoch": ("allset_tpu_torch/csrc/segment_sum.cu",
                                     "benchmarks/exp_fused_gather.py:213", runs_counts),
        # the one-hot family per experiment (B1, B2 nbuf 2, B3 nacc 1, B4 build
        # A, B6 full) and the streaming probes (B5, B7, B8 fold at chunk 512),
        # with the launches of phase 3b's run of every experiment
        "segsum_onehot": (onehot, "benchmarks/pallas_segsum_proto.py:19", exp_counts),
        "segsum_onehot_b2": (onehot, "benchmarks/exp_nbuf.py:19", exp_counts),
        "segsum_onehot_b3": (onehot, "benchmarks/exp_acc2.py:20", exp_counts),
        "segsum_onehot_b4": (onehot, "benchmarks/exp_onehot.py:28", exp_counts),
        "segsum_onehot_b6": (onehot, "benchmarks/exp_segsum_ablate.py:104", exp_counts),
        "stream_flat": (stream, "benchmarks/exp_segsum_ablate.py:35", exp_counts),
        "stream_dual": (stream, "benchmarks/exp_segsum_ablate.py:326", exp_counts),
        "stream_fold": (stream, "benchmarks/exp_autopipe.py:28", exp_counts),
        "pma_epilogue_fwd": ("allset_tpu_torch/csrc/pma_epilogue_fwd.cu",
                             "allset_tpu/ops/pallas_pma.py:170", counts),
        "pma_epilogue_bwd": ("allset_tpu_torch/csrc/pma_epilogue.cu",
                             "allset_tpu/ops/pallas_pma.py:185", counts),
        "pma_epilogue_fwd_runs": ("allset_tpu_torch/csrc/pma_epilogue_fwd.cu",
                                  "allset_tpu/ops/pallas_pma.py:365", runs_counts),
        "pma_epilogue_bwd_runs": ("allset_tpu_torch/csrc/pma_epilogue.cu",
                                  "allset_tpu/ops/pallas_pma.py:424", runs_counts),
        "pma_gmax": ("allset_tpu_torch/csrc/pma_pack.cu",
                     "allset_tpu/ops/pallas_pack.py:94", counts),
        "pma_pack": ("allset_tpu_torch/csrc/pma_pack.cu",
                     "allset_tpu/ops/pallas_pack.py:109", counts),
        "layer_norm_fwd": ("allset_tpu_torch/csrc/layer_norm.cu",
                           "benchmarks/exp_ln.py:50", ds_counts),
        "layer_norm_bwd": ("allset_tpu_torch/csrc/layer_norm.cu",
                           "benchmarks/exp_ln.py:60", ds_counts),
        "gather": ("allset_tpu_torch/csrc/gather.cu", "benchmarks/exp_fused_gather.py:135",
                   zoo_counts["UniGAT"]),
        "gather_sorted": ("allset_tpu_torch/csrc/gather_sorted.cu",
                          "benchmarks/exp_fused_gather.py:76", ce_counts["CEGAT"]),
    }
    # the epilogue kernels at the other widths: the bench steps at hidden
    # 384, 512 and 1024 (the wide pair), the CLI runs at 512 and 1024
    wide = "allset_tpu_torch/csrc/pma_epilogue_wide.cu"
    for HC in (384, 512, 1024):
        for k in ("pma_epilogue_fwd", "pma_epilogue_bwd"):
            sources[f"{k}_hc{HC}"] = (wide if HC > 512 else sources[k][0], sources[k][1],
                                      wide_counts[HC])
    for HC, cnt in ((512, runs512_counts), (1024, runs1024_counts)):
        for k in ("pma_epilogue_fwd_runs", "pma_epilogue_bwd_runs"):
            sources[f"{k}_hc{HC}"] = (wide if HC > 512 else sources[k][0], sources[k][1], cnt)
    for k in ("layer_norm_fwd", "layer_norm_bwd"):  # per AllDeepSets 20-run epoch
        sources[f"{k}_epoch"] = (*sources[k][:2], ln_epoch_counts)
    log(f"  zoo CLI launches: {zoo_cli_counts}; CE and HyperGCN CLI launches: {ce_cli_counts}")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s "
        f"(the build included) [{card}]")
    kernels = []
    for name, (src, rep, cnt) in sources.items():
        base = re.sub(r"_(hc\d+|epoch|b\d+)$", "", name)
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": cnt[base], **timings[name].row()})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
