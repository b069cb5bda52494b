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
     256}, heads 1 to HC, rows below one 64-row tile and not a multiple
     of it) and K2R/K3R its
     runs grids (R in {2, 5}; L in {1, 2}, relu on/off; each run of
     K2R/K3R also bit for bit against a K2/K3 launch on its slice), K4/K5
     the PMA score+pack ((HC, H) in {(256, 8), (64, 1), (128, 4)}, rows
     not a multiple of the tile; gmax bit-equal, w within 2 f32 / 1 bf16
     ulps, a NaN score reaching gmax, R in {2, 5} bit for bit against
     single launches), B12/B13 the LayerNorm (f32, bf16, f32 -> bf16;
     F in {7, 64, 256, 512}, rows not a multiple of the 64-row block; R
     in {2, 5} and an input shared by the runs, each run bit for bit
     against a launch on it alone), the epilogue's route by shape (an
     rFF of 3 layers and HC 96, which the JAX package composes too, on the
     plain version with no launch; HC 256 on K2/K3 and K2R/K3R; HC 512,
     which has no kernel yet, raises before any launch), and at the main
     paths' shapes (K1 on the bench
     graph's real indptrs, bit for bit as well; K3R at R=20 on the walmart
     rows, each run bit for bit against K3; B12/B13 at the AllDeepSets
     step's [131072, 256] and [196608, 256] bf16 launches), with the
     kernel, plain and library times and the kernel's bound;
  4. the benchmark step at its size and width (bf16): the
     AllSetTransformer training step on scale_free_hypergraph(131072
     nodes, 65536 edges, edge size 12, 256 features), 8 Adam steps, as
     the bench step, with GPR and with LearnMask (the unsplit exchange
     over all 582,248 entries), and the AllDeepSets step on the same
     graph, also with LearnMask: the loss is finite and falls, each step
     launches K1 4 times and K2, K3, K4, K5 twice (AllDeepSets: K1 4 and
     B12, B13 8 times; GPR adds one B12 and one B13 for gpr_mlp), and
     two runs from one state give identical losses;
  5. a small f32 graph, as the bench step, with GPR, with LearnMask, and
     AllDeepSets with and without LearnMask: one step through the kernels
     against one step of the plain versions (on the CPU) from the same
     parameters, on a loss without the nodes a relu argument within
     rounding of 0 reaches;
  6. the runs protocol through the CLI (allset_tpu_torch.cli) on
     synthetic-walmart with the tuned preset (hidden 256, 8 heads, f32):
     20 runs folded into each launch for a few epochs; per group and
     epoch 6 K1, 4 K2R, 2 K3R, 4 K4 and 4 K5 launches whatever the
     number of runs (and B12/B13 where a LayerNorm runs outside the
     epilogue: GPR's gpr_mlp, a 2-layer classifier); finite metrics, a
     falling training loss; 2 runs folded against 2 runs one by one:
     equal accuracies, losses within rtol 2e-3; 20 runs x 2 epochs with
     --GPR, --LearnMask and --add_self_loop false, and one run of
     --exclude_self on synthetic; --method AllDeepSets with the same
     preset, 20 runs x 3 epochs (6 K1, 16 B12 and 8 B13 per group and
     epoch), then three warm runs of 4 epochs, 20 runs x 2 epochs with
     --LearnMask (the peak device memory per run of both against the
     trainer's estimate, which must not be lower) and 2 folded against 2
     one by one; --MLP_num_layers 3 (2 runs x 2 epochs) with the
     epilogue on its plain route (K2R/K3R never launch);
  7. the accuracy band: 5 runs x 500 epochs of the same preset; the mean
     final test accuracy within band_tolerance(std, 5, 20) of the 20-run
     band in BANDS.json (scripts/record_bands.py).
The line before the last is a JSON object of per-kernel results (K2R,
K3R from phase 6's run, K1, K2, K3, K4, K5 from phase 4's bench step,
B12, B13 from phase 4's AllDeepSets step): launches, the kernel's time
and its plain version's summed over a bench step (K1, K2, K3, K4, K5,
B12, B13) or a 20-run epoch (K2R, K3R), the bound (the larger of the
bytes over 3.35 TB/s and the products over the tensor cores: bf16 at
989 TFLOP/s, f32 products at 3xTF32, 495 / 3 TFLOP/s; other arithmetic
at 67 TFLOP/s) and one library call's time where one computes the same
function (K1: torch.segment_reduce; B12/B13: F.layer_norm and its
autograd backward); the last line is {"ok": true, "device": {...}}.
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
# take (HC % 64 == 0, HC <= 256), and heads up to one column per head
# (the denominators leave shared memory for f32 at HC 256 from 32 heads in
# K3, from 128 in K2)
EPI_SHAPES = ((256, 8, 264), (256, 32, 288), (256, 128, 384), (192, 8, 200), (128, 4, 136),
              (64, 1, 72), (64, 64, 128))


def check_epilogue(dev, gen):
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    for HC, H, WP in EPI_SHAPES:
        for M in (1000, 40):  # not a multiple of the 64-row tile; below one tile
            for dtype in (torch.float32, torch.bfloat16):
                for L in (1, 2):
                    for relu in (False, True):
                        if M == 40 and relu:
                            continue
                        agg, gy, p = epi_inputs(M, HC, H, WP, L, dtype, dev, gen)
                        seed, g0, b0, W, b, g1, b1 = p
                        y = cp.epilogue_fwd_cuda(agg, seed, g0, b0, W, b, g1, b1, H, relu)
                        y_ref = cp.epilogue_fwd_plain(agg, seed, g0, b0, W, b, g1, b1, H, relu)
                        got = cp.epilogue_bwd_cuda(agg, gy, seed, g0, b0, W, b, g1, b1, H, relu)
                        want = cp.epilogue_bwd_plain(agg, gy, seed, g0, b0, W, b, g1, b1, H,
                                                     relu)
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
    by run, bit for bit against K2/K3 launched on the run's slice."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    HC, H, WP, M = 256, 8, 264, 1000  # M not a multiple of the 64-row tile
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
        for HC, H in ((256, 8), (64, 1), (128, 4)):
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
    version and launch no kernel; HC 256 with 2 layers launches K2/K3
    (K2R/K3R with runs); HC 512 with 2 layers, where the JAX package runs
    its fused kernel and the port has none yet, raises before any
    launch."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    for R in (None, 2):
        agg, gy, p = (epi_inputs(300, 512, 8, 520, 2, torch.float32, dev, gen) if R is None
                      else runs_inputs(300, 512, 8, 520, 2, R, torch.float32, dev, gen))
        _kernels.reset_launches()
        for fn, args in (((cp.epilogue_fwd, (agg,)), (cp.epilogue_bwd, (agg, gy))) if R is None
                         else ((cp.epilogue_fwd_runs, (agg,)), (cp.epilogue_bwd_runs, (agg, gy)))):
            try:
                fn(*args, *p, 8, True)
            except ValueError:
                continue
            require(False, f"HC 512 (R={R or 1}) did not raise")
        require(not any(_kernels.launches.values()), "HC 512: a launch before the raise")
        log(f"  route HC=512, H=8, L=2, R={R or 1}: raises, no launch (no kernel yet)")
    for HC, H, WP, L, want in ((256, 8, 264, 3, "plain"), (96, 4, 104, 2, "plain"),
                               (256, 8, 264, 2, "kernel")):
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


def time_segment_sum(tally, inc, nnz, order, W, dtype, launches, dev, check_order):
    """K1 on the real incidence's ``order`` ('edge' or 'node') indptr and
    plan at width W: kernel, plain and library times, added to ``tally``
    for ``launches`` launches; held to the plain version and, with
    ``check_order``, bit for bit to the plain version in its order."""
    from allset_tpu_torch.ops import cuda_segment as cs

    indptr, plan = getattr(inc, f"{order}_indptr"), getattr(inc, f"{order}_plan")
    nseg = indptr.shape[0] - 1
    msgs = torch.randn(nnz, W, device=dev, dtype=dtype)
    k = cuda_ms(lambda: cs.segment_sum_cuda(msgs, indptr, nseg, plan), iters=10)
    p = cuda_ms(lambda: cs.segment_sum_plain(msgs, indptr, nseg), iters=3)
    lib, lib_name = library_segment_sum(msgs, indptr, nseg)
    lib_ms = cuda_ms(lib, iters=3)
    got = cs.segment_sum_cuda(msgs, indptr, nseg, plan)
    e, rel = scaled_err(got, cs.segment_sum_plain(msgs, indptr, nseg))
    require(rel <= TOL[dtype][0], f"K1 disagrees at [{nnz}, {W}] by {order}: {rel}")
    if check_order:
        require(torch.equal(got, cs.segment_sum_planned(msgs, indptr, nseg, plan)),
                f"K1 differs from its order of additions at [{nnz}, {W}] by {order}")
    del got
    tally.add(launches, k, p, e, *seg_cost(nnz, nseg, W, dtype), library_ms=lib_ms)
    counts = (indptr[1:] - indptr[:-1]).float()
    log(f"  K1 at [{nnz}, {W}] by {order} -> {nseg} segments: kernel {k:.3f} ms, plain "
        f"{p:.3f} ms, {lib_name} {lib_ms:.3f} ms; max_abs_err {e:.3e} (scaled {rel:.2e})"
        f"{', bit-equal to its order' if check_order else ''}; segment length mean "
        f"{counts.mean().item():.2f}, max {int(counts.max().item())}; "
        f"{plan.chunks.shape[0]} chunks, {plan.cuts.shape[0]} cut segments, "
        f"{plan.num_partials} partial rows")
    del msgs


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
    shapes (bf16): K1 on the two reduce orders of the real incidence at
    the packed width, K2/K3 at the two half-layers' row counts. Times are
    summed over one training step's launches (K1: 4, K2: 2, K3: 2). Each
    kernel is held to its plain version with phase 3's tolerances; the
    reported max_abs_err is K1's and K2's output and K3's dagg. No row
    sits at the 1e-16 floor here, as none does on the main path. Returns
    {name: Tally}."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    inc = batch.inc.real
    HC, H, WP, L, dt = 256, 8, 264, 2, torch.bfloat16
    out = {"segment_sum": Tally(), "pma_epilogue_fwd": Tally(), "pma_epilogue_bwd": Tally()}
    for order in ("edge", "node"):  # forward and backward of each half-layer
        time_segment_sum(out["segment_sum"], inc, inc.nnz, order, WP, dt, 2, dev, True)
    for M in (inc.num_edges + batch.inc.num_nodes, batch.inc.num_nodes):
        agg, gy, p = epi_inputs(M, HC, H, WP, L, dt, dev, gen, floor_rows=False)
        args = (agg, *p)
        kf = cuda_ms(lambda: cp.epilogue_fwd_cuda(*args, H, True))
        pf = cuda_ms(lambda: cp.epilogue_fwd_plain(*args, H, True))
        kb = cuda_ms(lambda: cp.epilogue_bwd_cuda(agg, gy, *p, H, True))
        pb = cuda_ms(lambda: cp.epilogue_bwd_plain(agg, gy, *p, H, True))
        ef, rf = scaled_err(cp.epilogue_fwd_cuda(*args, H, True),
                            cp.epilogue_fwd_plain(*args, H, True))
        require(rf <= EPI_FWD_TOL[dt], f"K2 disagrees at M={M}: {rf}")
        got = cp.epilogue_bwd_cuda(agg, gy, *p, H, True)
        want = cp.epilogue_bwd_plain(agg, gy, *p, H, True)
        bmsg = check_bwd(got, want, TOL[dt][1], f"M={M}")
        eb, rb = scaled_err(got[0], want[0])
        out["pma_epilogue_fwd"].add(1, kf, pf, ef, *epi_cost(M, HC, WP, L, dt, False))
        out["pma_epilogue_bwd"].add(1, kb, pb, eb, *epi_cost(M, HC, WP, L, dt, True))
        log(f"  K2 at M={M}: kernel {kf:.3f} ms, plain {pf:.3f} ms, max_abs_err {ef:.3e} "
            f"(scaled {rf:.2e}); K3: kernel {kb:.3f} ms, plain {pb:.3f} ms, dagg "
            f"max_abs_err {eb:.3e}; scaled max {bmsg}")
    # K4/K5: V->E packs the N node rows, E->V the real edges + N-slot rows
    out.update(time_pack((batch.inc.num_nodes, inc.num_edges + batch.inc.num_nodes), None,
                         dt, dev, gen, per_launch=1))
    log_tallies(out, "bench step")
    _kernels.reset_launches()
    return out


def log_tallies(out, per):
    for name, t in out.items():
        r = t.row()
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.3f} ms"
        log(f"  {name} per {per}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{lib}, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")


# --- phases 4 and 5: the training step --------------------------------------


def bench_batch(dev):
    from allset_tpu_torch.data import scale_free_hypergraph
    from allset_tpu_torch.graph import Batch, add_self_loops, norm_construction

    hd = scale_free_hypergraph(num_nodes=131072, num_hyperedges=65536,
                               avg_edge_size=12, feature_dim=256, seed=0)
    hd = norm_construction(add_self_loops(hd), "all_one")
    return Batch.from_hyperdata(hd, device=dev, bucket=1024)


def bench_model(seed: int, nnz_padded: int, **mode):
    """The bench configuration; ``mode`` adds gpr=True or learn_mask=True,
    or pma=False (with aggregate='add': AllDeepSets)."""
    from allset_tpu_torch.models import SetGNN, SetGNNConfig

    cfg = SetGNNConfig(
        num_features=256, num_classes=8, all_num_layers=1, mlp_hidden=256,
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


PER_STEP = {"segment_sum": 4, "pma_epilogue_fwd": 2, "pma_epilogue_bwd": 2,
            "pma_gmax": 2, "pma_pack": 2}
# GPR: gpr_mlp's hidden LayerNorm (MLP_num_layers 2)
PER_STEP_GPR = {**PER_STEP, "layer_norm_fwd": 1, "layer_norm_bwd": 1}
# AllDeepSets: V->E and E->V each run f_enc and f_dec, 2-layer MLPs with an
# input norm: 4 LayerNorms per half-layer
PER_STEP_DEEPSETS = {"segment_sum": 4, "layer_norm_fwd": 8, "layer_norm_bwd": 8}


def main_path(batch, dev, card, per_step=None, **mode):
    """8 bench steps (``mode``: the bench step, gpr=True, learn_mask=True,
    pma=False for AllDeepSets) with every launch count set to 0 just
    before, checked against ``per_step`` (default: the bench step's
    PER_STEP, as ``scripts/pair_timing.py`` calls it in any tree); returns
    the counts and the median step time."""
    from allset_tpu_torch.ops import _kernels

    per_step = PER_STEP if per_step is None else per_step
    steps = 8
    label = ", ".join(f"{k}={v}" for k, v in mode.items()) or "bench step"
    mask = torch.arange(batch.num_nodes, device=dev) % 2 == 0
    model = bench_model(0, batch.inc.nnz_padded, **mode).to(dev)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    # warm-up on a throwaway copy: first-call allocations, cuBLAS handles
    warm = bench_model(0, batch.inc.nnz_padded, **mode).to(dev)
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
    model2 = bench_model(1, batch.inc.nnz_padded, **mode).to(dev)
    model2.load_state_dict(state)
    losses2, _ = run_steps(model2, batch, mask, steps)
    require(torch.equal(losses, losses2), f"{label}: two runs from one state differ")
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
    shapes (walmart preset, f32, R runs folded): K1 on the two reduce
    orders at width R*264 (an epoch launches it 3 times on each: train
    forward and backward, eval forward), K2R at the two half-layers' row
    counts (twice each per epoch: train and eval), K3R once each. Summed
    per epoch; each kernel held to its plain version with phase 3's
    tolerances, and each run of K3R bit for bit to K3 on its slice.
    Returns {name: Tally}."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    inc = batch.inc.real
    HC, H, WP, L, dt = 256, 8, 264, 2, torch.float32
    out = {"segment_sum_runs": Tally(), "pma_epilogue_fwd_runs": Tally(),
           "pma_epilogue_bwd_runs": Tally()}
    for order in ("edge", "node"):
        time_segment_sum(out["segment_sum_runs"], inc, inc.nnz, order, R * WP, dt, 3, dev,
                         False)
    for M in (inc.num_edges + batch.num_nodes, batch.num_nodes):
        agg, gy, p = runs_inputs(M, HC, H, WP, L, R, dt, dev, gen, floor_rows=False)
        kf = cuda_ms(lambda: cp.epilogue_fwd_runs_cuda(agg, *p, H, True), iters=3)
        pf = cuda_ms(lambda: cp.epilogue_fwd_runs_plain(agg, *p, H, True), iters=2)
        kb = cuda_ms(lambda: cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, True), iters=3)
        pb = cuda_ms(lambda: cp.epilogue_bwd_runs_plain(agg, gy, *p, H, True), iters=2)
        ef, rf = scaled_err(cp.epilogue_fwd_runs_cuda(agg, *p, H, True),
                            cp.epilogue_fwd_runs_plain(agg, *p, H, True))
        require(rf <= EPI_FWD_TOL[dt], f"K2R disagrees at M={M}: {rf}")
        got = cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, True)
        want = cp.epilogue_bwd_runs_plain(agg, gy, *p, H, True)
        bmsg = check_bwd(got, want, TOL[dt][1], f"runs M={M}")
        eb, _ = scaled_err(got[0], want[0])
        del want
        for r in range(R):
            one = cp.epilogue_bwd_cuda(agg[:, r * WP:(r + 1) * WP].contiguous(),
                                       gy[:, r * HC:(r + 1) * HC].contiguous(),
                                       *[t[r] for t in p], H, True)
            require(torch.equal(got[0][:, r * WP:(r + 1) * WP], one[0])
                    and torch.equal(got[1][r], one[1]) and torch.equal(got[2][r], one[2]),
                    f"K3R run {r} differs from K3 on its slice at M={M}")
        del got, one
        out["pma_epilogue_fwd_runs"].add(2, kf, pf, ef, *epi_cost(M, HC, WP, L, dt, False, R))
        out["pma_epilogue_bwd_runs"].add(1, kb, pb, eb, *epi_cost(M, HC, WP, L, dt, True, R))
        log(f"  K2R at M={M}, R={R}: kernel {kf:.3f} ms, plain {pf:.3f} ms, max_abs_err "
            f"{ef:.3e} (scaled {rf:.2e}); K3R: kernel {kb:.3f} ms, plain {pb:.3f} ms, dagg "
            f"max_abs_err {eb:.3e}; scaled max {bmsg}; each run bit-identical to K3")
    pack = time_pack((batch.num_nodes, inc.num_edges + batch.num_nodes), R, dt, dev, gen,
                     per_launch=2)  # train and eval forward
    out.update({f"{k}_runs": v for k, v in pack.items()})
    log_tallies(out, f"{R}-run epoch")
    _kernels.reset_launches()
    return out


PER_GROUP_EPOCH = {"segment_sum": 6, "pma_epilogue_fwd_runs": 4, "pma_epilogue_bwd_runs": 2,
                   "pma_epilogue_fwd": 0, "pma_epilogue_bwd": 0, "pma_gmax": 4, "pma_pack": 4}
# AllDeepSets (walmart preset): K1 twice per half-layer forward (train and
# eval) and once backward; 4 LayerNorms per half-layer, forward in train
# and eval, backward once
DEEPSETS_GROUP_EPOCH = {"segment_sum": 6, "layer_norm_fwd": 16, "layer_norm_bwd": 8}
# the epilogue on its plain route (an rFF of 3 layers): K1, K4, K5 and no
# K2R/K3R
PLAIN_ROUTE_GROUP_EPOCH = {"segment_sum": 6, "pma_gmax": 4, "pma_pack": 4}


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
    in its launches)."""
    from allset_tpu_torch import cli
    from allset_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    res = cli.run(argv)
    torch.cuda.synchronize()
    counts = dict(_kernels.launches)
    n = len(res.groups) * epochs
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


def deepsets_peak(argv, epochs, learn_mask, dev):
    """One checked AllDeepSets CLI run (walmart preset, f32) -> (Results,
    counts, the peak device memory per folded run, the trainer's estimate
    for the same configuration)."""
    from allset_tpu_torch.data import load_dataset
    from allset_tpu_torch.train import TrainConfig, Trainer
    from allset_tpu_torch.train.factory import ExperimentConfig, prepare
    from allset_tpu_torch.train.presets import preset_for

    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    res, counts = cli_run(argv, epochs, DEEPSETS_GROUP_EPOCH)
    peak = (torch.cuda.max_memory_allocated(dev) - before) / max(res.groups)
    fields = ExperimentConfig.__dataclass_fields__
    preset = {k: v for k, v in preset_for(WALMART, 1.0).items() if k in fields}
    data = load_dataset(WALMART, feature_noise=1.0, seed=0)
    mcfg, batch = prepare(ExperimentConfig(method="AllDeepSets", dname=WALMART,
                                           learn_mask=learn_mask, **preset), data, dev)
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
    res, counts, peak, est = deepsets_peak(base + ["--epochs", str(epochs)], epochs, False, dev)
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
    res_m, counts_m, peak_m, est_m = deepsets_peak(base + ["--epochs", "2", "--LearnMask"], 2,
                                                   True, dev)
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

    log("phase 4: main path at bench size (bf16)")
    t0 = time.perf_counter()
    batch = bench_batch(dev)
    log(f"  graph built in {time.perf_counter() - t0:.1f} s: nodes {batch.num_nodes}, "
        f"nnz {batch.inc.nnz}, real edges {batch.inc.real.num_edges}")
    timings = time_main_shapes(batch, dev, gen)
    timings.update(time_layer_norm(ln_step_shapes(batch), 256, dev, gen))
    log_tallies({k: timings[k] for k in ("layer_norm_fwd", "layer_norm_bwd")},
                "AllDeepSets bench step")
    counts, _ = main_path(batch, dev, card, PER_STEP)
    main_path(batch, dev, card, PER_STEP_GPR, gpr=True)
    main_path(batch, dev, card, PER_STEP, learn_mask=True)
    deepsets = dict(pma=False, aggregate="add")
    ds_counts, _ = main_path(batch, dev, card, PER_STEP_DEEPSETS, **deepsets)
    main_path(batch, dev, card, PER_STEP_DEEPSETS, **deepsets, learn_mask=True)
    require("jax" not in sys.modules, "the port loaded jax")

    log("phase 5: small f32 graph, kernels against plain")
    for mode in ({}, dict(gpr=True), dict(learn_mask=True), deepsets,
                 dict(deepsets, learn_mask=True)):
        small_parity(dev, **mode)

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
        deepsets_protocol(card, tmp, dev)
        route_runs(card, tmp)
        require("jax" not in sys.modules, "the port loaded jax")
        log("phase 7: the accuracy band (5 runs x 500 epochs)")
        band_replay(card, tmp)

    sources = {  # name -> (source, TPU kernel replaced, launches of its path)
        "segment_sum": ("allset_tpu_torch/csrc/segment_sum.cu",
                        "allset_tpu/ops/pallas_segment.py:39", counts),
        "pma_epilogue_fwd": ("allset_tpu_torch/csrc/pma_epilogue.cu",
                             "allset_tpu/ops/pallas_pma.py:170", counts),
        "pma_epilogue_bwd": ("allset_tpu_torch/csrc/pma_epilogue.cu",
                             "allset_tpu/ops/pallas_pma.py:185", counts),
        "pma_epilogue_fwd_runs": ("allset_tpu_torch/csrc/pma_epilogue.cu",
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
    }
    kernels = []
    for name, (src, rep, cnt) in sources.items():
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": cnt[name], **timings[name].row()})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
