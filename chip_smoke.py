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
     256, 384, 512} and, through the wide route, 640, 768 and 1024; heads
     1 to HC, rows below one tile (64 rows up to HC 512, where K3 takes 32
     above HC 256: 40 and 20 rows there; 128 above 512: 80 rows) and not a
     multiple of it; two K3 calls bit for bit at 384 and above; the widest
     the JAX kernel takes, 1536 with 2 layers in f32 and
     2048 with 1 layer in bf16) and K2R/K3R its runs grids (HC 256, 384,
     512, 640, 768 and 1024, R in {2, 5}; L in {1, 2}, relu on/off; the
     widest two at R=2; each run of K2R/K3R also bit for bit against a
     K2/K3 launch on its slice; two K2 calls bit for bit; K2 in f32 at HC
     256 on the warpgroup kernel beside K3a, at 384 and 512 in both dtypes
     on the cluster kernel, the tiled K2 elsewhere), K4/K5
     the PMA score+pack ((HC, H) in {(256, 8), (64, 1), (128, 4), (512,
     8), (256, 256)}, rows not a multiple of the tile; gmax bit-equal, w
     within 2 f32 / 1 bf16 ulps, a NaN score reaching gmax, R in {2, 5,
     20} (R = 20 with a NaN score in its last run), every run bit for bit
     against a single launch; the pack's forward in one call bit for bit
     against K4, then K5), B12/B13 the LayerNorm (f32, bf16, f32 ->
     bf16; F in {7, 64, 100, 256, 512, 1024} on B13's register path and
     1100, 2048 on its wide path, at 37, 1,000 and 20,011 rows; rows one
     element off vector alignment bit for bit against the aligned launch;
     two launches bit for bit; R in {2, 5} and an input shared by the
     runs, each run bit for bit against a launch on it alone), the epilogue's route by shape (an
     rFF of 3 layers and HC 96, which the JAX package composes too, on the
     plain version with no launch; HC 256, 512, 640, 1024 and 2048 (2
     layers, f32: above the JAX kernel's VMEM cap, the widest the wide
     route takes) on K2/K3 and K2R/K3R, held to the plain version), B10 the
     row gather (bit for bit: f32 and
     bf16, widths 1, 8, 256, 264, 5,280 and 20 x 264, int32 and int64 ids,
     clamped ids, narrow rows on an unaligned view), B9 the sorted gather
     (bit for bit: f32 and bf16 rows of 2 B to 1 KiB, sorted ids with
     gaps, a hub run of 10,000 equal ids and ids past both ends, the same
     ids unsorted, int32 and int64), the gather inside K1
     (segment_sum_gather, B11's port: bit for bit against B10 + the scale
     + K1 and against its plain version in its order; f32 and bf16, W 8,
     264, 384 and 20 x 264, no norm, a per-entry norm and a [20, k] runs
     norm, empty segments, a 50,000-entry hub, int64 and int32 ids with
     gaps and clamped below 0 and past the end; one slab and L2 budgets
     that cut W into uneven slabs of 72 and into slabs of 88 columns; W
     13 through the padding wrapper; the identity CSR against
     index_select), the one-hot family (segsum_onehot: B1, B2 at nbuf 2,
     3, 4, 6, B3 at nacc 1, 2, 4, B4's builds A, B, C, B6's seven modes;
     f32 and bf16 within 1e-5 of the plain versions, rows not a multiple of
     the chunk, segments padded to the block, msgs with and without the
     spare chunk; hub-skewed ids, one block holding 92% of 200,003
     entries, split into work items, two launches bit-equal), the
     streaming probes (B5 stream_flat, B7 stream_dual, B8 stream_fold with
     both bodies at chunks up to 2,048, two calls bit for bit, within 1e-5;
     B5 and B7 also with NaN past each chunk's row 16), and at the main
     paths' shapes (the gather inside K1 on _Spmm's passes of a bench step
     and a 20-run epoch, bit for bit against B10 + K1, with each pass's
     slab count: the epoch's 1.9 GB tables are far above the L2 budget;
     K4 through its wrapper, as a launch alone and beside torch.amax;
     K1 and B10 at a UniGAT step's sums and gathers, K1 bit for bit to its order; K3R at
     R=20 on the walmart rows, each run bit for bit against K3; B12/B13 at
     the AllDeepSets step's [131072, 256] and [196608, 256] bf16 launches
     and at an AllDeepSets 20-run epoch's; B9 at a CEGAT step's, against
     B10 as well, in event time and in device time from a CUDA graph),
     with the kernel, plain and library times and the kernel's bound;
  3b. each experiment of allset_tpu_torch.experiments (the TPU round's
     B1-B8 and B11 scripts) through its main at its script's shapes, with
     every launch count set to 0 just before: B1, B2, B3 and B6 on the
     bench graph's node side, B4, B5, B7, B8 (both bodies), B11 with B10,
     B9 and index_select on the identity CSR and _Spmm's passes, the gather
     inside K1 against B10 + K1 in alternating pairs (the route's
     measurement); each new kernel must launch, each held to its plain
     version; each experiment's row also carries its device time, from a
     CUDA graph of 10 calls (device_ms); B8's rows (both bodies, chunks
     512, 1,024, 2,048) logged with the device times of the kernel and of
     the library call, the bound and the share of it;
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
     512, 640 and 1024 (K2/K3 at those widths, timed at its shapes too;
     above 512 the wide route); then
     the conv zoo on the same graph (2 layers, hidden 256, bf16): HCHA,
     HGNN, HNHN, UniGCNII, MLP and UniGNN with each of its five convs
     (UniGAT at 8 heads of 32; UniGIN and UniSAGE with --UniGNN_use_norm,
     see ZOO), 8 steps each with the same checks and launch counts as the
     code predicts (zoo_launches), the step time and edges/s; CEGCN
     (hidden 256), CEGAT (8 heads of 32) on the bench graph's clique
     expansion (279,962 entries with the self-loops) and HyperGCN (its
     Laplacian with mediators, built once on the host), 8 steps each with
     the same checks (CEGAT's sorted narrow gathers on B9); 2 steps of
     HyperGCN's reapprox path (f32), its host build time per step; the
     bench step also at hidden 64 and 128 (the tiled K2/K3, the width of
     four tuned presets), timed at its shapes too;
  4g. (after 4, before the zoo) the runs-folded f32 dense products
     (ops/cuda_dense.py): the kernel pair against its plain version (a
     product a run, the bias, a stack) and torch.matmul over [R, rows, K],
     forward and forward + backward, each held to the plain version, at
     the cells' shapes (DENSE_CELL_SHAPES, 20 runs) and the zoo's
     (DENSE_ZOO_SHAPES, 1 and 20 runs: where the gate's row count comes
     from); the exact launch checks of the other phases leave out the
     dense counters (path_kernels);
  4e. (after 4d) HAN at benchmarks/han_bench.py's shape (65,536 nodes,
     32,768 hyperedges of 12, 64 features, 8 classes, seed 0; 8 heads of
     8, f32): the metapath build's host seconds and pairs (4,788,390 VEV,
     2,387,764 EVE); one step through B10, B9 and K1 against the same
     step through their plain versions on the card from the same
     parameters (the loss without the rows a leaky_relu or ELU argument
     within 1e-5 of 0 reaches: within 1e-5, gradients within 1e-3); 8
     steps with the launches han_launches predicts (6 B10, 2 B9, 6 K1 a
     step), finite falling losses, two runs from one state bit-identical,
     the median step, M metapath-pairs/s and the peak memory; B10, B9 and
     K1 timed at the step's shapes; train_han, 2 runs x 8 epochs (dropout
     0.6), launches per epoch, finite falling losses; SampledHAN at B 32
     and 4096 (steps/s, seeds/s, the host sampler's seeds/s; 3 B10 a step)
     and a short train_han_minibatch; HeteroHAN's coalesce and one
     forward and backward;
  4f. (after 4e) the edge-partitioned step (allset_tpu_torch.parallel):
     (a) world size 1 over NCCL at the bench step (bf16, HC 256, the fused
     sharded epilogue in both directions) and (b) 4 shard bodies in turn
     on the card (scale_free_hypergraph(32768 nodes, 16384 edges), f32, HC
     256, the unsplit exchange with balanced cuts; AllSetTransformer and
     AllDeepSets with LearnMask), each one step against the single-device
     step from the same parameters (the loss and every gradient; (b) on a
     loss without tied nodes), its launches per step (the gather inside
     K1 4 a shard, K2, K3 and K3's parts 2 a shard, K4/K5 2, B10 at least
     once; AllDeepSets B12/B13), its collectives and bytes as
     sharded_comm_stats counts them, the per-shard entries, and the
     sharded and single-device step times beside the card;
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
     x 2 epochs with --GPR, --LearnMask and --add_self_loop false (each
     mode's peak per run against the trainer's estimate), and one
     run of --exclude_self on synthetic; --MLP_hidden 512 (20 runs x 2
     epochs: 4 K2R and 2 K3R at HC 512 per group and epoch, timed at its
     shapes too; the peak per run against the trainer's estimate; 2
     folded against 2 one by one); --MLP_hidden 1024 (2 runs x 1 epoch
     through the wide route, timed at its shapes; the peak per run
     against the trainer's estimate); --method AllDeepSets
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
  6c. (after the CLI runs of phase 6, before the zoo's) --profile DIR on
     the walmart preset (f32, 2 runs x 3 epochs): the trace names the
     path's kernels (the gather inside K1, K2R, K3R's parts, K4, K5), the
     summary and metrics equal the run's without --profile; logs the
     trace's ten largest device ops and the device's busy share;
  4d. (after 4c) 'bn' at the bench step, bf16, training steps (batch
     statistics): AllSetTransformer, AllDeepSets and CEGCN, 8 steps each,
     launches as predicted (no B12/B13), finite falling losses, two runs
     from one state bit-identical, SetGNN's half-layers on the unsplit
     exchange; PMA's parity options (softmax_mode='segment',
     return_attention) at the bench shapes in f32 against the global
     mode (rtol 1e-4, atol 1e-5), attention sums of 1, no K4/K5/K2/K3;
  6b. (after 6) the real dataset names --dname cora and walmart-trips-100
     from a miniature archive in the real layout (2 runs x 5 epochs, a
     falling loss); --normalization bn at the walmart preset (20 runs x 3
     epochs on the unsplit exchange; the peak per run against the
     trainer's estimate), 2 runs folded against 2 one by one with
     --save_params (the saved best-valid states bit-identical, the
     reloaded state's evaluation each run's Final Test) and AllDeepSets
     with 'bn'; --remat on the preset (20 runs x 2 epochs) and on
     AllDeepSets with 'bn': bit-identical metrics, the peak per run both
     ways;
  7. the accuracy band: 5 runs x 500 epochs of the same preset; the mean
     final test accuracy within band_tolerance(std, 5, 20) of the 20-run
     band in BANDS.json (scripts/record_bands.py).
The line before the last is a JSON object of per-kernel results (K2R,
K3R from phase 6's run, the gather inside K1 ("segment_sum_gather"), K2,
K3, K4, K5 from phase 4's bench step and the gather inside K1 again,
"_epoch", per 20-run epoch from phase 6's run; B12, B13 from phase 4's
AllDeepSets step and again, "_epoch", per AllDeepSets 20-run epoch; K1
and B10 from phase 4's UniGAT step, B9 ("gather_sorted") from its CEGAT
step; K2 and K3 again at HC 64, 128, 384, 512, 640 and 1024, K2R and
K3R at 512 and 1024, "_hc...", from the bench steps and CLI runs at those
widths (above 512 the wide route, csrc/pma_epilogue_wide_wg.cu); B10, B9
and K1 again per HAN step ("_han", phase 4e); the
one-hot family ("segsum_onehot": B1; "_b2", "_b3", "_b4", "_b6": B2 at
nbuf 2, B3 at nacc 1, B4's build A, B6's full mode) and the streaming
probes (B5 "stream_flat", B7 "stream_dual", B8 "stream_fold", fold at
chunk 512, and "stream_fold_first16", first16 at chunk 512) from phase
3b, with its launches, device_ms and library_device_ms): launches, the kernel's
time and its plain version's summed over a bench step or an epoch (phase
3b: one call at the script's shapes), the bound (the larger of the bytes
over 3.35 TB/s and the products over the tensor cores: bf16 at 989
TFLOP/s, f32 products at 3xTF32, 495 / 3 TFLOP/s, except K3's h^T dp
with h in bf16 at three bf16 products (dp splits into three exact bf16
parts), the one-hot family's
f32 at two TF32 products, 495 / 2; other arithmetic at 67 TFLOP/s) and
one library call's time where one computes the same function (K3c:
torch.sum over both partial tables, dW's and the small vectors'; K1 and the
B1 family: torch.segment_reduce; the gather inside K1: index_select then
torch.segment_reduce; B12/B13: F.layer_norm and its autograd backward;
B10, B9: index_select; B5, B7, B8: a sum over a view); the last line is
{"ok": true, "device": {...}}. The rows of kernels phase 4f launched
carry its launches per sharded step ("launches_sharded" at world 1,
"launches_sharded_4_bodies"). K2's rows at the main path's shapes (the
bench step's tiled K2, the epoch's warpgroup K2R, the cluster K2 at
hidden 384 and 512 and its K2R at 512) and the cluster K3a's (hidden 384
and 512 steps, the 512 epoch) also name their kernel and its registers
and spills from the build's ptxas output; K3's parts at hidden 384 and
512 have rows of their own (per bench step, and per 20-run epoch at
512); phase 6 also times K2R and K3R at hidden 64, 128 and 384 (and
K3R's parts at 384) per 20-run epoch (logged, not in the line: no CLI
run there counts their launches).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
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


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device time of one fn() in ms: ``launches`` calls captured in a CUDA
    graph, the graph replayed between CUDA events (no host launch cost)."""
    fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / (replays * launches)


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
        self.library_ms = self.launch_ms = None  # launch_ms: K4's launch alone
        self.device_ms = None  # B9: the kernel's time from a CUDA graph
        self.slabs = []  # the gather inside K1: each pass's slab count

    def add(self, n, ms, plain_ms, err, nbytes, ops, library_ms=None, device_ms=None):
        """n launches of ms each; ops: [(flops, PEAK key)]."""
        self.ms += n * ms
        self.plain_ms += n * plain_ms
        self.err = max(self.err, err)
        self.t_bytes += n * nbytes / HBM * 1e3
        self.t_ops += n * sum(f / PEAK[k] for f, k in ops) * 1e3
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + n * library_ms
        if device_ms is not None:
            self.device_ms = (self.device_ms or 0.0) + n * device_ms

    def row(self):
        extra = {} if self.launch_ms is None else {"launch_ms": self.launch_ms}
        if self.device_ms is not None:
            extra["device_ms"] = self.device_ms
        if self.slabs:
            extra["slabs"] = self.slabs
        return {"ms": self.ms, "plain_ms": self.plain_ms, "max_abs_err": self.err,
                "bound_ms": max(self.t_bytes, self.t_ops),
                "bound_by": "bytes" if self.t_bytes >= self.t_ops else "operations",
                "library_ms": self.library_ms, **extra}


def epi_cost(M, HC, WP, L, dtype, bwd, R=1):
    """(bytes, ops) of K2 (bwd=False) or K3 on M rows and R runs: agg in,
    y out (K2) or agg and gy in, dagg out (K3), the parameters; the rFF
    products (K3: the forward's, dp @ W^T and h^T dp, the last priced by
    dw_ops)."""
    item = 2 if dtype == torch.bfloat16 else 4
    rows = M * ((2 * WP + HC) if bwd else (WP + HC)) * item
    params = L * HC * HC * (4 + (2 if item == 2 else 0)) + (6 + L) * HC * 4
    fwd = 2 * L * HC * HC * M * R
    ops = [(fwd, "bf16" if item == 2 else "f32x3")]
    if bwd:
        ops += [(fwd, "f32x3"), dw_ops(fwd, item)]
    return R * (rows + params), ops


def dw_ops(prod, item):
    """The product h^T dp of prod flops as (flops, PEAK key): with h in
    bf16, f32 dp splits exactly into three bf16 parts, so three bf16
    products; with h in f32, 3xTF32."""
    return (3 * prod, "bf16") if item == 2 else (prod, "f32x3")


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


def path_kernels():
    """The counters each path's launch checks hold to exact counts: every
    one but the runs-folded dense products' (_kernels.DENSE_KERNELS), which
    launch wherever an f32 product on the card passes the gate
    (time_dense checks them)."""
    from allset_tpu_torch.ops import _kernels

    return [k for k in _kernels.KERNELS if k not in _kernels.DENSE_KERNELS]


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
# HC 192; at HC 256 the warpgroup K3 and, in f32, K2 take every head
# count on a ring of 4, 3 or 2 weight slots; the cluster K2 and K3 at 384
# and 512 read them from global memory at every head count, K3 once per
# row, column pair or column as the heads fall on its warpgroups; the wide
# route's row phases sum each head's columns through shared memory)
EPI_SHAPES = ((256, 8, 264), (256, 32, 288), (256, 128, 384), (192, 8, 200), (192, 192, 384),
              (128, 4, 136),
              (64, 1, 72), (64, 64, 128), (384, 1, 392), (384, 8, 392), (384, 384, 768),
              (512, 1, 520), (512, 8, 520), (512, 512, 1024),
              # the wide route (csrc/pma_epilogue_wide_wg.cu): HC above 512
              (640, 8, 648), (768, 1, 776), (768, 768, 1536), (1024, 8, 1032),
              (1024, 64, 1088))
# (HC, H, WP, dtype, L): wide shapes at which the JAX kernel's scoped VMEM
# is just under its 110 MiB cap (the widest the TPU kernel takes)
WIDEST = ((1536, 8, 1544, torch.float32, 2), (2048, 8, 2056, torch.bfloat16, 1))


def check_epilogue(dev, gen):
    """K2/K3 against their plain versions at EPI_SHAPES (f32 and bf16, L 1
    and 2) and at WIDEST, each shape routed to the kernels."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    cases = [(shape, dtype, L) for shape in EPI_SHAPES
             for dtype in (torch.float32, torch.bfloat16) for L in (1, 2)]
    cases += [((HC, H, WP), dtype, L) for HC, H, WP, dtype, L in WIDEST]
    for (HC, H, WP), dtype, L in cases:
        require(cp.epilogue_route(HC, H, L, WP) == "kernel",
                f"HC={HC}, L={L}, {dtype} is not routed to the kernels")
        # below one tile: K2's and K3's 64 rows up to HC 512 (40 rows) and,
        # at 384 and 512, the 32 of the tiled K3 there before (20 rows), the
        # wide route's 128 above (80 rows)
        tiles = (cp.tile_rows(HC), *((32,) if HC in cp.CLUSTER_BWD_WIDTHS else ()))
        smalls = {t * 5 // 8 for t in tiles}
        for M in (1000, *sorted(smalls)):  # not a multiple of the tile; below one tile
            for relu in (False, True):
                if M in smalls and relu:
                    continue
                agg, gy, p = epi_inputs(M, HC, H, WP, L, dtype, dev, gen)
                seed, g0, b0, W, b, g1, b1 = p
                y = cp.epilogue_fwd_cuda(agg, seed, g0, b0, W, b, g1, b1, H, relu)
                require(torch.equal(y, cp.epilogue_fwd_cuda(agg, seed, g0, b0, W, b, g1, b1,
                                                             H, relu)),
                        f"two K2 calls differ ({dtype}, HC={HC}, H={H}, M={M}, L={L})")
                y_ref = cp.epilogue_fwd_plain(agg, seed, g0, b0, W, b, g1, b1, H, relu)
                got = cp.epilogue_bwd_cuda(agg, gy, seed, g0, b0, W, b, g1, b1, H, relu)
                if HC in cp.CLUSTER_BWD_WIDTHS or cp.wide(HC):
                    again = cp.epilogue_bwd_cuda(agg, gy, seed, g0, b0, W, b, g1, b1, H, relu)
                    require(all(torch.equal(a, b) for a, b in zip(got, again)),
                            f"two K3 calls differ ({dtype}, HC={HC}, H={H}, M={M}, L={L})")
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
    256, 384 and 512, at 640, 768 and 1024 (the wide route; R 2 and 5, L 1
    and 2; 1000 rows), at WIDEST (R 2) and, at 384 and 512, on 5000 rows
    (R 2, L 2: more tiles than the cluster K3a has clusters)."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    cases = [(shape, dtype, R, L, 1000)  # 1000 rows: not a multiple of the 64- or 128-row tile
             for shape in ((256, 8, 264), (384, 8, 392), (512, 8, 520), (640, 8, 648),
                           (768, 8, 776), (1024, 8, 1032))
             for dtype in (torch.float32, torch.bfloat16) for R in (2, 5) for L in (1, 2)]
    cases += [((HC, H, WP), dtype, 2, L, 1000) for HC, H, WP, dtype, L in WIDEST]
    # the cluster K3a over more 64-row tiles than its clusters
    # (CLUSTER_BWD_ENTRIES): each cluster's small-vector partials sum
    # several tiles of a run
    cases += [((HC, 8, HC + 8), dtype, 2, 2, 5000) for HC in cp.CLUSTER_BWD_WIDTHS
              for dtype in (torch.float32, torch.bfloat16)]
    for (HC, H, WP), dtype, R, L, M in cases:
        for relu in (False, True):
            agg, gy, p = runs_inputs(M, HC, H, WP, L, R, dtype, dev, gen)
            y = cp.epilogue_fwd_runs_cuda(agg, *p, H, relu)
            y_ref = cp.epilogue_fwd_runs_plain(agg, *p, H, relu)
            got = cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, relu)
            want = cp.epilogue_bwd_runs_plain(agg, gy, *p, H, relu)
            what = f"{dtype}, HC={HC}, R={R}, L={L}, M={M}, relu={relu}"
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
            log(f"  K2R/K3R {str(dtype)[6:]:8s} HC={HC} R={R} L={L} M={M} relu={int(relu)}: fwd "
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


def same(got, want) -> bool:
    """Equal values, and NaN exactly where the other has NaN."""
    return (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0)))


def check_pack(dev, gen):
    """K4/K5 against their plain versions: gmax bit-equal, w within
    PACK_ULPS, a NaN score propagated to gmax; the runs grid (R in {2, 5},
    and R = 20 with a NaN score in the last run) bit for bit against
    single-run launches on each slice; the pack's forward in one call
    (K4 then K5) bit for bit against K4, then K5."""
    from allset_tpu_torch.ops import _kernels, cuda_pack as ck

    M = 1000  # not a multiple of K5's 32-row tile
    for dtype in (torch.float32, torch.bfloat16):
        for HC, H in ((256, 8), (64, 1), (128, 4), (512, 8), (256, 256)):
            yf, bV, ba = pack_inputs(M, HC, H, dtype, dev, gen)
            g = ck.gmax_cuda(yf, ba, H, HC)
            w = ck.pack_cuda(yf, bV, ba, g, H)
            w2, g2 = ck.score_pack_cuda(yf, bV, ba, H)
            g_ref = ck.gmax_plain(yf, ba, H, HC)
            w_ref = ck.pack_plain(yf, bV, ba, H)
            torch.cuda.synchronize()
            require(torch.equal(g, g_ref), f"K4 gmax differs ({dtype}, HC={HC}, H={H})")
            require(torch.equal(g2, g) and torch.equal(w2, w),
                    f"the pack's forward differs from K4, then K5 ({dtype}, HC={HC}, H={H})")
            u = ulps(w, w_ref)
            err, _ = scaled_err(w, w_ref)
            require(u <= PACK_ULPS[dtype], f"K5 off by {u} ulps ({dtype}, HC={HC}, H={H})")
            require(not w[:, HC + H:].any(), "K5 pad columns not zero")
            yf[123, HC + H - 1] = float("nan")
            g_nan, g_nan_ref = ck.gmax_cuda(yf, ba, H, HC), ck.gmax_plain(yf, ba, H, HC)
            require(bool(torch.isnan(g_nan[H - 1])) and same(g_nan, g_nan_ref),
                    f"K4 does not propagate NaN ({dtype}, HC={HC}, H={H})")
            msg = []
            for R in (2, 5, 20):
                yr, bVr, bar = pack_inputs(M, HC, H, dtype, dev, gen, R=R)
                if R == 20:
                    yr[321, R - 1, HC] = float("nan")  # run R - 1, head 0
                gr = ck.gmax_cuda(yr, bar, H, HC)
                wr = ck.pack_cuda(yr, bVr, bar, gr, H)
                WP = yr.shape[-1]
                g_runs = torch.stack([ck.gmax_plain(yr[:, r], bar[r], H, HC) for r in range(R)])
                require(same(gr, g_runs) and int(gr.isnan().sum()) == (R == 20),
                        f"K4 runs differ from gmax_plain (R={R}, HC={HC}, H={H})")
                w2, g2 = ck.score_pack_cuda(yr, bVr, bar, H)
                require(same(g2, gr) and same(w2, wr),
                        f"the pack's forward differs at R={R} ({dtype}, HC={HC}, H={H})")
                # the NaN run's w is NaN in head 0's columns, as the plain
                # version's: the same positions, the rest within PACK_ULPS
                wr_ref = ck.pack_runs_plain(yr, bVr, bar, H)
                nan = wr_ref.isnan()
                ur = ulps(wr[~nan], wr_ref[~nan])
                require(torch.equal(wr.isnan(), nan) and ur <= PACK_ULPS[dtype],
                        f"K5 runs off by {ur} ulps or NaN elsewhere (R={R})")
                for r in range(R):
                    y1 = yr[:, r].contiguous()
                    g1 = ck.gmax_cuda(y1, bar[r], H, HC)
                    require(same(gr[r], g1) and same(
                        wr[:, r * WP:(r + 1) * WP], ck.pack_cuda(y1, bVr[r], bar[r], g1, H)),
                        f"K4/K5 run {r} of {R} differs from a single launch ({dtype}, HC={HC})")
                msg.append(f"R={R} {ur:g} ulps")
            log(f"  K4/K5 {str(dtype)[6:]:8s} HC={HC:3d} H={H:3d}: gmax bit-equal, NaN "
                f"propagated; w max_abs_err={err:.3e}, {u:g} ulps (tol {PACK_ULPS[dtype]}); "
                f"runs {', '.join(msg)} (R=20 with a NaN score in its last run), every run "
                f"bit-identical to a single launch; the pack's forward in one call "
                f"bit-identical to K4, then K5")
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


# B13's widths: the scalar chunks (7), 8-element chunks (64, 256, 512), the
# register path's widest (1024), 4-element chunks (100: the walmart
# features), and the wide path that re-reads rows (1100, 2048)
LN_WIDTHS = (7, 64, 100, 256, 512, 1024, 1100, 2048)


def misaligned(t):
    """A copy of t as a contiguous view one element into a larger buffer:
    its rows lose every vector alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def check_layer_norm(dev, gen):
    """B12/B13 against their plain versions in f32, bf16 and f32 -> bf16,
    at F in LN_WIDTHS (B13's register path up to 1024 with chunks of 1, 4
    and 8 elements, the wide path above), at rows 37 (fewer than a block's
    warps), 1000 and 20,011 (several rows a warp); on x and g one element
    off every vector boundary, bit for bit against the aligned launch (the
    same order of additions); runs R in {2, 5} (and an x shared by the
    runs) at 20,011 rows bit for bit against launches on each run alone."""
    from allset_tpu_torch.ops import _kernels, cuda_ln as cl

    for xdt, ydt in LN_DTYPES:
        for F in LN_WIDTHS:
            for rows in (1000, 37, 20_011):
                what = f"{str(xdt)[6:]}->{str(ydt)[6:]}, F={F}, rows={rows}"
                x, gamma, beta, g = ln_inputs(rows, F, xdt, ydt, dev, gen)
                outs, msg = check_ln_pair(x, gamma, beta, g, ydt, what)
                log(f"  B12/B13 {what}: scaled errors {msg} (tol {TOL[ydt]})")
                if rows == 1000 and F in (100, 256, 1100):
                    off, msg = check_ln_pair(misaligned(x), gamma, beta, misaligned(g), ydt,
                                             what + ", misaligned")
                    require(all(torch.equal(a, b) for a, b in zip(off, outs)),
                            f"B12/B13 on misaligned rows differ from the aligned launch ({what})")
                    log(f"  B12/B13 {what} on rows one element off alignment: scaled errors "
                        f"{msg}; bit-equal to the aligned launch")
            for R, shared in ((2, False), (5, False), (5, True)):
                x, gamma, beta, g = ln_inputs(20_011, F, xdt, ydt, dev, gen, R=R, shared=shared)
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
            x, gamma, beta, g = ln_inputs(20_011, F, xdt, ydt, dev, gen)
            first = cl.ln_bwd_cuda(g, x, gamma)
            require(all(torch.equal(a, b) for a, b in zip(first, cl.ln_bwd_cuda(g, x, gamma))),
                    f"B13 differs between two launches (F={F})")
    _kernels.reset_launches()


def check_routes(dev, gen):
    """The epilogue's route on the card is chosen by shape: an rFF of 3
    layers and HC 96 (shapes the JAX package composes too) take the plain
    version and launch no kernel; HC 256 and 512 with 2 layers launch K2/K3
    (K2R/K3R with runs), and so do HC 640, 1024 and 2048 with 2 layers in
    f32 (the wide route, whose widest it is; no TPU VMEM budget binds
    it), each held to its
    plain version with phase 3's tolerances."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    f32 = torch.float32
    for HC, H, WP, L, want in ((256, 8, 264, 3, "plain"), (96, 4, 104, 2, "plain"),
                               (256, 8, 264, 2, "kernel"), (512, 8, 520, 2, "kernel"),
                               (640, 8, 648, 2, "kernel"), (1024, 16, 1040, 1, "kernel"),
                               (2048, 8, 2056, 2, "kernel")):
        for R in (None, 2):
            _kernels.reset_launches()
            if R is None:
                agg, gy, p = epi_inputs(300, HC, H, WP, L, f32, dev, gen)
                y = cp.epilogue_fwd(agg, *p, H, True)
                d = cp.epilogue_bwd(agg, gy, *p, H, True)
                y_ref = cp.epilogue_fwd_plain(agg, *p, H, True)
                d_ref = cp.epilogue_bwd_plain(agg, gy, *p, H, True)
                names = ("pma_epilogue_fwd", "pma_epilogue_bwd")
            else:
                agg, gy, p = runs_inputs(300, HC, H, WP, L, R, f32, dev, gen)
                y = cp.epilogue_fwd_runs(agg, *p, H, True)
                d = cp.epilogue_bwd_runs(agg, gy, *p, H, True)
                y_ref = cp.epilogue_fwd_runs_plain(agg, *p, H, True)
                d_ref = cp.epilogue_bwd_runs_plain(agg, gy, *p, H, True)
                names = ("pma_epilogue_fwd_runs", "pma_epilogue_bwd_runs")
            torch.cuda.synchronize()
            launched = sum(_kernels.launches[k] for k in names)
            what = f"HC={HC}, H={H}, L={L}, R={R or 1}"
            require(cp.epilogue_route(HC, H, L, WP, R or 1) == want, f"route for {what}")
            require(launched == (2 if want == "kernel" else 0), f"{launched} launches for {what}")
            require(scaled_err(y, y_ref)[1] <= EPI_FWD_TOL[f32], f"K2 on the {want} route ({what})")
            msg = check_bwd(d, d_ref, TOL[f32][1], f"{want} route, {what}")
            log(f"  route {what}: {want} ({launched} kernel launches); bwd scaled max {msg}")
            del agg, gy, p, y, d, y_ref, d_ref
    _kernels.reset_launches()


def k4_launch_alone(yf, ba, H, HC):
    """(call, gmax): K4's C call with its buffers made beforehand, the
    launch without the wrapper's host work."""
    from allset_tpu_torch.ops import _kernels, cuda_pack as ck

    rows, R, WP = ck._check_cuda_args(yf, ba, H, HC)
    blocks, tickets, scratch, vh = ck._workspace(yf).args(rows, R, WP, HC, H,
                                                          yf.element_size())
    gmax = torch.empty(ba.shape, dtype=torch.float32, device=yf.device)
    baf = ba.float().contiguous()
    args = (yf.data_ptr(), None, baf.data_ptr(), gmax.data_ptr(), None, scratch, tickets, blocks,
            vh, rows, R, WP, HC, H, _kernels.dtype_code(yf), ck.K4, _kernels.stream_ptr(yf))
    fn = _kernels.lib().allset_pma_score_pack
    return (lambda keep=baf: fn(*args)), gmax  # keep: ba's f32 copy stays alive


def time_pack(rows_list, R, dtype, dev, gen, per_launch):
    """K4 and K5 against their plain versions at the given row counts (one
    pack per half-layer), HC 256, 8 heads; times summed over a step's or
    an epoch's launches (per_launch of each half-layer). K4's plain
    version is the column max, K5's the whole plain chain (which takes
    its own column max). K4's time is its wrapper's (gmax_cuda), beside
    the launch alone (k4_launch_alone, "launch_ms") and its library call,
    torch.amax over the score columns (leaky(. + ba) and the clamp at 0
    are monotone and [H]-sized, so they commute with the max). Returns
    {name: Tally}."""
    from allset_tpu_torch.ops import _kernels, cuda_pack as ck

    HC, H = 256, 8
    item = 2 if dtype == torch.bfloat16 else 4
    runs = 1 if R is None else R
    tot = {"pma_gmax": Tally(), "pma_pack": Tally()}
    tot["pma_gmax"].launch_ms = 0.0
    for rows in rows_list:
        yf, bV, ba = pack_inputs(rows, HC, H, dtype, dev, gen, R=R)
        WP = yf.shape[-1]
        plain = ck.pack_plain if R is None else ck.pack_runs_plain
        gplain = (ck.gmax_plain if R is None else
                  lambda y, a, h, c: torch.stack([ck.gmax_plain(y[:, r], a[r], h, c)
                                                  for r in range(R)]))
        g = ck.gmax_cuda(yf, ba, H, HC)
        alone, g_alone = k4_launch_alone(yf, ba, H, HC)
        alone()
        scores = yf.view(rows, runs, WP)[..., HC:HC + H]
        k4 = cuda_ms(lambda: ck.gmax_cuda(yf, ba, H, HC), iters=50)
        k4_alone = cuda_ms(alone, iters=50)
        lib4 = cuda_ms(lambda: torch.amax(scores, dim=0), iters=50)
        p4 = cuda_ms(lambda: gplain(yf, ba, H, HC), iters=3)
        k5 = cuda_ms(lambda: ck.pack_cuda(yf, bV, ba, g, H))
        p5 = cuda_ms(lambda: plain(yf, bV, ba, H), iters=3)
        w, w_ref = ck.pack_cuda(yf, bV, ba, g, H), plain(yf, bV, ba, H)
        g_ref = gplain(yf, ba, H, HC)
        require(torch.equal(g, g_ref) and torch.equal(g_alone, g_ref),
                f"K4 differs at rows={rows}")
        err4 = (g - g_ref).abs().max().item()
        u = ulps(w, w_ref)
        require(u <= PACK_ULPS[dtype], f"K5 off by {u} ulps at rows={rows}")
        err, _ = scaled_err(w, w_ref)
        del w, w_ref
        # K4 reads the H score columns, K5 reads yf and writes w
        tot["pma_gmax"].add(per_launch, k4, p4, err4, runs * (rows * H * item + 4 * H),
                            [(runs * rows * H * 2, "f32")], library_ms=lib4)
        tot["pma_gmax"].launch_ms += per_launch * k4_alone
        tot["pma_pack"].add(per_launch, k5, p5, err,
                            runs * (2 * rows * WP * item + 4 * (HC + 2 * H)),
                            [(runs * rows * (HC + H) * 4, "f32")])
        runs_s = "" if R is None else f", R={R}"
        blocks = ck._workspace(yf).args(rows, runs, WP, HC, H, item)[0]
        log(f"  K4 at [{rows}, {'' if R is None else f'{R}x'}{WP}]{runs_s}: wrapper {k4:.4f} ms, "
            f"launch alone {k4_alone:.4f} ms ({blocks} blocks a run), torch.amax {lib4:.4f} ms, "
            f"plain {p4:.3f} ms; K5: kernel {k5:.3f} ms, plain chain {p5:.3f} ms, "
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
        nslab, cols = cs.last_launch["slabs"], cs.last_launch["cols"]  # got's launch
        require(torch.equal(got, cs.segment_sum_cuda(cg.gather_fwd_cuda(table, ids), ip, nseg,
                                                     plan)),
                f"segment_sum_gather differs from B10 + K1 at [{ids.shape[0]}, {W}]")
        require(torch.equal(got, cs.gather_segment_sum_planned(table, ids, ip, nseg, plan)),
                f"segment_sum_gather differs from its order of additions at [{ids.shape[0]}, {W}]")
        e, rel = scaled_err(got, cs.gather_segment_sum_plain(table, ids, ip, nseg))
        require(rel <= TOL[dtype][0], f"segment_sum_gather disagrees at [{ids.shape[0]}, {W}]")
        t.add(n, k, p, e, *spmm_cost(table.shape[0], ids.shape[0], nseg, W, dtype),
              library_ms=lib)
        t.slabs.append(nslab)
        log(f"  segment_sum_gather at [{ids.shape[0]}, {W}] {str(dtype)[6:]} from {table.shape[0]} "
            f"rows ({table.numel() * table.element_size() / 2**20:.1f} MiB; {nslab} slabs of "
            f"{cols} columns) -> {nseg} segments (x{n}): kernel {k:.4f} ms, plain {p:.3f} ms, "
            f"index_select + segment_reduce {lib:.4f} ms; bit-equal to B10 + K1 and to its order;"
            f" max_abs_err {e:.3e} (scaled {rel:.2e})")
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


# The runs-folded dense products (ops/cuda_dense.py) at the cells' shapes:
# (rows, K, N, bias) of AllSetTransformer's [lin_V | Wa] products (V->E on
# the node rows, E->V on the hyperedge rows with self-loops) and its
# classifier, AllDeepSets' f_enc/f_dec layers, 20 runs
DENSE_CELL_SHAPES = ((88_860, 100, 264, False), (158_766, 256, 264, False),
                     (88_860, 256, 11, True), (88_860, 100, 256, True),
                     (88_860, 256, 256, True), (158_766, 256, 256, True))
# the zoo's: hidden 256 layers from a few hundred rows up (the gate's row
# count), cora's 1,433 features, at 1 and 20 runs
DENSE_ZOO_SHAPES = tuple((rows, 256, 256, True) for rows in (128, 256, 512, 1024, 2048, 4096,
                                                             16384)) + ((2708, 1433, 256, True),)


def dense_cost(rows, K, N, R, bwd):
    """(bytes, flops) of the dense product over R runs: x in, y out; with
    bwd also dX (dy in, dx out) and dW (x and dy in)."""
    nbytes = 4 * rows * R * (K + N) * (3 if bwd else 1) + 4 * R * K * N * (3 if bwd else 1)
    return nbytes, 2 * rows * R * K * N * (3 if bwd else 1)


def time_dense(dev, gen, shapes=DENSE_CELL_SHAPES, runs=(20,)):
    """The dense kernel pair (cuda_dense.runs_dense: the forward, then the
    backward's dX, dW and db) against its plain version (TorchDense's loop:
    a product a run on a contiguous slice, the bias, a stack) and
    torch.matmul over [R, rows, K] (one batched library product, the
    runs' tables made contiguous beforehand), f32, TF32 off; the forward
    alone and forward + backward, each held to the plain version with
    phase 3's tolerances. Returns {"runs_dense": Tally} summed over
    ``shapes`` at the largest of ``runs`` (forward + backward)."""
    from allset_tpu_torch.ops import cuda_dense as cd

    torch.backends.cuda.matmul.allow_tf32 = False
    tally = Tally()
    for rows, K, N, bias in shapes:
        for R in runs:
            x = torch.randn(rows, R, K, generator=gen).to(dev).requires_grad_()
            W = (torch.randn(R, K, N, generator=gen) / K ** 0.5).to(dev).requires_grad_()
            b = torch.randn(R, N, generator=gen).to(dev).requires_grad_() if bias else None
            gy = torch.randn(rows, R, N, generator=gen).to(dev)
            xt = x.detach().transpose(0, 1).contiguous().requires_grad_()
            gt = gy.transpose(0, 1).contiguous()

            def kernel(bwd):
                y = cd.runs_dense(x, W, b)
                if bwd:
                    y.backward(gy)
                return y

            def plain(bwd):
                ys = [x[:, r].contiguous() @ W[r] for r in range(R)]
                y = torch.stack([t + b[r] if bias else t for r, t in enumerate(ys)], dim=1)
                if bwd:
                    y.backward(gy)
                return y

            def library(bwd):
                y = torch.matmul(xt, W)
                y = y + b[:, None] if bias else y
                if bwd:
                    y.backward(gt)
                return y

            with torch.no_grad():
                err, rel = scaled_err(kernel(False), plain(False))
            require(rel <= TOL[torch.float32][0], f"runs_dense {rows}x{R}x{K}->{N}: {err}")
            grads = []
            for fn in (kernel, plain):
                for t in (x, W, b):
                    if t is not None:
                        t.grad = None
                fn(True)
                grads.append([t.grad.clone() for t in (x, W, b) if t is not None])
            for g1, g2 in zip(*grads):
                e, r = scaled_err(g1, g2)
                require(r <= TOL[torch.float32][1], f"runs_dense {rows}x{R}x{K}->{N} grad: {e}")
            iters = 5 if rows * R >= 1_000_000 else 20
            with torch.no_grad():
                fwd = [cuda_ms(lambda f=f: f(False), iters) for f in (kernel, plain, library)]
            both = [cuda_ms(lambda f=f: f(True), iters) for f in (kernel, plain, library)]
            nb, fl = dense_cost(rows, K, N, R, True)
            bound = max(nb / HBM, fl / PEAK["f32x3"]) * 1e3
            log(f"  dense rows {rows} R {R} K {K} N {N}: forward kernel {fwd[0]:.3f} / plain "
                f"{fwd[1]:.3f} / torch.matmul {fwd[2]:.3f} ms; forward + backward kernel "
                f"{both[0]:.3f} / plain {both[1]:.3f} / torch.matmul {both[2]:.3f} ms "
                f"(bound {bound:.3f} ms, {100 * bound / both[0]:.1f}%); max err {err:.2e}")
            if R == max(runs):
                tally.add(1, both[0], both[1], err, nb, [(fl, "f32x3")], library_ms=both[2])
            del x, W, b, gy, xt, gt, grads
            torch.cuda.empty_cache()
    return {"runs_dense": tally}


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


def k3_small_partials(M, HC, dtype):
    """The small vectors' partials per run of K3a on its route: one per
    block of the warpgroup K3a, four per cluster of the cluster K3a."""
    from allset_tpu_torch.ops import cuda_pma as cp

    if cp.bwd_kernel(HC, dtype) == "cluster":
        return 4 * cp.cluster_bwd_entries(M)
    return min(-(-M // cp.WG_TILE), cp.WG_BLOCKS)


def k3_part_costs(M, HC, WP, L, dtype, R=1):
    """(bytes, ops) of K3a, K3b and K3c on the warpgroup and cluster routes
    at M rows and R runs: K3a reads agg, gy and the parameters once, writes dagg,
    the transposed h and dp tables and the small vectors' partials, and
    takes the forward's and dp @ W^T's products; K3b reads the tables,
    writes the dW partials and takes h^T dp; K3c reads both partials and
    writes dW and dsmall, one f32 add per partial element."""
    from allset_tpu_torch.ops import cuda_pma as cp

    item = 2 if dtype == torch.bfloat16 else 4
    Mp, _, nch = cp.wg_chunk_plan(M)
    G = k3_small_partials(M, HC, dtype)
    tables = L * HC * Mp * (item + 4)
    small = G * 8 * HC * 4
    partials = nch * L * HC * HC * 4
    params = L * HC * HC * (4 + (2 if item == 2 else 0)) + (6 + L) * HC * 4
    prod = 2 * L * HC * HC * M * R
    rows = ((M * (2 * WP + HC) * item + params + tables + small) * R,
            [(prod, "bf16" if item == 2 else "f32x3"), (prod, "f32x3")])
    dw = ((tables + partials) * R, [dw_ops(prod, item)])
    red = ((partials + small + L * HC * HC * 4 + 8 * HC * 4) * R,
           [((nch * L * HC * HC + G * 8 * HC) * R, "f32")])
    return rows, dw, red


def time_k3_parts(out, suffix, agg, gy, p, H, R, M, HC, WP, L, dt, got, want):
    """K3a, K3b and K3c of the warpgroup and cluster routes apart (cuda_pma._bwd_setup's
    parts, each launched alone on the scratch of a whole launch), each
    against its plain version (bwd_rows_plain; one product per chunk and
    layer; the partials added in order) and, for K3b and K3c, one PyTorch
    call of the same function (torch.bmm over the chunks; a sum over
    them, torch.sum over both partial tables, dW's and the small
    vectors'); into out's Tallies pma_bwd_rows, pma_bwd_dw and pma_bwd_reduce
    + suffix. R=None: a K3 launch, else K3R's R runs."""
    from allset_tpu_torch.ops import cuda_pma as cp

    call, _ = cp._bwd_setup(agg, gy, *p, H, True, R)
    call()
    iters = 10 if R is None else 2
    ms = [cuda_ms(lambda: call(bit), iters) for bit in (1, 2, 4)]
    del call
    runs = [(agg, gy, p)] if R is None else [
        (agg[:, r * WP:(r + 1) * WP], gy[:, r * HC:(r + 1) * HC], [t[r] for t in p])
        for r in range(R)]
    def plain_all():  # each run's outputs freed before the next (HC 512, R 20: GiBs)
        for a, g, q in runs:
            cp.bwd_rows_plain(a, g, *q, H, True)
    plain_rows = cuda_ms(plain_all, 1)
    Mp, chunk, nch = cp.wg_chunk_plan(M)
    # h and dp per run and layer, zero-padded to whole chunks, filled in place
    hs = torch.zeros(len(runs) * L, nch * chunk, HC, device=agg.device)
    ds = torch.zeros_like(hs)
    for i, (a, g, q) in enumerate(runs):
        _, hins, dps, _ = cp.bwd_rows_plain(a, g, *q, H, True)
        for l in range(L):
            hs[i * L + l, :M] = hins[l].float()
            ds[i * L + l, :M] = dps[l]
        del hins, dps
    hs = hs.reshape(-1, chunk, HC)
    ds = ds.reshape(-1, chunk, HC)
    plain_dw = cuda_ms(lambda: [cp._mm(hs[i].T, ds[i]) for i in range(hs.shape[0])], 1)
    lib_dw = cuda_ms(lambda: torch.bmm(hs.transpose(1, 2), ds), 1 if R else 5)
    parts = torch.bmm(hs.transpose(1, 2), ds).reshape(-1, nch, HC * HC)
    del hs, ds

    # the small vectors' partials: the route's [8, HC] tables
    small = torch.randn(R or 1, k3_small_partials(M, HC, dt), 8 * HC, device=agg.device)

    def add_in_order():
        sums = []
        for t in (parts, small):
            acc = t[:, 0].clone()
            for c in range(1, t.shape[1]):
                acc += t[:, c]
            sums.append(acc)
        return sums
    plain_red = cuda_ms(add_in_order, 1 if R else 5)
    lib_red = cuda_ms(lambda: (parts.sum(dim=1), small.sum(dim=1)), 1 if R else 5)
    del parts, small
    err_a = scaled_err(got[0], want[0])[0]
    err_w = scaled_err(got[1], want[1])[0]
    costs = k3_part_costs(M, HC, WP, L, dt, R or 1)
    for name, k, pl, lib, err, (nbytes, ops) in (
            ("pma_bwd_rows", ms[0], plain_rows, None, err_a, costs[0]),
            ("pma_bwd_dw", ms[1], plain_dw, lib_dw, err_w, costs[1]),
            ("pma_bwd_reduce", ms[2], plain_red, lib_red, err_w, costs[2])):
        out.setdefault(name + suffix, Tally()).add(1, k, pl, err, nbytes, ops, lib)
    log(f"  K3 parts at M={M}, HC={HC}, R={R or 1}: K3a {ms[0]:.3f} ms (plain {plain_rows:.3f}), "
        f"K3b {ms[1]:.3f} (plain {plain_dw:.3f}, torch.bmm {lib_dw:.3f}), K3c {ms[2]:.3f} "
        f"(plain {plain_red:.3f}, sum {lib_red:.3f})")


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
        if cp.bwd_kernel(HC, dt) in ("wg", "cluster"):
            time_k3_parts(out, suffix, agg, gy, p, H, None, M, HC, WP, L, dt, got, want)
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

    KEYS = ("ms", "device_ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by", "library_ms",
            "library_device_ms")

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
           "stream_dual": b6["dual"], "stream_fold": first["B8"],
           "stream_fold_first16": first["B8 first16"]}
    for body in ("B8", "B8 first16"):
        for r in rec[body]["variants"]:
            log(f"  {r['label']}: device {r['device_ms']:.4f} ms (event {r['ms']:.4f}), bound "
                f"{r['bound_ms']:.4f} ms ({r['share']:.1%} of it), library {r['library_device_ms']:.4f}"
                f" ms (event {r['library_ms']:.4f}), launches {r['launches']}")
    _kernels.reset_launches()
    return {k: Measured(v) for k, v in out.items()}, counts


# the port's kernels on the walmart preset's path (f32, HC 256) by the
# names a trace gives them: the gather inside K1, K2R, K3R's parts
# K3a/K3b/K3c, K4, K5
PROFILE_KERNELS = ("segment_gather_kernel", "pma_fwd_wg_kernel", "pma_bwd_wg_kernel",
                   "dw_wg_kernel", "reduce_partials_kernel", "gmax_kernel", "pack_kernel")


def profile_phase(card, tmp):
    """Phase 6c: --profile DIR on the card (synthetic-walmart preset, f32,
    2 runs x 3 epochs): the trace holds the path's kernels by name
    (PROFILE_KERNELS), the run prints the summary the run without
    --profile prints and the same metrics, the launches per group and
    epoch are the preset's; logs the trace's ten largest device ops and
    the device's busy share of the traced window."""
    import contextlib
    import io

    from allset_tpu_torch.utils import profiling

    base = ["--dname", WALMART, "--preset", "--dtype", "float32", "--device", "cuda",
            "--res_root", tmp, "--runs", "2", "--epochs", "3"]
    d = os.path.join(tmp, "profile")
    got = []
    for extra in ([], ["--profile", d]):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res, _ = cli_run(base + extra, 3)
        got.append((res.summary().splitlines()[:-1], res.metrics, buf.getvalue(),
                    time.perf_counter() - t0))
    require(f"Saved profiler trace to {d}" in got[1][2], "--profile: no 'Saved profiler trace'")
    require(got[0][0] == got[1][0], f"--profile changed the summary: {got[0][0]} {got[1][0]}")
    require(bool(np.array_equal(got[0][1], got[1][1])), "--profile changed the metrics")
    path = profiling.latest_trace(d)
    summ = profiling.trace_summary(path)
    missing = [k for k in PROFILE_KERNELS if not any(k in n for n in summ["kernels"])]
    require(not missing, f"--profile: the trace lacks the port's kernels {missing}")
    log(f"  --profile: {os.path.getsize(path) / 2**20:.1f} MiB trace; {len(summ['kernels'])} "
        f"kernels, the port's {list(PROFILE_KERNELS)} among them; the same summary and metrics "
        f"as without it; {got[0][3]:.1f} s without, {got[1][3]:.1f} s with the profiler")
    for name, ms, n in summ["ops"]:
        log(f"    {ms:10.3f} ms  x{n:<6d} {name[:110]}")
    log(f"  device busy {summ['busy_ms']:.1f} of {summ['span_ms']:.1f} ms traced "
        f"({summ['busy_share']:.1%}) [{card}]")


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
            "pma_gmax": 2, "pma_pack": 2, "pma_bwd_rows": 2, "pma_bwd_dw": 2, "pma_bwd_reduce": 2}
# K3's parts on the warpgroup and cluster routes (HC 256, 384 and 512;
# cuda_pma.WG_WIDTHS, CLUSTER_BWD_WIDTHS), one launch each per K3 or K3R
# launch
WG_PARTS = ("pma_bwd_rows", "pma_bwd_dw", "pma_bwd_reduce")


def off_wg(per, HC=None):
    """``per`` at width HC (None: a width off both routes): K3 launches
    without its parts' counters where K3 takes neither the warpgroup nor
    the cluster route."""
    from allset_tpu_torch.ops import cuda_pma as cp

    if HC is not None and cp.bwd_kernel(HC, torch.float32) in ("wg", "cluster"):
        return dict(per)
    return {k: v for k, v in per.items() if k not in WG_PARTS}


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
    for k in path_kernels():
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


def time_epilogue_epoch(batch, dev, gen, R=20, HC=256, suffix="", bwd=True):
    """K2R and (with ``bwd``) K3R at the runs path's two half-layers' row
    counts (hidden HC, 8 heads, f32, R runs folded): K2R twice each per
    epoch (train and eval), K3R once each, summed per epoch; each held to
    its plain version with phase 3's tolerances, and each run of K3R bit
    for bit to K3 on its slice. Returns {name + suffix: Tally}."""
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    inc = batch.inc.real
    H, WP, L, dt = 8, HC + 8, 2, torch.float32
    fwd, bwd_name = "pma_epilogue_fwd_runs" + suffix, "pma_epilogue_bwd_runs" + suffix
    out = {fwd: Tally(), bwd_name: Tally()} if bwd else {fwd: Tally()}
    for M in (inc.num_edges + batch.num_nodes, batch.num_nodes):
        agg, gy, p = runs_inputs(M, HC, H, WP, L, R, dt, dev, gen, floor_rows=False)
        kf = cuda_ms(lambda: cp.epilogue_fwd_runs_cuda(agg, *p, H, True), iters=3)
        pf = cuda_ms(lambda: cp.epilogue_fwd_runs_plain(agg, *p, H, True), iters=2)
        ef, rf = scaled_err(cp.epilogue_fwd_runs_cuda(agg, *p, H, True),
                            cp.epilogue_fwd_runs_plain(agg, *p, H, True))
        require(rf <= EPI_FWD_TOL[dt], f"K2R disagrees at M={M}, HC={HC}: {rf}")
        out[fwd].add(2, kf, pf, ef, *epi_cost(M, HC, WP, L, dt, False, R))
        if not bwd:
            log(f"  K2R at M={M}, HC={HC}, R={R}: kernel {kf:.3f} ms, plain {pf:.3f} ms, "
                f"max_abs_err {ef:.3e} (scaled {rf:.2e})")
            del agg, gy, p
            torch.cuda.empty_cache()
            continue
        kb = cuda_ms(lambda: cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, True), iters=3)
        pb = cuda_ms(lambda: cp.epilogue_bwd_runs_plain(agg, gy, *p, H, True), iters=2)
        got = cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, True)
        want = cp.epilogue_bwd_runs_plain(agg, gy, *p, H, True)
        bmsg = check_bwd(got, want, TOL[dt][1], f"runs M={M}, HC={HC}")
        eb, _ = scaled_err(got[0], want[0])
        if cp.bwd_kernel(HC, dt) in ("wg", "cluster"):
            time_k3_parts(out, suffix + "_epoch", agg, gy, p, H, R, M, HC, WP, L, dt, got, want)
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
        out[bwd_name].add(1, kb, pb, eb, *epi_cost(M, HC, WP, L, dt, True, R))
        log(f"  K2R at M={M}, HC={HC}, R={R}: kernel {kf:.3f} ms, plain {pf:.3f} ms, "
            f"max_abs_err {ef:.3e} (scaled {rf:.2e}); K3R: kernel {kb:.3f} ms, plain {pb:.3f} "
            f"ms, dagg max_abs_err {eb:.3e}; scaled max {bmsg}; each run bit-identical to K3")
    _kernels.reset_launches()
    return out


PER_GROUP_EPOCH = {"segment_sum_gather": 6, "pma_epilogue_fwd_runs": 4, "pma_epilogue_bwd_runs": 2,
                   "pma_epilogue_fwd": 0, "pma_epilogue_bwd": 0, "pma_gmax": 4, "pma_pack": 4,
                   "pma_bwd_rows": 2, "pma_bwd_dw": 2, "pma_bwd_reduce": 2}
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
        total = {k: sum(per(g).get(k, 0) for g in res.groups) * epochs for k in path_kernels()}
        require(total == {k: counts[k] for k in path_kernels()},
                f"launches {counts}, expected {total} (groups {res.groups})")
        require(bool(math.isfinite(res.metrics.sum())), "non-finite metrics")
        return res, counts
    per = pma_group_epoch() if per is None else per
    got = {k: counts[k] / n for k in path_kernels()}
    want = {k: float(per.get(k, 0)) for k in path_kernels()}
    require(got == want, f"launches per group and epoch {got}, expected {want} "
            f"(groups {res.groups})")
    require(bool(math.isfinite(res.metrics.sum())), "non-finite metrics")
    return res, counts


def runs_protocol(card, tmp, dev):
    """The walmart preset through the CLI (20 runs folded, f32): launches
    per group and epoch, a falling loss, the CSV line, the peak device
    memory per folded run against the trainer's estimate (which must not be
    lower), ms per epoch; 2 runs folded against 2 one by one; the modes;
    --exclude_self on synthetic. Returns the counts and ms per epoch."""
    base = ["--dname", WALMART, "--preset", "--dtype", "float32", "--device", "cuda",
            "--res_root", tmp]
    epochs = 4
    res, counts, peak, est = cli_peak(base + ["--epochs", str(epochs)], epochs, None, dev)
    log(f"  the preset: peak device memory per folded run {peak / 2**30:.3f} GiB; the "
        f"trainer's estimate {est / 2**30:.3f} GiB [{card}]")
    require(est >= peak, "the preset: the trainer's estimate is below the measured peak")
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
    for flags, per, cfg in ((["--GPR"], pma_group_epoch(ln_fwd=2, ln_bwd=1), {"gpr": True}),
                            (["--LearnMask"], None, {"learn_mask": True}),
                            (["--add_self_loop", "false"], None, {"add_self_loop": False})):
        res_m, counts_m, peak_m, est_m = cli_peak(base + ["--epochs", "2", *flags], 2, per, dev,
                                                  **cfg)
        mode = " ".join(flags)
        log(f"  {mode}: {res_m.metrics.shape[0]} runs in groups {res_m.groups}, "
            f"launches {counts_m}; params {res_m.num_params}; "
            f"{res_m.wall_time / 2 * 1e3:.1f} ms per epoch over 2 epochs (first included); "
            f"peak device memory per folded run {peak_m / 2**30:.3f} GiB; the trainer's "
            f"estimate {est_m / 2**30:.3f} GiB [{card}]")
        require(est_m >= peak_m, f"{mode}: the trainer's estimate is below the measured peak")
    # the CLI's defaults: 2 layers, hidden 64, 1 head (HC + H = 65, WP = 72)
    # (its 2-layer classifier has one LayerNorm)
    res_x, counts_x = cli_run(["--dname", "synthetic", "--exclude_self", "--runs", "1",
                               "--epochs", "2", "--device", "cuda", "--res_root", tmp], 2,
                              off_wg(pma_group_epoch(layers=2, ln_fwd=2, ln_bwd=1)))
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
    res, counts, peak, est = cli_peak(base + ["--epochs", str(epochs)], epochs,
                                      off_wg(pma_group_epoch(), 512), dev, mlp_hidden=512)
    loss = res.metrics[:, :, 3].mean(axis=0)
    log(f"  --MLP_hidden 512: {res.metrics.shape[0]} runs in groups {res.groups}; launches "
        f"{counts}; params {res.num_params}; mean training loss per epoch "
        f"{[round(float(v), 6) for v in loss]}; {res.wall_time / epochs * 1e3:.1f} ms per "
        f"epoch over {epochs} epochs (first included) [{card}]")
    require(loss[-1] < loss[0], "--MLP_hidden 512: training loss did not fall")
    log(f"  --MLP_hidden 512: peak device memory per folded run {peak / 2**30:.3f} GiB; the "
        f"trainer's estimate {est / 2**30:.3f} GiB [{card}]")
    require(est >= peak, "--MLP_hidden 512: the trainer's estimate is below the measured peak")
    folded_vs_one_by_one(base + ["--runs", "2", "--epochs", "2"], 2,
                         off_wg(pma_group_epoch(), 512))
    return counts


def wide_protocol(card, tmp, dev):
    """--MLP_hidden 1024 through the CLI at the walmart preset (8 heads,
    f32): 2 runs x 1 epoch through K2R/K3R's wide route (launches per
    group and epoch as at 256), finite metrics, the peak device memory per
    folded run against the trainer's estimate (which must not be lower).
    Returns the counts."""
    res, counts, peak, est = cli_peak(
        ["--dname", WALMART, "--preset", "--MLP_hidden", "1024", "--dtype", "float32",
         "--device", "cuda", "--runs", "2", "--epochs", "1", "--res_root", tmp], 1,
        off_wg(pma_group_epoch()), dev, mlp_hidden=1024)
    log(f"  --MLP_hidden 1024: {res.metrics.shape[0]} runs in groups {res.groups}; launches "
        f"{counts}; params {res.num_params}; {res.wall_time * 1e3:.1f} ms for the epoch "
        f"[{card}]")
    log(f"  --MLP_hidden 1024: peak device memory per folded run {peak / 2**30:.3f} GiB; the "
        f"trainer's estimate {est / 2**30:.3f} GiB [{card}]")
    require(est >= peak, "--MLP_hidden 1024: the trainer's estimate is below the measured peak")
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


# --- phases 4d and 6b: the rest of the CLI surface --------------------------


@contextlib.contextmanager
def direction_spy(seen: set):
    """Inside: every half-layer of SetGNN adds (sl_mode, rows) of the
    Direction it runs to ``seen``."""
    from allset_tpu_torch.nn.modules import HalfNLHconv

    orig = HalfNLHconv.forward

    def spy(self, x, d, *a, **k):
        seen.add((d.sl_mode, d.num_dst))
        return orig(self, x, d, *a, **k)

    HalfNLHconv.forward = spy
    try:
        yield
    finally:
        HalfNLHconv.forward = orig


def run_train_steps(model, batch, mask, steps, seed=0):
    """``steps`` Adam steps with train=True (batch statistics, dropout from
    a card generator seeded ``seed``), each timed on the host clock to a
    synchronize -> (losses, times)."""
    from allset_tpu_torch.train import masked_nll

    gen = torch.Generator(device=batch.x.device).manual_seed(seed)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=0.0)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = masked_nll(model(batch, True, gen), batch.y, mask)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return torch.stack(losses), times


def bn_bench_steps(batch, batches, dev, card):
    """'bn' at the bench step (bf16, hidden 256): AllSetTransformer,
    AllDeepSets and CEGCN, 8 training steps each (batch statistics) with
    every launch count set to 0 just before: the launches per step as the
    code predicts (the same kernels as 'ln' less B12/B13, which 'bn' leaves),
    a finite and falling loss, two runs from one state bit-identical; the
    SetGNN half-layers on the unsplit exchange (every hyperedge row, the
    self-loops inside the sparse reduce); the median step time."""
    from allset_tpu_torch.ops import _kernels

    steps, nnz = 8, batch.inc.nnz_padded
    inc = batch.inc
    cases = (
        ("AllSetTransformer", lambda s: bench_model(s, nnz, normalization="bn"), batch,
         PER_STEP),
        ("AllDeepSets", lambda s: bench_model(s, nnz, pma=False, aggregate="add",
                                              normalization="bn"), batch,
         {"segment_sum_gather": 4}),
        ("CEGCN", lambda s: zoo_model(batches, dev, "CEGCN",
                                      dict(method="CEGCN", normalization="bn"), seed=s)[0],
         batches["CEGCN"], zoo_launches("CEGCN")),
    )
    out = {}
    for name, build, b, per in cases:
        mask = torch.arange(b.num_nodes, device=dev) % 2 == 0
        model = build(0).to(dev)
        state = {k: v.clone() for k, v in model.state_dict().items()}
        run_train_steps(build(0).to(dev), b, mask, 1)  # warm-up on a throwaway copy
        seen = set()
        _kernels.reset_launches()
        with direction_spy(seen):
            losses, times = run_train_steps(model, b, mask, steps)
        counts = dict(_kernels.launches)
        for k in path_kernels():
            require(counts[k] == per.get(k, 0) * steps,
                    f"bn {name}: {k} launched {counts[k]} times, expected {per.get(k, 0) * steps}")
        if name != "CEGCN":
            want = {("none", inc.num_edges), ("none", inc.num_nodes)}
            require(seen == want, f"bn {name}: exchanges {seen}, expected the unsplit {want}")
        lo = losses.cpu()
        require(bool(torch.isfinite(lo).all()) and lo[-1] < lo[0],
                f"bn {name}: losses {lo.tolist()}")
        model2 = build(1).to(dev)
        model2.load_state_dict(state)
        losses2, _ = run_train_steps(model2, b, mask, steps)
        require(torch.equal(losses, losses2), f"bn {name}: two runs from one state differ")
        ms = statistics.median(times) * 1e3
        out[name] = ms
        log(f"  [bn {name}] launches over {steps} steps {counts}; exchanges {sorted(seen)}; "
            f"losses {[round(v, 6) for v in lo.tolist()]}; two runs from one state "
            f"bit-identical; median step {ms:.3f} ms [{card}] (smoke, not a benchmark)")
        del model, model2
        torch.cuda.empty_cache()
    return out


def pma_options_check(batch, dev, card):
    """PMA's parity options at the bench step's shapes (f32, 256 features,
    hidden 256, 8 heads, 2-layer rFF, the unsplit V->E exchange): the
    segment mode and return_attention (global and segment) against the
    global mode within tests/test_parity_setgnn.py's rtol 1e-4, atol 1e-5;
    each destination's attention sums to 1 (rtol 1e-4); a backward through
    each, finite. The options launch no K4/K5 and no K2/K3: the segment
    mode runs the B10/B9 gathers and K1, return_attention in the global
    mode the gather inside K1; both compose the epilogue's LayerNorms on
    B12/B13."""
    from allset_tpu_torch.nn.modules import PMA
    from allset_tpu_torch.ops import _kernels

    d = batch.inc.v2e()
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(d.num_src, 256, generator=gen).to(dev)
    tgt = torch.randn(d.num_dst, 256, generator=gen).to(dev)
    ref = None
    fused = ("pma_gmax", "pma_pack", "pma_epilogue_fwd", "pma_epilogue_bwd")
    for label, kw in (("global", {}), ("segment", dict(softmax_mode="segment")),
                      ("return_attention", dict(return_attention=True)),
                      ("segment, return_attention", dict(softmax_mode="segment",
                                                         return_attention=True))):
        m = PMA(256, 256, 256, 2, 8, torch.Generator().manual_seed(0), fold_relu=True,
                **kw).to(dev)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        out = m(x, d)
        y, attn = out if kw.get("return_attention") else (out, None)
        (y * tgt).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in _kernels.launches.items() if v}
        require(all(bool(torch.isfinite(p.grad).all()) for p in m.parameters()),
                f"PMA {label}: non-finite gradient")
        if not kw:
            require(all(counts.get(k, 0) == 1 for k in fused), f"PMA global: {counts}")
            ref = y.detach()
            log(f"  [PMA global] launches {counts}; fwd+bwd {ms:.1f} ms [{card}]")
            continue
        require(not any(counts.get(k, 0) for k in fused) and counts.get("layer_norm_fwd") == 2,
                f"PMA {label}: launches {counts}")
        if kw.get("softmax_mode") == "segment":
            require(counts.get("segment_sum", 0) > 0
                    and counts.get("gather", 0) + counts.get("gather_sorted", 0) > 0,
                    f"PMA {label}: launches {counts}")
        else:
            require(counts.get("segment_sum_gather", 0) > 0, f"PMA {label}: launches {counts}")
        err = (y.detach() - ref).abs()
        require(bool((err <= 1e-5 + 1e-4 * ref.abs()).all()),
                f"PMA {label} against global: max abs err {err.max().item()}")
        msg = f"max abs err against global {err.max().item():.3e} (rtol 1e-4, atol 1e-5)"
        if attn is not None:
            k = d.nnz
            sums = torch.zeros(d.num_dst, 8, device=dev).index_add_(0, d.dst[:k],
                                                                   attn[:k].detach())
            present = torch.unique(d.dst[:k])
            dev_sum = (sums[present] - 1).abs().max().item()
            require(dev_sum <= 1e-4, f"PMA {label}: attention sums off 1 by {dev_sum}")
            msg += f"; attention sums within {dev_sum:.2e} of 1"
        log(f"  [PMA {label}] launches {counts}; {msg}; fwd+bwd {ms:.1f} ms [{card}]")
        del m, out, y, attn
    torch.cuda.empty_cache()


MINI_NODES = 2000  # nodes per dataset of the miniature archive (phase 6b)


def real_names_protocol(card, tmp):
    """The real dataset names through the CLI from a miniature archive in
    the real layout (allset_tpu_torch.data.miniature; the raw archive is
    not in the repository): --dname cora and walmart-trips-100 at the
    CLI's defaults (2 layers, hidden 64, 1 head), 2 runs x 5 epochs, the
    launches per group and epoch, a finite and falling training loss."""
    import numpy as np

    from allset_tpu_torch.data.miniature import write_miniature_archive

    root = write_miniature_archive(os.path.join(tmp, "archive"), nodes=MINI_NODES, seed=0)
    per = off_wg(pma_group_epoch(layers=2, ln_fwd=2, ln_bwd=1))
    for name in ("cora", "walmart-trips-100"):
        res, counts = cli_run(["--dname", name, "--data_root", root, "--cache_dir",
                               os.path.join(tmp, "cache"), "--runs", "2", "--epochs", "5",
                               "--device", "cuda", "--res_root", tmp], 5, per)
        loss = res.metrics[:, :, 3].mean(axis=0)
        require(bool(np.isfinite(loss).all()) and loss[-1] < loss[0],
                f"{name}: training loss {loss.tolist()}")
        log(f"  --dname {name} ({MINI_NODES} nodes, miniature archive): launches {counts}; "
            f"mean training loss per epoch {[round(float(v), 6) for v in loss]}; final test "
            f"{res.best_by_valid()['final_test'][0]:.2f}; {res.wall_time / 5 * 1e3:.1f} ms per "
            f"epoch [{card}]")


def saved_state_check(argv, epochs, dev, tmp, **cfg):
    """2 runs folded and the same 2 runs one by one, each with
    --save_params: equal accuracies and losses within rtol 2e-3 (as
    folded_vs_one_by_one), the two saved states the same bits (each run's
    best-valid parameters and running statistics); the folded state
    loaded into a fresh model on the card evaluates to each run's Final
    Test."""
    import numpy as np

    from allset_tpu_torch.data import load_dataset
    from allset_tpu_torch.models import build_model
    from allset_tpu_torch.train import TrainConfig, Trainer, masked_acc
    from allset_tpu_torch.train.factory import ExperimentConfig, prepare
    from allset_tpu_torch.train.presets import preset_for
    from allset_tpu_torch.utils.checkpoint import load_checkpoint

    paths = [os.path.join(tmp, f"state_{k}.pt") for k in ("folded", "seq")]
    folded, _ = cli_run(argv + ["--save_params", paths[0]], epochs)
    seq, _ = cli_run(argv + ["--no_vmap_runs", "--save_params", paths[1]], epochs)
    require(folded.groups == [2] and seq.groups == [1, 1], "2-run groups")
    require(np.array_equal(folded.metrics[..., :3], seq.metrics[..., :3]),
            "folded and sequential accuracies differ")
    rel = np.abs(folded.metrics[..., 3:] - seq.metrics[..., 3:]) / np.abs(seq.metrics[..., 3:])
    require(rel.max() <= 2e-3, f"folded and sequential losses differ: {rel.max()}")
    a, b = load_checkpoint(paths[0]), load_checkpoint(paths[1])
    same = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    require(same, "the folded runs' saved states differ from the runs' alone")
    fields = ExperimentConfig.__dataclass_fields__
    tuned = {k: v for k, v in preset_for(WALMART, 1.0).items() if k in fields}
    data = load_dataset(WALMART, feature_noise=1.0, seed=0)
    mcfg, batch = prepare(ExperimentConfig(dname=WALMART, **{**tuned, **cfg, "runs": 2}), data,
                          dev)
    model = load_checkpoint(paths[0], build_model(mcfg, [torch.Generator() for _ in range(2)]))
    model = model.to(dev)
    masks = Trainer(mcfg, batch, TrainConfig(runs=2)).masks()
    with torch.no_grad():
        acc = masked_acc(model(batch, False), batch.y, masks["test"]).cpu().numpy()
    best = folded.best_by_valid()["best_epoch"]
    want = folded.metrics[np.arange(2), best, 2]
    require(np.array_equal(acc, want), f"reloaded state: test accuracy {acc}, Final Test {want}")
    log(f"  2 runs x {epochs} epochs folded vs one by one: equal accuracies, losses within "
        f"{rel.max():.2e}, saved best-valid states ({len(a)} tensors) bit-identical; the "
        f"reloaded state's test accuracy {acc.tolist()} = each run's Final Test (best epochs "
        f"{best.tolist()})")
    del model, batch


def bn_protocol(card, tmp, dev):
    """--normalization bn at the walmart preset through the CLI (20 runs
    folded, f32, hidden 256, 8 heads): launches per group and epoch as
    'ln' on the unsplit exchange (both half-layers over every row), a
    falling loss, ms per epoch, the peak device memory per folded run
    against the trainer's estimate (which must not be lower); then
    saved_state_check on 2 runs. AllDeepSets with 'bn' (the batch norm
    on its f_enc/f_dec rows) the same way, 20 runs x 2 epochs."""
    import numpy as np

    base = ["--dname", WALMART, "--preset", "--dtype", "float32", "--device", "cuda",
            "--res_root", tmp, "--normalization", "bn"]
    epochs = 3
    seen = set()
    with direction_spy(seen):
        res, counts, peak, est = cli_peak(base + ["--epochs", str(epochs)], epochs, None, dev,
                                          normalization="bn")
    require(all(m == "none" for m, _ in seen) and len(seen) == 2,
            f"bn: exchanges {seen}, expected the unsplit pair")
    loss = res.metrics[:, :, 3].mean(axis=0)
    require(bool(np.isfinite(loss).all()) and loss[-1] < loss[0], f"bn: losses {loss}")
    log(f"  --normalization bn: {res.metrics.shape[0]} runs in groups {res.groups}; launches "
        f"{counts}; exchanges {sorted(seen)}; mean training loss per epoch "
        f"{[round(float(v), 6) for v in loss]}; {res.wall_time / epochs * 1e3:.1f} ms per epoch "
        f"over {epochs} epochs (first included); peak device memory per folded run "
        f"{peak / 2**30:.3f} GiB; the trainer's estimate {est / 2**30:.3f} GiB [{card}]")
    require(est >= peak, "bn: the trainer's estimate is below the measured peak")
    saved_state_check(base + ["--runs", "2", "--epochs", "3"], 3, dev, tmp, normalization="bn")
    ds = base + ["--method", "AllDeepSets"]
    res_d, counts_d, peak_d, est_d = cli_peak(ds + ["--epochs", "2"], 2, {"segment_sum_gather": 6},
                                              dev, normalization="bn", method="AllDeepSets")
    loss = res_d.metrics[:, :, 3].mean(axis=0)
    require(bool(np.isfinite(loss).all()) and loss[-1] < loss[0], f"bn AllDeepSets: {loss}")
    log(f"  AllDeepSets --normalization bn: groups {res_d.groups}; launches {counts_d}; "
        f"{res_d.wall_time / 2 * 1e3:.1f} ms per epoch over 2 epochs (first included); peak "
        f"device memory per folded run {peak_d / 2**30:.3f} GiB; the trainer's estimate "
        f"{est_d / 2**30:.3f} GiB [{card}]")
    require(est_d >= peak_d, "bn AllDeepSets: the trainer's estimate is below the measured peak")


# --remat recomputes the training forward in the backward: one more forward
# per group and epoch (the gather inside K1's two forward passes, K2R, K4,
# K5), the backward unchanged
REMAT_GROUP_EPOCH = {**PER_GROUP_EPOCH, "segment_sum_gather": 8, "pma_epilogue_fwd_runs": 6,
                     "pma_gmax": 6, "pma_pack": 6}


def remat_protocol(card, tmp, dev):
    """--remat through the CLI: the walmart preset (20 runs x 2 epochs, f32)
    without and with it, in the order plain, remat, remat, plain: the
    metrics (losses and accuracies) bit-identical, one more forward's
    launches per group and epoch (REMAT_GROUP_EPOCH), ms per epoch and the
    peak device memory per folded run each time; AllDeepSets with 'bn' (2
    runs x 2 epochs: dropout and batch statistics inside the recompute)
    bit-identical too."""
    import numpy as np

    base = ["--dname", WALMART, "--preset", "--dtype", "float32", "--device", "cuda",
            "--res_root", tmp, "--epochs", "2"]
    got = {False: [], True: []}
    for remat in (False, True, True, False):
        flags = ["--remat"] if remat else []
        res, counts, peak, est = cli_peak(base + flags, 2,
                                          REMAT_GROUP_EPOCH if remat else None, dev)
        got[remat].append((res, peak))
        log(f"  the preset{' --remat' if remat else ''}: groups {res.groups}; launches "
            f"{counts}; {res.wall_time / 2 * 1e3:.1f} ms per epoch over 2 epochs; peak device "
            f"memory per folded run {peak / 2**30:.3f} GiB (the trainer's estimate "
            f"{est / 2**30:.3f} GiB) [{card}]")
    runs = [r for r, _ in got[False] + got[True]]
    require(all(np.array_equal(runs[0].metrics, r.metrics) for r in runs[1:]),
            "--remat: the preset's metrics differ")
    ds = ["--method", "AllDeepSets", "--normalization", "bn", "--runs", "2"]
    plain, _ = cli_run(base + ds, 2, {"segment_sum_gather": 6})
    remat, _ = cli_run(base + ds + ["--remat"], 2, {"segment_sum_gather": 8})
    require(np.array_equal(plain.metrics, remat.metrics),
            "--remat: AllDeepSets with bn differs")
    log("  --remat: the preset's and AllDeepSets-bn's metrics bit-identical with and without")


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
    ids past both ends, the same ids unsorted, int32 and int64 ids; 1 KiB
    rows (64 16-byte vectors) in two column chunks of a warp."""
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
    over 782 chunks), int64 and int32 ids with gaps (a third of the
    table's rows never read) and clamped ids at -1 and past the last row;
    at the default L2 budget (one slab) and at budgets that cut W into
    slabs of 72 (uneven) and 88 columns; W 13 through the padding wrapper
    against the pair's route; the identity CSR (indptr = arange(n + 1))
    against index_select, as B11's take."""
    from allset_tpu_torch.graph.incidence import chunk_plan
    from allset_tpu_torch.ops import _kernels, cuda_gather as cg, cuda_segment as cs

    rows, nseg = 3000, 3000
    item = {torch.float32: 4, torch.bfloat16: 2}
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
            # slabs: the default budget (one slab here), and budgets that cut
            # W as the tables above the L2 budget are cut, in slabs of 72
            # and of 88 columns (W 264: 72 x 3 + 48 and 88 x 3; 20 x 264:
            # 72 x 73 + 24 and 88 x 60)
            budgets = [cs.L2_BUDGET] + [rows * c * item[dtype] for c in (72, 88) if c < W]
            for n in norms:
                rows_g = cg.gather_fwd_cuda(w, ids)
                pair = cs.segment_sum_cuda(rows_g if n is None else cs.scale_rows(rows_g, n),
                                           ip, nseg, plan)
                ordered = cs.gather_segment_sum_planned(w, ids, ip, nseg, plan, n)
                what = f"{dtype}, W={W}, norm {None if n is None else tuple(n.shape)}"
                require(torch.equal(pair, ordered), f"B10 + K1 differs from the planned order "
                        f"({what})")
                for b in budgets:
                    for idt in (torch.int64, torch.int32):
                        got = cs.gather_segment_sum_cuda(w, ids.to(idt), ip, nseg, plan, n,
                                                         budget=b)
                        torch.cuda.synchronize()
                        require(torch.equal(got, pair), f"segment_sum_gather differs from B10 + "
                                f"K1 ({what}, {idt}, slabs "
                                f"{cs.slab_plan(rows, W, item[dtype], b)})")
                del got, rows_g, pair, ordered
            slabs = [cs.slab_plan(rows, W, item[dtype], b) for b in budgets]
            log(f"  segment_sum_gather {str(dtype)[6:]:8s} W={W:4d}: bit-equal to B10 + scale + "
                f"K1 and to the planned order (no norm, per entry{', [20, k]' if W > 384 else ''};"
                f" {k} int64 and int32 ids, a 50,000-entry hub, empty segments, clamped ids; "
                f"(slab columns, slabs) {slabs})")
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


def onehot_skewed_case(nnz, nseg, s_blk, chunk, F, dtype, dev, gen):
    """Sorted ids over nseg segments with 92% of the entries in block 1
    (five hub segments take 60% of those, the rest of the block uniform),
    the other 8% uniform over all; padded as onehot_case pads them."""
    from allset_tpu_torch.ops import cuda_onehot as co

    n_hub = int(nnz * 0.92)
    hubs = s_blk + torch.randperm(s_blk, generator=gen)[:5]
    heavy = hubs[torch.randint(0, 5, (int(n_hub * 0.6),), generator=gen)]
    rest = torch.randint(s_blk, 2 * s_blk, (n_hub - heavy.shape[0],), generator=gen)
    spread = torch.randint(0, nseg, (nnz - n_hub,), generator=gen)
    ids = torch.cat([heavy, rest, spread]).sort().values.to(torch.int32)
    m_pad = -(-nseg // s_blk) * s_blk
    dst = torch.full((co.pad_for_kernel(nnz, chunk),), m_pad + 7, dtype=torch.int32)
    dst[:nnz] = ids
    msgs = torch.randn(dst.shape[0], F, generator=gen).to(dtype)
    bip = co.block_indptr(ids, m_pad, s_blk)
    require(int((bip[1:] - bip[:-1]).max()) >= 0.9 * nnz, "the skewed case has no hub block")
    return (msgs.to(dev), dst.to(dev), bip.to(dev), m_pad)


def check_segsum_onehot(dev, gen):
    """Every B1-family variant against its plain version (ONEHOT_TOL):
    f32 at F 192 and bf16 at F 384, chunks of 512 rows; uniform ids
    (30,011 entries over 1,000 segments, padded to the block; msgs with
    the spare chunk and, for the first variant of each block size, ending
    at the last entry: rows past it read as zeros with no id) and hub-
    skewed ids (200,003 entries, one block holding 92%: split into work
    items; every variant's two launches bit-equal, B3 and B6 full also at
    work items of 512 and 4,096 rows)."""
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
        skewed = {}
        for label, s_blk, kw in onehot_variants():
            if s_blk not in skewed:
                skewed[s_blk] = onehot_skewed_case(200_003, 1000, s_blk, 512, F, dtype, dev, gen)
            msgs, dst, bip, m_pad = skewed[s_blk]
            want = co.segsum_onehot_plain(msgs, dst, bip, m_pad, s_blk, 512, **kw)
            sizes = (co.ITEM_ROWS, 512, 4096) if label in ("B3 nacc=2", "B6 full") else (
                co.ITEM_ROWS,)
            for item_rows in sizes:
                got = co.segsum_onehot_cuda(msgs, dst, bip, m_pad, s_blk, 512, **kw,
                                            item_rows=item_rows)
                again = co.segsum_onehot_cuda(msgs, dst, bip, m_pad, s_blk, 512, **kw,
                                              item_rows=item_rows)
                torch.cuda.synchronize()
                _, rel = scaled_err(got, want)
                require(rel <= ONEHOT_TOL, f"segsum_onehot {label} disagrees on the skewed ids "
                        f"({dtype}, items of {item_rows} rows): {rel}")
                require(torch.equal(got, again), f"segsum_onehot {label}: two launches differ "
                        f"on the skewed ids ({dtype}, items of {item_rows} rows)")
                worst = max(worst, rel)
        log(f"  segsum_onehot {str(dtype)[6:]:8s} F={F}: {len(onehot_variants())} variants (B1, "
            f"B2 nbuf {co.NBUFS}, B3 nacc {co.NACCS}, B4 builds {co.BUILDS}, B6 {co.MODES}) "
            f"on uniform and hub-skewed ids within {worst:.2e} of the plain versions (tol "
            f"{ONEHOT_TOL:g}); two launches bit-equal on the skewed ids")
        del cases, skewed
    _kernels.reset_launches()


def check_stream(dev, gen):
    """B5, B7 and B8 (fold and first 16 rows) against their plain
    versions within 1e-5 scaled: f32 and bf16, [70 x 512 + 3, 384] rows
    (a ragged tail past the whole blocks), chunks of 512 and 1,024 (B8 also
    2,048; two calls bit for bit); B5 and B7 also with NaN in every chunk's
    rows 16 and up (they read only the first 16 rows: finite outputs,
    within 1e-5)."""
    from allset_tpu_torch.ops import _kernels, cuda_stream as cst

    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(70 * 512 + 3, 384, generator=gen).to(dtype).to(dev)
        y = torch.randn(70 * 512 + 3, 384, generator=gen).to(dtype).to(dev)
        seed = torch.randn(16, 384, generator=gen).to(dev)
        worst = 0.0
        for c in (512, 1024, 2048):
            xn, yn = x[: 70 * 512 // c * c].clone(), y[: 70 * 512 // c * c].clone()
            for t in (xn, yn):
                t.view(-1, c, 384)[:, 16:] = float("nan")
            cases = [("B8 fold", lambda: cst.stream_fold(x, seed, c),
                      lambda: cst.stream_fold_plain(x, seed, c)),
                     ("B8 first16", lambda: cst.stream_fold(x, seed, c, "first16"),
                      lambda: cst.stream_fold_plain(x, seed, c, "first16"))]
            if c < 2048:
                cases += [("B5", lambda: cst.stream_flat(x, seed, c),
                           lambda: cst.stream_flat_plain(x, seed, c)),
                          ("B7", lambda: cst.stream_dual(x, y, seed, c),
                           lambda: cst.stream_dual_plain(x, y, seed, c)),
                          ("B5 NaN past row 16", lambda: cst.stream_flat(xn, seed, c),
                           lambda: cst.stream_flat_plain(xn, seed, c)),
                          ("B7 NaN past row 16", lambda: cst.stream_dual(xn, yn, seed, c),
                           lambda: cst.stream_dual_plain(xn, yn, seed, c))]
            for name, fn, plain in cases:
                got, want = fn(), plain()
                torch.cuda.synchronize()
                _, rel = scaled_err(got, want)
                require(rel <= 1e-5, f"{name} disagrees ({dtype}, chunk {c}): {rel}")
                if name.startswith("B8"):
                    require(torch.equal(got, fn()), f"{name}: two calls differ ({dtype}, "
                            f"chunk {c})")
                worst = max(worst, rel)
        log(f"  stream {str(dtype)[6:]:8s}: B5, B7 (also with NaN past each chunk's row 16) at "
            f"chunks 512 and 1024, B8 fold and first16 at chunks 512, 1024 and 2048 (two calls "
            f"bit for bit) within {worst:.2e} of the plain versions (tol 1e-5)")
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
    from allset_tpu_torch.ops import _kernels

    model, batch, mask = zoo_model(batches, dev, "UniGAT", dict(ZOO)["UniGAT"])
    calls, _, sums = record_launches(lambda: run_steps(model, batch, mask, 1))
    want = zoo_launches("UniGAT")
    require(len(calls) == want["gather"],
            f"a UniGAT step gathered {len(calls)} times, expected {want['gather']}")
    require(len(sums) == want["segment_sum"],
            f"a UniGAT step summed {len(sums)} times, expected {want['segment_sum']}")
    del model
    out = {"gather": time_gathers(calls, dev, "step"),
           "segment_sum": time_segment_sums(sums, dev, "step")}
    _kernels.reset_launches()
    return out


def record_launches(step):
    """Run ``step()`` with the B10, B9 and K1 wrappers recording their
    calls -> (B10 calls, B9 calls, K1 calls): (table shape, dtype, ids) for
    the gathers, (msgs shape, dtype, indptr, nseg, plan) for K1."""
    from allset_tpu_torch.ops import cuda_gather as cg, cuda_segment as cs

    calls = {"rows": [], "sorted": [], "sums": []}
    orig = cg.gather_fwd_cuda, cg.gather_sorted_fwd_cuda, cs.segment_sum_cuda

    def gathers(key, fn):
        def record(table, ids):
            calls[key].append((tuple(table.shape), table.dtype, ids))
            return fn(table, ids)
        return record

    def record_sum(msgs, indptr, nseg, plan):
        calls["sums"].append((tuple(msgs.shape), msgs.dtype, indptr, nseg, plan))
        return orig[2](msgs, indptr, nseg, plan)

    cg.gather_fwd_cuda = gathers("rows", orig[0])
    cg.gather_sorted_fwd_cuda = gathers("sorted", orig[1])
    cs.segment_sum_cuda = record_sum
    try:
        step()
    finally:
        cg.gather_fwd_cuda, cg.gather_sorted_fwd_cuda, cs.segment_sum_cuda = orig
    return calls["rows"], calls["sorted"], calls["sums"]


def group_calls(calls):
    """Recorded gathers with the same ids and table shape, timed once:
    [(shape, dtype, ids, count)]."""
    groups = {}
    for shape, dtype, ids in calls:
        key = (shape, dtype, ids.data_ptr(), ids.shape[0], ids.dtype)
        groups.setdefault(key, [shape, dtype, ids, 0])[3] += 1
    return list(groups.values())


def time_gathers(calls, dev, per):
    """B10 at each recorded gather's shape on a random table (time_gather),
    summed per ``per`` -> Tally."""
    t = Tally()
    for shape, dtype, ids, n in group_calls(calls):
        table = torch.randn(shape, device=dev).to(dtype)
        k, lib = time_gather(t, table, ids, n)
        log(f"  B10 at [{ids.shape[0]}, {list(shape[1:])}] {str(dtype)[6:]} from {shape[0]} rows "
            f"(x{n} per {per}): kernel {k:.4f} ms, index_select {lib:.4f} ms")
        del table
    return t


def time_segment_sums(sums, dev, per):
    """K1 at each recorded sum's shape on random rows: kernel, plain and
    library times (torch.segment_reduce), held bit for bit to its plain
    version in its order and to the plain version with phase 3's
    tolerance, summed per ``per`` -> Tally."""
    from allset_tpu_torch.ops import cuda_segment as cs

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
        log(f"  K1 at {list(shape)} {str(dtype)[6:]} -> {nseg} segments (x{n} per {per}): "
            f"kernel {k:.4f} ms, plain {p:.3f} ms, {lib_name} {lib:.4f} ms; bit-equal to its "
            f"order")
        del msgs, got
    return k1


def time_sorted_gathers(calls, dev, per):
    """B9 at each recorded sorted gather's shape on a random table, with B10
    and index_select (on the ids clamped beforehand), held bit for bit to
    the plain version, summed per ``per``; each timed two ways: CUDA events
    around 20 calls back to back (the wrapper's host work included where
    it is longer than the kernel) and the device time from a CUDA graph of
    20 calls (graph_ms). The bound counts each distinct row read once, each
    output row written once and the ids -> (Tally, B10's summed event ms
    at the same shapes)."""
    from allset_tpu_torch.ops import cuda_gather as cg

    t, b10_total = Tally(), 0.0
    for shape, dtype, ids, n in group_calls(calls):
        table = torch.randn(shape, device=dev).to(dtype)
        clamped = ids.clamp(0, shape[0] - 1)
        fns = (lambda: cg.gather_sorted_fwd_cuda(table, ids),
               lambda: cg.gather_fwd_cuda(table, ids), lambda: table.index_select(0, clamped))
        (k, b10, lib), (kd, b10d, libd) = ([cuda_ms(f, iters=20) for f in fns],
                                           [graph_ms(f) for f in fns])
        p = cuda_ms(lambda: cg.gather_sorted_fwd_plain(table, ids), iters=5)
        require(torch.equal(cg.gather_sorted_fwd_cuda(table, ids),
                            cg.gather_sorted_fwd_plain(table, ids)),
                f"B9 differs at [{ids.shape[0]}, {list(shape[1:])}]")
        distinct = int(torch.unique(clamped).numel())
        nbytes = table[0].numel() * table.element_size()
        t.add(n, k, p, 0.0, (distinct + ids.shape[0]) * nbytes + ids.shape[0] * ids.element_size(),
              [], library_ms=lib, device_ms=kd)
        b10_total += n * b10
        log(f"  B9 at [{ids.shape[0]}, {list(shape[1:])}] {str(dtype)[6:]} from {shape[0]} rows "
            f"({distinct} distinct; x{n} per {per}): events: kernel {k:.4f} ms, B10 {b10:.4f} ms, "
            f"index_select {lib:.4f} ms; device (CUDA graph): kernel {kd:.4f} ms, B10 "
            f"{b10d:.4f} ms, index_select {libd:.4f} ms; plain {p:.4f} ms")
        del table
    return t, b10_total


def time_gather_sorted_step(batches, dev):
    """B9 per CEGAT bench step: the sorted gathers of one training step
    are recorded (table shape and dtype, the ids), as many as
    ce_gat_launches predicts, then each is timed at its shape
    (time_sorted_gathers). Returns {"gather_sorted": Tally} (B10's time
    at the same shapes is logged)."""
    from allset_tpu_torch.ops import _kernels

    model, batch, mask = zoo_model(batches, dev, "CEGAT", dict(CE)["CEGAT"])
    _, calls, _ = record_launches(lambda: run_steps(model, batch, mask, 1))
    want = zoo_launches("CEGAT")["gather_sorted"]
    require(len(calls) == want, f"a CEGAT step gathered sorted {len(calls)} times, expected {want}")
    del model
    t, b10_total = time_sorted_gathers(calls, dev, "step")
    log(f"  B9's gathers per CEGAT step: B9 {t.ms:.4f} ms (device {t.device_ms:.4f} ms), B10 "
        f"at the same shapes {b10_total:.4f} ms")
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
    for k in path_kernels():
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
    for k in path_kernels():
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


# --- phase 4e: the HAN vertical ----------------------------------------------------

# benchmarks/han_bench.py's graph: a planted partition of 65,536 nodes and
# 32,768 hyperedges of 12 members on average, 64 features, 8 classes, seed
# 0, its metapath graphs built with bucket 1,024 (4,788,390 VEV and
# 2,387,764 EVE pairs, BENCH_HAN_r05.json); HAN at the reference's DGL_HAN
# defaults, 8 heads of 8 (a packed table 72 wide), f32
HAN_SHAPE = dict(num_nodes=1 << 16, num_hyperedges=1 << 15, avg_edge_size=12, num_classes=8,
                 feature_dim=64, seed=0)
HAN_PAIRS = (4_788_390, 2_387_764)
HAN_HEADS, HAN_HIDDEN = 8, 8


def han_launches(epoch=False):
    """HAN's launches per training step (forward, backward: one layer, the
    VEV and EVE convs) or, with ``epoch``, per train_han epoch (the
    evaluation forward too). Per conv, forward: B10 once (dir_gather of the
    [T, HC+H] packed table), K1 once (the reduce by destination) and one
    gather of the [T, H] f32 destination scores by the sorted destination
    ids; backward: B10 once (the gather's cotangent into the src-sorted
    order), K1 twice (the two gathers' transposes) and one gather of the
    reduce's [T, HC+H] cotangent rows by the sorted destination ids (its
    transpose). A gather by sorted ids takes B9 where its row is narrow
    (sorted_route)."""
    nf = 2 if epoch else 1
    HC, H = HAN_HEADS * HAN_HIDDEN, HAN_HEADS
    out = {"gather": 0, "gather_sorted": 0, "segment_sum": 0}
    for _ in ("vev", "eve"):
        out["gather"] += nf + 1
        out["segment_sum"] += nf + 2
        out[sorted_route(4 * H)] += nf
        out[sorted_route(4 * (HC + H))] += 1
    return out


def han_config(dropout=0.0):
    from allset_tpu_torch.models.han import HANConfig

    return HANConfig(num_features=HAN_SHAPE["feature_dim"], num_classes=HAN_SHAPE["num_classes"],
                     hidden_units=HAN_HIDDEN, num_heads=(HAN_HEADS,), dropout=dropout)


def han_model(seed, dev):
    from allset_tpu_torch.models.han import HAN

    return HAN(han_config(), torch.Generator().manual_seed(seed)).to(dev)


def han_graphs(dev):
    """HAN's graph and its metapath graphs, the host build timed, and HAN's
    batch on ``dev`` -> (HyperData, Batch)."""
    from allset_tpu_torch.data import synthetic_hypergraph
    from allset_tpu_torch.graph import Batch
    from allset_tpu_torch.graph.metapath import build_metapath_graphs
    from allset_tpu_torch.models.han import han_extras

    t0 = time.perf_counter()
    hd = synthetic_hypergraph(**HAN_SHAPE)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats, labels, vev, eve = build_metapath_graphs(hd, bucket=1024)
    t_build = time.perf_counter() - t0
    log(f"  HAN graph: {hd.num_nodes} nodes, {hd.num_hyperedges} hyperedges, nnz {hd.nnz} "
        f"(generated on the host in {t_gen:.2f} s); metapath build (host scipy SpGEMM and the "
        f"two Incidences): {t_build:.3f} s, VEV {vev.nnz} pairs, EVE {eve.nnz}")
    require((vev.nnz, eve.nnz) == HAN_PAIRS,
            f"metapath pairs {(vev.nnz, eve.nnz)}, expected {HAN_PAIRS}")
    batch = Batch(x=torch.as_tensor(feats), y=torch.as_tensor(labels), inc=None,
                  extras=han_extras(vev, eve)).to(dev)
    return hd, batch


def han_loss_mask(batch):
    """The labelled rows: the nodes (the hyperedge rows carry -1)."""
    return batch.y >= 0


def han_path(batch, dev, card):
    """8 HAN training steps (forward, backward, Adam; dropout 0) on the full
    graph with every launch count set to 0 just before, checked against
    han_launches; a finite, falling loss; two runs from one state
    bit-identical; the median step (host clock to a synchronize), M
    metapath-pairs/s and the peak device memory. Returns (counts, median
    ms)."""
    from allset_tpu_torch.ops import _kernels

    steps = 8
    mask = han_loss_mask(batch)
    model = han_model(0, dev)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    run_steps(han_model(0, dev), batch, mask, 1)  # warm-up on a throwaway copy
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    losses, times = run_steps(model, batch, mask, steps)
    peak = torch.cuda.max_memory_allocated(dev)
    counts = dict(_kernels.launches)
    per = han_launches()
    for k in path_kernels():
        require(counts[k] == per.get(k, 0) * steps,
                f"HAN: {k} launched {counts[k]} times, expected {per.get(k, 0) * steps}")
    lo = losses.cpu()
    log(f"  [HAN] launches over {steps} steps {counts}; losses "
        f"{[round(v, 6) for v in lo.tolist()]}")
    require(bool(torch.isfinite(lo).all()), "HAN: non-finite loss")
    require(lo[-1] < lo[0], "HAN: loss did not fall")
    model2 = han_model(1, dev)
    model2.load_state_dict(state)
    losses2, _ = run_steps(model2, batch, mask, steps)
    require(torch.equal(losses, losses2), "HAN: two runs from one state differ")
    ms = statistics.median(times) * 1e3
    log(f"  [HAN] two runs from one state bit-identical; median step (fwd+bwd+Adam) {ms:.3f} ms "
        f"[{min(times) * 1e3:.3f}, {max(times) * 1e3:.3f}]; "
        f"{sum(HAN_PAIRS) / (ms / 1e3) / 1e6:.3f} M metapath-pairs/s; peak {peak / 2**30:.3f} "
        f"GiB, {(peak - base) / 2**30:.3f} above the graphs and the model held before the step "
        f"[{card}] (smoke, not a benchmark)")
    del model, model2
    torch.cuda.empty_cache()
    return counts, ms


@contextlib.contextmanager
def han_plain_route():
    """B10, B9 and K1 on their plain versions, also for CUDA tensors:
    han_parity's comparison only (their launches are not counted)."""
    from allset_tpu_torch.ops import cuda_gather as cg, cuda_segment as cs

    orig = cg.gather_fwd_cuda, cg.gather_sorted_fwd_cuda, cs.segment_sum_cuda
    cg.gather_fwd_cuda, cg.gather_sorted_fwd_cuda = cg.gather_fwd_plain, cg.gather_sorted_fwd_plain
    cs.segment_sum_cuda = lambda msgs, indptr, nseg, plan: cs.segment_sum_plain(msgs, indptr, nseg)
    try:
        yield
    finally:
        cg.gather_fwd_cuda, cg.gather_sorted_fwd_cuda, cs.segment_sum_cuda = orig


def tied_nodes_han(model, batch, margin=TIE_MARGIN):
    """Rows whose loss reaches a leaky_relu or ELU argument within
    ``margin`` of 0 in a HAN forward (see tied_nodes): a score's tie marks
    its entry's destination row, an ELU tie its row where the conv's graph
    has entries (a row without any is exactly 0 on both routes). The rows
    of each conv's output are the rows the loss reads (the nodes, through
    the VEV conv; EVE's populated rows are hyperedges, outside the loss).
    The semantic attention mixes every row into the metapaths' weights, by
    1/T a row, which the gradient tolerance covers."""
    from allset_tpu_torch.models import han

    rows = torch.zeros(batch.num_nodes, dtype=torch.bool, device=batch.x.device)
    graphs = []
    orig_leaky, orig_elu = han._leaky_relu, torch.nn.functional.elu

    def near(t):
        return (t.detach().abs() < margin).reshape(t.shape[0], -1).any(dim=1)

    def leaky(x, slope):
        g = graphs[-1]
        if x.dim() == 2 and x.shape[0] == g.nnz_padded:  # the entries' scores
            rows[g.edge[near(x) & g.mask]] = True
        return orig_leaky(x, slope)

    def elu(x, *a, **k):
        rows.logical_or_(near(x) & (graphs[-1].edge_count > 0))
        return orig_elu(x, *a, **k)

    hooks = [m.register_forward_pre_hook(lambda m, args: graphs.append(args[0]))
             for m in model.modules() if isinstance(m, han.DGLGATConv)]
    han._leaky_relu, torch.nn.functional.elu = leaky, elu
    try:
        with torch.no_grad():
            model(batch, False)
    finally:
        han._leaky_relu, torch.nn.functional.elu = orig_leaky, orig_elu
        for h in hooks:
            h.remove()
    return rows


def han_parity(batch, dev):
    """One HAN step's loss and gradients through the kernels against the
    same step through the plain versions on the card (han_plain_route),
    from the same parameters, at full width, on the loss without the rows
    tied_nodes_han finds on either route: the loss within 1e-5, every
    gradient within 1e-3 of its tensor's max |.| (phase 5's rule)."""
    from allset_tpu_torch.ops import _kernels
    from allset_tpu_torch.train import masked_nll

    model = han_model(3, dev)
    tied = tied_nodes_han(model, batch)
    with han_plain_route():
        tied |= tied_nodes_han(model, batch)
    real = han_loss_mask(batch)
    mask = real & ~tied
    out = {}
    for route in ("kernels", "plain"):
        model.zero_grad(set_to_none=True)
        _kernels.reset_launches()
        with han_plain_route() if route == "plain" else contextlib.nullcontext():
            loss = masked_nll(model(batch, False), batch.y, mask)
            loss.backward()
        n = sum(_kernels.launches[k] for k in path_kernels())
        require((n == 0) == (route == "plain"), f"HAN parity: {n} launches on the {route} route")
        out[route] = loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}
    (l_k, g_k), (l_p, g_p) = out["kernels"], out["plain"]
    rel = abs(l_k - l_p) / abs(l_p)
    require(rel <= 1e-5, f"HAN: the loss through the kernels disagrees: {rel}")
    worst = (0.0, "")
    for k in g_p:
        e = (g_k[k] - g_p[k]).abs().max().item() / max(g_p[k].abs().max().item(), 1e-6)
        require(e <= 1e-3, f"HAN: gradient {k} disagrees: {e}")
        worst = max(worst, (e, k))
    log(f"  [HAN] one step through B10, B9, K1 against their plain versions on the card: "
        f"{int((real & tied).sum())} of {int(real.sum())} loss rows left out (a tie within "
        f"{TIE_MARGIN:g}); loss rel {rel:.2e} (tol 1e-5); worst scaled gradient error "
        f"{worst[0]:.2e} ({worst[1]}; tol 1e-3)")
    del model
    _kernels.reset_launches()


def time_han_kernels(batch, dev):
    """B10, B9 and K1 per HAN step: the step's calls recorded, as many as
    han_launches predicts, then each timed at its shape on random inputs
    (time_gathers, time_sorted_gathers, time_segment_sums). Returns
    {"gather_han", "gather_sorted_han", "segment_sum_han": Tally}."""
    from allset_tpu_torch.ops import _kernels

    model = han_model(0, dev)
    rows, srt, sums = record_launches(lambda: run_steps(model, batch, han_loss_mask(batch), 1))
    want = han_launches()
    got = {"gather": len(rows), "gather_sorted": len(srt), "segment_sum": len(sums)}
    require(got == want, f"a HAN step launched {got}, expected {want}")
    del model
    out = {"gather_han": time_gathers(rows, dev, "HAN step"),
           "segment_sum_han": time_segment_sums(sums, dev, "HAN step")}
    out["gather_sorted_han"], b10 = time_sorted_gathers(srt, dev, "HAN step")
    log(f"  B9's gathers per HAN step: B9 {out['gather_sorted_han'].ms:.4f} ms, B10 at the same "
        f"shapes {b10:.4f} ms")
    _kernels.reset_launches()
    return out


def han_train_runs(batch, dev, card, runs=2, epochs=8):
    """train_han on the full graph: ``runs`` runs of ``epochs`` epochs at the
    reference's defaults (dropout 0.6, lr 0.005, weight decay 0.001;
    patience above the epochs), with every launch count set to 0 just
    before: each epoch's launches (han_launches(epoch=True)) and each run's
    final prediction's (a forward); each run's training losses (recorded
    from han_step) finite and falling; the metrics finite."""
    from allset_tpu_torch.ops import _kernels
    from allset_tpu_torch.train import han_trainer as ht

    losses, orig = [], ht.han_step

    def step(*a):
        out = orig(*a)
        losses.append(out[0])
        return out

    ht.han_step = step
    _kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        res = ht.train_han(han_config(0.6), batch, ht.HANTrainConfig(num_epochs=epochs, runs=runs))
    finally:
        ht.han_step = orig
    wall = time.perf_counter() - t0
    counts = dict(_kernels.launches)
    per, step_only = han_launches(epoch=True), han_launches()
    for k in path_kernels():
        n = runs * (epochs * per.get(k, 0) + per.get(k, 0) - step_only.get(k, 0))
        require(counts[k] == n, f"train_han: {k} launched {counts[k]} times, expected {n}")
    lo = torch.stack(losses).cpu().view(runs, epochs)
    require(bool(torch.isfinite(lo).all()), "train_han: non-finite loss")
    for r in range(runs):
        require(lo[r, -1] < lo[r, 0], f"train_han: run {r}'s loss did not fall")
    require(all(math.isfinite(v) for v in res.values()), f"train_han: {res}")
    log(f"  [train_han] {runs} runs x {epochs} epochs (dropout 0.6) in {wall:.2f} s; launches "
        f"{counts}; losses {[[round(v, 5) for v in row] for row in lo.tolist()]}; "
        f"{', '.join(f'{k} {v:.3f}' for k, v in res.items())} [{card}]")


def sampled_han_steps(hd, batch, dev, card):
    """SampledHAN at B = 32 (the reference's batch) and 4096 on HAN's graph:
    the host sampler's seeds/s (20 neighbours); 20 training steps
    (sampled_step, dropout 0) on one batch's blocks with every launch count
    set to 0 just before: three B10 launches a step (the seeds' rows and
    each block's rows), finite losses; the median step (host clock to a
    synchronize), steps/s and seeds/s. Then a short train_han_minibatch
    (1 run, 2 epochs, B 4096) ends finite."""
    from allset_tpu_torch.data.sampler import HANNeighborSampler
    from allset_tpu_torch.models.han import SampledHAN
    from allset_tpu_torch.ops import _kernels
    from allset_tpu_torch.train import han_trainer as ht
    from allset_tpu_torch.train.factory import make_optimizer

    N, steps = hd.num_nodes, 20
    sampler = HANNeighborSampler(hd, num_neighbors=20, seed=0)
    for B in (32, 4096):
        seeds = np.arange(B) % N
        reps = max(1, 2048 // B)
        t0 = time.perf_counter()
        for _ in range(reps):
            blocks_h = sampler.sample(seeds)
        t_sample = (time.perf_counter() - t0) / reps
        blocks = ht.block_tensors(blocks_h, dev)
        sd, valid = torch.as_tensor(seeds).to(dev), torch.ones(B, dtype=torch.bool, device=dev)
        model = SampledHAN(han_config(), torch.Generator().manual_seed(0)).to(dev)
        opt = make_optimizer(model, 0.005, 0.001)
        ht.sampled_step(model, opt, batch.x, batch.y, sd, blocks, valid, None)  # warm-up
        _kernels.reset_launches()
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(ht.sampled_step(model, opt, batch.x, batch.y, sd, blocks, valid, None))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = dict(_kernels.launches)
        for k in path_kernels():
            n = 3 * steps if k == "gather" else 0
            require(counts[k] == n, f"SampledHAN: {k} launched {counts[k]} times, expected {n}")
        lo = torch.stack(losses).cpu()
        require(bool(torch.isfinite(lo).all()), f"SampledHAN B={B}: non-finite loss")
        ms = statistics.median(times) * 1e3
        log(f"  [SampledHAN B={B}] median step {ms:.3f} ms ({1e3 / ms:.1f} steps/s, "
            f"{B / ms:.1f} K seeds/s on the device); host sampler {t_sample * 1e3:.3f} ms a batch "
            f"({B / t_sample / 1e3:.1f} K seeds/s); 3 B10 launches a step; losses "
            f"{lo[0].item():.5f} -> {lo[-1].item():.5f} [{card}]")
    t0 = time.perf_counter()
    res = ht.train_han_minibatch(
        han_config(0.6), batch.x, batch.y, sampler,
        ht.HANSampleConfig(batch_size=4096, num_epochs=2, runs=1))
    require(all(math.isfinite(v) for v in res.values()), f"train_han_minibatch: {res}")
    log(f"  [train_han_minibatch] 1 run x 2 epochs, B 4096, in {time.perf_counter() - t0:.2f} s: "
        f"{', '.join(f'{k} {v:.3f}' for k, v in res.items())}")
    _kernels.reset_launches()


def hetero_han_step(hd, dev, card):
    """HeteroHAN on HAN's graph as a typed graph (V, E; relations Vs_E and
    E_Vs) with the metapath V-E-V: the coalesce (host SpGEMM, cached)
    timed, its pairs the VEV graph's; one forward and backward with every
    launch count set to 0 just before: one conv's launches (half of
    han_launches), a finite loss."""
    from allset_tpu_torch.graph.hetero import HeteroGraph, HeteroHAN
    from allset_tpu_torch.ops import _kernels
    from allset_tpu_torch.train import masked_nll

    g = HeteroGraph(num_nodes={"V": hd.num_nodes, "E": hd.num_hyperedges},
                    edges={("V", "Vs_E", "E"): (hd.node, hd.edge),
                           ("E", "E_Vs", "V"): (hd.edge, hd.node)})
    model = HeteroHAN(han_config(), [["Vs_E", "E_Vs"]], torch.Generator().manual_seed(0),
                      bucket=1024).to(dev)
    x, y = torch.as_tensor(hd.x).to(dev), torch.as_tensor(hd.y).to(dev)
    t0 = time.perf_counter()
    graphs = model.coalesced(g, dev)
    t_co = time.perf_counter() - t0
    require(graphs[0].nnz == HAN_PAIRS[0], f"HeteroHAN: {graphs[0].nnz} V-E-V pairs")
    ones = torch.ones(hd.num_nodes, dtype=torch.bool, device=dev)
    masked_nll(model(g, x), y, ones).backward()  # warm-up
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    loss = masked_nll(model(g, x), y, ones)
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(_kernels.launches)
    per = han_launches()
    for k in path_kernels():
        require(counts[k] == per.get(k, 0) // 2,
                f"HeteroHAN: {k} launched {counts[k]} times, expected {per.get(k, 0) // 2}")
    require(math.isfinite(loss.item()), "HeteroHAN: non-finite loss")
    log(f"  [HeteroHAN] coalesce (host SpGEMM, cached after) {t_co:.3f} s, {graphs[0].nnz} pairs; "
        f"fwd+bwd {ms:.3f} ms ({graphs[0].nnz / (ms / 1e3) / 1e6:.3f} M metapath-pairs/s), "
        f"launches {counts}, loss {loss.item():.5f} [{card}]")
    _kernels.reset_launches()


def han_phase(dev, card):
    """Phase 4e. Returns (the HAN step's launch counts, the _han kernel
    rows)."""
    t_phase = time.perf_counter()
    hd, batch = han_graphs(dev)
    han_parity(batch, dev)
    counts, _ = han_path(batch, dev, card)
    rows = time_han_kernels(batch, dev)
    log_tallies(rows, "HAN step")
    han_train_runs(batch, dev, card)
    sampled_han_steps(hd, batch, dev, card)
    hetero_han_step(hd, dev, card)
    log(f"  phase 4e took {time.perf_counter() - t_phase:.1f} s")
    del batch
    torch.cuda.empty_cache()
    return counts, rows


# --- phase 4f: the edge-partitioned step -------------------------------------
#
# The sharded exchange's launches per AllSetTransformer step over D shards:
# the gather inside K1 once a direction and shard forward (B11's role) and
# once backward (K1's reduce by src), K2 and K3 (with K3's parts, K3c the
# reduce among them) once a direction and shard, K4 and K5 on the
# replicated tables once a direction; B10 for the self-loop rows and, on
# balanced cuts, the reasm and dist_idx gathers.
def sharded_per_step(D):
    return {"segment_sum_gather": 4 * D, "pma_epilogue_fwd": 2 * D, "pma_epilogue_bwd": 2 * D,
            "pma_bwd_rows": 2 * D, "pma_bwd_dw": 2 * D, "pma_bwd_reduce": 2 * D,
            "pma_gmax": 2, "pma_pack": 2}


def grad_step(model, batch, mask):
    """One forward and backward (no optimizer step) -> (loss, gradients,
    launches, collectives, collective bytes), each count set to 0 just
    before."""
    from allset_tpu_torch.ops import _kernels
    from allset_tpu_torch.parallel import distributed
    from allset_tpu_torch.train import masked_nll

    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    distributed.reset_collectives()
    loss = masked_nll(model(batch, False), batch.y, mask)
    loss.backward()
    torch.cuda.synchronize()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return (loss.item(), grads, dict(_kernels.launches), dict(distributed.collectives),
            dict(distributed.collective_bytes))


def hold_sharded(label, single, sharded, tol):
    """The sharded step's loss and every gradient against the single-device
    step's: the loss within tol[0] relative, each gradient within tol[1]
    of its tensor's max |.|."""
    (l1, g1), (l2, g2) = single[:2], sharded[:2]
    rel = abs(l2 - l1) / max(abs(l1), 1e-12)
    require(math.isfinite(l2) and rel <= tol[0], f"{label}: loss {l2} against {l1}")
    require(set(g1) == set(g2), f"{label}: gradients of other parameters")
    worst = (0.0, "")
    for k in g1:
        scale = max(g1[k].float().abs().max().item(), 1e-6)
        e = (g2[k].float() - g1[k].float()).abs().max().item() / scale
        require(e <= tol[1], f"{label}: gradient {k} disagrees: {e}")
        worst = max(worst, (e, k))
    log(f"  [{label}] loss sharded {l2:.7f} single {l1:.7f} rel {rel:.2e} (tol {tol[0]:g}); "
        f"worst scaled gradient error {worst[0]:.2e} ({worst[1]}; tol {tol[1]:g})")


def check_sharded_launches(label, launches, want, extra=()):
    """Exactly ``want`` launches of its kernels and each of ``extra`` at
    least once."""
    for k, n in want.items():
        require(launches[k] == n, f"{label}: {k} launched {launches[k]}, expected {n}")
    for k in extra:
        require(launches.get(k, 0) > 0, f"{label}: {k} never launched")


def check_census(label, shex, coll, nbytes, width, item, hc=None, learn_mask=False):
    from allset_tpu_torch.parallel.sharded import sharded_comm_stats

    st = sharded_comm_stats(shex, width, item, learn_mask=learn_mask, epilogue_hc=hc)
    want = {"all_gather": st["reassembly_fwd"] + st["allgathers_bwd"],
            "all_reduce": st["psums_bwd"]}
    want_b = {"all_gather": st["fwd_bytes"] + st["bwd_ag_bytes"],
              "all_reduce": st["bwd_bytes"]}
    require(coll == want and nbytes == want_b,
            f"{label}: collectives {coll} {nbytes}, sharded_comm_stats {want} {want_b}")
    log(f"  [{label}] collectives per step {coll}, bytes {nbytes}: as sharded_comm_stats "
        f"counts them (no all-to-all)")


def step_ms(model, batch, mask, steps=5):
    """Median host-clock time of a training step (forward, backward, Adam)
    in ms, after one warm-up step."""
    _, times = run_steps(model, batch, mask, steps + 1)
    return statistics.median(times[1:]) * 1e3


def entry_line(shex):
    from allset_tpu_torch.parallel.step import skew

    return "; ".join(f"{d}: entries per shard {list(getattr(shex, d).shard_nnz)} (skew "
                     f"{skew(getattr(shex, d).shard_nnz):.3f}, balanced cuts "
                     f"{getattr(shex, d).reasm is not None})" for d in ("v2e", "e2v"))


def sharded_world1(batch, dev, card, tmp):
    """(a) world size 1 over NCCL at the bench graph's size and width
    (bf16, HC 256, 8 heads): one AllSetTransformer step through the fused
    sharded epilogue in both directions against the single-device step,
    launches and census; the step times. Returns the sharded step's
    launches."""
    import dataclasses

    import torch.distributed as dist

    from allset_tpu_torch.parallel import distributed
    from allset_tpu_torch.parallel.sharded import ShardedExchange, sharded_epilogue_active

    distributed.init_process_group("nccl", rank=0, world_size=1, device=dev, timeout_s=120,
                                   init_method="file://" + os.path.join(tmp, "nccl_store"))
    try:
        comm = distributed.edge_comm(dev)
        t0 = time.perf_counter()
        shex = ShardedExchange.build(batch.inc, comm.num_shards).shard(comm)
        log(f"  (a) {distributed.comm_summary(comm)}; partition built and placed in "
            f"{time.perf_counter() - t0:.1f} s; {entry_line(shex)}")
        bs = dataclasses.replace(batch, shex=shex)
        model = bench_model(0, batch.inc.nnz_padded).to(dev)
        require(sharded_epilogue_active(shex.v2e, 256, 8, 2, 256), "(a) fused epilogue inactive")
        state = {k: v.clone() for k, v in model.state_dict().items()}
        mask = torch.arange(batch.num_nodes, device=dev) % 2 == 0
        single = grad_step(model, batch, mask)
        sharded = grad_step(model, bs, mask)
        label = "world 1, NCCL, bench step"
        hold_sharded(label, single, sharded, TOL[torch.bfloat16])
        launches = sharded[2]
        log(f"  [{label}] launches per sharded step: "
            f"{ {k: v for k, v in launches.items() if v} }")
        check_sharded_launches(label, launches, sharded_per_step(1), extra=("gather",))
        check_census(label, shex, sharded[3], sharded[4], 264, 2, hc=256)
        times = {}
        for name, b in (("single", batch), ("sharded", bs)):
            m = bench_model(0, batch.inc.nnz_padded).to(dev)
            m.load_state_dict(state)
            times[name] = step_ms(m, b, mask)
        log(f"  [{label}] step {times['sharded']:.3f} ms sharded (NCCL world 1) against "
            f"{times['single']:.3f} ms on one device (median of 5, host clock) [{card}]")
        return launches
    finally:
        dist.destroy_process_group()


def sharded_bodies(dev, card, D=4):
    """(b) D shard bodies one after another on the card, on a skewed
    scale-free graph (balanced cuts) with the unsplit exchange LearnMask
    needs, f32, HC 256, 8 heads: AllSetTransformer with LearnMask and
    AllDeepSets with LearnMask (the SDDMM, B12/B13) against the
    single-device step. Returns the AllSetTransformer step's launches."""
    import dataclasses

    from allset_tpu_torch.data import scale_free_hypergraph
    from allset_tpu_torch.graph import Batch, add_self_loops, norm_construction
    from allset_tpu_torch.models import SetGNN, SetGNNConfig
    from allset_tpu_torch.parallel import distributed
    from allset_tpu_torch.parallel.sharded import ShardedExchange

    hd = norm_construction(add_self_loops(scale_free_hypergraph(
        num_nodes=32768, num_hyperedges=16384, avg_edge_size=12, feature_dim=256, seed=1)),
        "all_one")
    batch = Batch.from_hyperdata(hd, device=dev, bucket=1024)
    comm = distributed.local_comm(D, dev)
    shex = ShardedExchange.build(batch.inc, D, split=False).shard(comm)
    require(shex.e2v.reasm is not None, "(b) the skewed graph took equal row blocks")
    log(f"  (b) {distributed.comm_summary(comm)}; nnz {batch.inc.nnz}; {entry_line(shex)}")
    bs = dataclasses.replace(batch, shex=shex)
    even = torch.arange(batch.num_nodes, device=dev) % 2 == 0
    out = None
    for label, mode in ((f"{D} bodies, AllSetTransformer, LearnMask", dict(learn_mask=True)),
                        (f"{D} bodies, AllDeepSets, LearnMask",
                         dict(pma=False, aggregate="add", learn_mask=True))):
        cfg = SetGNNConfig(num_features=256, num_classes=8, all_num_layers=1, mlp_hidden=256,
                           classifier_num_layers=1, heads=8, dropout=0.0,
                           nnz_padded=batch.inc.nnz_padded, **mode)
        model = SetGNN(cfg, torch.Generator().manual_seed(7)).to(dev)
        pma = mode.get("pma", True)
        tied = (tied_nodes if pma else tied_nodes_deepsets)(model, batch)
        mask = even & ~tied
        single = grad_step(model, batch, mask)
        sharded = grad_step(model, bs, mask)
        hold_sharded(label, single, sharded, (1e-5, 1e-3))
        launches = sharded[2]
        log(f"  [{label}] launches per sharded step: "
            f"{ {k: v for k, v in launches.items() if v} }")
        if pma:
            check_sharded_launches(label, launches, sharded_per_step(D), extra=("gather",))
            check_census(label, shex, sharded[3], sharded[4], 264, 4, hc=256)
            out = launches
        else:
            check_sharded_launches(label, launches, {"segment_sum_gather": 4 * D},
                                   extra=("gather", "layer_norm_fwd", "layer_norm_bwd"))
            check_census(label, shex, sharded[3], sharded[4], 256, 4, learn_mask=True)
        state = {k: v.clone() for k, v in model.state_dict().items()}
        times = {}
        for name, b in (("single", batch), ("sharded", bs)):
            model.load_state_dict(state)
            times[name] = step_ms(model, b, even)
        log(f"  [{label}] step {times['sharded']:.3f} ms as {D} shard bodies in turn against "
            f"{times['single']:.3f} ms on one device (median of 5, host clock) [{card}]")
    return out


def sharded_phase(batch, dev, card):
    """Phase 4f: (a) and (b); returns the launches per sharded bench step
    of (a), and of (b)'s AllSetTransformer step."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        world1 = sharded_world1(batch, dev, card, tmp)
    bodies = sharded_bodies(dev, card)
    seen = {k for c in (world1, bodies) for k, v in c.items() if v}
    for k in ("segment_sum_gather", "pma_epilogue_fwd", "pma_epilogue_bwd", "pma_bwd_reduce",
              "pma_gmax", "pma_pack", "gather"):
        require(k in seen, f"phase 4f: {k} never launched")
    log(f"  phase 4f took {time.perf_counter() - t0:.1f} s")
    return world1, bodies


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
    ptxas = ptxas_summary(_kernels.build_log)
    for name, regs, st, ld in ptxas:
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
    # the tiled K2 and K3 (HC 64 and 128, the width of four tuned presets),
    # the cluster K2 and K3, and the wide route
    for HC in (64, 128, 384, 512, 640, 1024):
        suffix = f"_hc{HC}"
        timings.update(time_epilogue_step(batch, dev, gen, HC, suffix))
        log_tallies({k: v for k, v in timings.items() if k.endswith(suffix)},
                    f"bench step at hidden {HC}")
        wide_counts[HC], _ = main_path(batch, dev, card, off_wg(PER_STEP, HC), hidden=HC)
    main_path(batch, dev, card, PER_STEP_GPR, gpr=True)
    main_path(batch, dev, card, PER_STEP, learn_mask=True)
    deepsets = dict(pma=False, aggregate="add")
    ds_counts, _ = main_path(batch, dev, card, PER_STEP_DEEPSETS, **deepsets)
    main_path(batch, dev, card, PER_STEP_DEEPSETS, **deepsets, learn_mask=True)
    log("phase 4g: the runs-folded f32 dense products at the cells' and the zoo's shapes")
    t0 = time.perf_counter()
    timings.update(time_dense(dev, gen))
    time_dense(dev, gen, DENSE_ZOO_SHAPES, runs=(1, 20))
    log(f"  phase 4g took {time.perf_counter() - t0:.1f} s")
    log("phase 4b: the conv zoo at bench size (bf16, 2 layers, hidden 256)")
    batches = zoo_batches(batch, hd, raw)
    timings.update(time_gather_step(batches, dev))
    log_tallies({k: timings[k] for k in ("gather", "segment_sum")}, "UniGAT bench step")
    zoo_counts = {name: zoo_path(batches, dev, card, name, over)[0] for name, over in ZOO}
    log("phase 4c: CEGCN, CEGAT, HyperGCN at bench size (bf16, 2 layers)")
    timings.update(time_gather_sorted_step(batches, dev))
    log_tallies({"gather_sorted": timings["gather_sorted"]}, "CEGAT bench step")
    ce_counts = {name: zoo_path(batches, dev, card, name, over)[0] for name, over in CE}
    log("phase 4d: 'bn' at bench size (bf16, training steps) and PMA's parity options")
    t0 = time.perf_counter()
    bn_bench_steps(batch, batches, dev, card)
    pma_options_check(batch, dev, card)
    log(f"  phase 4d took {time.perf_counter() - t0:.1f} s")
    del batches
    reapprox_steps(raw, dev, card)
    log("phase 4e: HAN at benchmarks/han_bench.py's shape (f32, 8 heads of 8)")
    han_counts, han_rows = han_phase(dev, card)
    timings.update(han_rows)
    log("phase 4f: the edge-partitioned step (NCCL world 1 at bench size; 4 shard bodies)")
    sharded_counts, bodies_counts = sharded_phase(batch, dev, card)
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
    log_tallies({k: v for k, v in timings.items() if k.endswith(("_hc512_epoch", "_runs_hc512"))},
                "20-run epoch at hidden 512")
    # no CLI run at hidden 64, 128 or 384 counts their launches: logged, not
    # in the line
    for HC in (64, 128, 384):
        log_tallies(time_epilogue_epoch(wb, dev, gen, 20, HC, f"_hc{HC}"),
                    f"20-run epoch at hidden {HC} (K2R, K3R and its parts)")
    timings.update(time_epilogue_epoch(wb, dev, gen, 2, 1024, "_hc1024"))
    log_tallies({k: timings[k] for k in ("pma_epilogue_fwd_runs_hc1024",
                                         "pma_epilogue_bwd_runs_hc1024")},
                "2-run epoch at hidden 1024")
    del wb
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        runs_counts, _ = runs_protocol(card, tmp, dev)
        runs512_counts = hidden512_protocol(card, tmp, dev)
        runs1024_counts = wide_protocol(card, tmp, dev)
        deepsets_protocol(card, tmp, dev)
        ln_epoch, ln_epoch_counts = time_layer_norm_epoch(tmp, dev, gen)
        timings.update(ln_epoch)
        log_tallies(ln_epoch, "AllDeepSets 20-run epoch")
        route_runs(card, tmp)
        log("phase 6c: --profile on the card (walmart preset, 2 runs x 3 epochs)")
        t0 = time.perf_counter()
        profile_phase(card, tmp)
        log(f"  phase 6c took {time.perf_counter() - t0:.1f} s")
        zoo_cli_counts = zoo_protocol(card, tmp, dev)
        ce_cli_counts = ce_protocol(card, tmp, dev)
        log("phase 6b: real dataset names, --normalization bn, --save_params, --remat")
        t0 = time.perf_counter()
        real_names_protocol(card, tmp)
        bn_protocol(card, tmp, dev)
        remat_protocol(card, tmp, dev)
        log(f"  phase 6b took {time.perf_counter() - t0:.1f} s")
        require("jax" not in sys.modules, "the port loaded jax")
        log("phase 7: the accuracy band (5 runs x 500 epochs)")
        band_replay(card, tmp)

    onehot = "allset_tpu_torch/csrc/segsum_onehot.cu"
    stream = "allset_tpu_torch/csrc/stream.cu"
    wg = "allset_tpu_torch/csrc/pma_epilogue_wg.cu"
    cuh = "allset_tpu_torch/csrc/pma_epilogue.cuh"
    k3_384_512 = "allset_tpu_torch/csrc/pma_epilogue_cluster_bwd.cu"
    dwg = "allset_tpu_torch/csrc/pma_wgmma.cuh"
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
        "stream_fold_first16": (stream, "benchmarks/exp_autopipe.py:28", exp_counts),
        "pma_epilogue_fwd": ("allset_tpu_torch/csrc/pma_epilogue_fwd.cu",
                             "allset_tpu/ops/pallas_pma.py:170", counts),
        "pma_epilogue_bwd": ("allset_tpu_torch/csrc/pma_epilogue_wg.cu",
                             "allset_tpu/ops/pallas_pma.py:185", counts),
        # K3's parts on the warpgroup route at the bench step and the 20-run
        # epoch (HC 256)
        "pma_bwd_rows": (wg, "allset_tpu/ops/pallas_pma.py:185", counts),
        "pma_bwd_dw": (dwg, "allset_tpu/ops/pallas_pma.py:185", counts),
        "pma_bwd_reduce": (cuh, "allset_tpu/ops/pallas_pma.py:185", counts),
        "pma_bwd_rows_epoch": (wg, "allset_tpu/ops/pallas_pma.py:424", runs_counts),
        "pma_bwd_dw_epoch": (dwg, "allset_tpu/ops/pallas_pma.py:424", runs_counts),
        "pma_bwd_reduce_epoch": (cuh, "allset_tpu/ops/pallas_pma.py:424", runs_counts),
        "pma_epilogue_fwd_runs": (wg, "allset_tpu/ops/pallas_pma.py:365", runs_counts),
        "pma_epilogue_bwd_runs": (wg, "allset_tpu/ops/pallas_pma.py:424", runs_counts),
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
    # the dense kernel pair over the cells' products (phase 4g), with the
    # launches of phase 6's 20-run CLI run
    sources["runs_dense"] = ("allset_tpu_torch/csrc/runs_dense.cu", "none (XLA's products)",
                             {"runs_dense": sum(runs_counts[k] for k in _kernels.DENSE_KERNELS)})
    # B10, B9 and K1 per HAN step (phase 4e)
    for k in ("gather", "gather_sorted", "segment_sum"):
        sources[f"{k}_han"] = (*sources[k][:2], han_counts)
    # the epilogue kernels at the other widths: the bench steps at hidden
    # 64, 128 (the tiled kernels), 384, 512 (the cluster kernels), 640 and
    # 1024 (the wide route), the CLI runs at 512 and 1024
    wide = "allset_tpu_torch/csrc/pma_epilogue_wide_wg.cu"
    k2 = "allset_tpu_torch/csrc/pma_epilogue_cluster.cu"
    narrow = {"pma_epilogue_fwd": k2, "pma_epilogue_bwd": k3_384_512,
              "pma_epilogue_fwd_runs": k2, "pma_epilogue_bwd_runs": k3_384_512}
    tiled = {"pma_epilogue_fwd": "allset_tpu_torch/csrc/pma_epilogue_fwd.cu",
             "pma_epilogue_bwd": "allset_tpu_torch/csrc/pma_epilogue.cu"}
    for HC in (64, 128, 384, 512, 640, 1024):
        for k in ("pma_epilogue_fwd", "pma_epilogue_bwd"):
            src = wide if HC > 512 else narrow[k] if HC >= 384 else tiled[k]
            sources[f"{k}_hc{HC}"] = (src, sources[k][1], wide_counts[HC])
    for HC, cnt in ((512, runs512_counts), (1024, runs1024_counts)):
        for k in ("pma_epilogue_fwd_runs", "pma_epilogue_bwd_runs"):
            sources[f"{k}_hc{HC}"] = (wide if HC > 512 else narrow[k], sources[k][1], cnt)
    # K3's parts on the cluster route: the bench steps at hidden 384 and
    # 512, the CLI's 20 runs at 512
    parts = {"pma_bwd_rows": k3_384_512, "pma_bwd_dw": dwg, "pma_bwd_reduce": cuh}
    for k, src in parts.items():
        for HC in (384, 512):
            sources[f"{k}_hc{HC}"] = (src, sources[k][1], wide_counts[HC])
        sources[f"{k}_hc512_epoch"] = (src, sources[f"{k}_epoch"][1], runs512_counts)
    for k in ("layer_norm_fwd", "layer_norm_bwd"):  # per AllDeepSets 20-run epoch
        sources[f"{k}_epoch"] = (*sources[k][:2], ln_epoch_counts)
    log(f"  zoo CLI launches: {zoo_cli_counts}; CE and HyperGCN CLI launches: {ce_cli_counts}")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s "
        f"(the build included) [{card}]")
    # K2's kernels at the main path's shapes, with their registers and
    # spills: the tiled K2 (bf16 bench step), the warpgroup K2R (f32
    # epoch), the cluster K2 at hidden 384 and 512 (bf16 bench steps) and
    # K2R at 512 (f32 epoch); above 512 the wide route's product kernels
    ptxas_of = {"pma_epilogue_fwd": "pma_fwd_kernel<__nv_bfloat16, 256, false>",
                "pma_epilogue_fwd_runs": "pma_fwd_wg_kernel<float, 256, 4>",
                "pma_epilogue_fwd_hc384": "pma_fwd_cluster_kernel<__nv_bfloat16, 384>",
                "pma_epilogue_fwd_hc512": "pma_fwd_cluster_kernel<__nv_bfloat16, 512>",
                "pma_epilogue_fwd_runs_hc512": "pma_fwd_cluster_kernel<float, 512>",
                # and K3a on the cluster route (bf16 steps, f32 epoch)
                "pma_bwd_rows_hc384": "pma_bwd_cluster_kernel<__nv_bfloat16, 384>",
                "pma_bwd_rows_hc512": "pma_bwd_cluster_kernel<__nv_bfloat16, 512>",
                "pma_bwd_rows_hc512_epoch": "pma_bwd_cluster_kernel<float, 512>",
                # the wide route's products: K2's (bf16 steps, f32 epoch) and
                # K3's dp @ W^T (bf16 steps)
                "pma_epilogue_fwd_hc640": "wide_gemm_kernel<__nv_bfloat16, __nv_bfloat16>",
                "pma_epilogue_fwd_hc1024": "wide_gemm_kernel<__nv_bfloat16, __nv_bfloat16>",
                "pma_epilogue_fwd_runs_hc1024": "wide_gemm_kernel<float, float>",
                "pma_epilogue_bwd_hc640": "wide_gemm_kernel<float, __nv_bfloat16>",
                "pma_epilogue_bwd_hc1024": "wide_gemm_kernel<float, __nv_bfloat16>",
                "pma_epilogue_bwd_runs_hc1024": "wide_gemm_kernel<float, float>"}
    kernels = []
    for name, (src, rep, cnt) in sources.items():
        base = re.sub(r"(_(hc\d+|epoch|b\d+|han|first16))+$", "", name)
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": cnt[base], **timings[name].row()}
        if name == base and sharded_counts.get(base):
            # per step of phase 4f's edge-partitioned bench step (world 1)
            # and of its 4 shard bodies (the AllSetTransformer step)
            row.update(launches_sharded=sharded_counts[base],
                       launches_sharded_4_bodies=bodies_counts.get(base, 0))
        if name in ptxas_of:
            regs, st, ld = next((p[1:] for p in ptxas if ptxas_of[name] in p[0]),
                                (None, None, None))
            row.update(kernel=ptxas_of[name], registers=regs, spill_stores=st, spill_loads=ld)
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
