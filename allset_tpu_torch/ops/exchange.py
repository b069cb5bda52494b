"""Directed bipartite exchange: the fused gather -> sorted segment-reduce.

Counterpart of ``allset_tpu/ops/exchange.py::dir_spmm``, on unsplit
Directions and on the self-loop split ones (``sl_mode`` 'append' and
'add'):

    out[m] = reduce_{i: dst_i = m} norm_i * w[src_i]

with reduce 'add', 'mean' (the sum over max(count, 1)) or 'max' (0 for an
empty segment), and ``norm`` absent (the unweighted PMA exchange) or a
per-entry weight in execution order.

'add' and 'mean': one launch of K1 with the gather inside
(``cuda_segment.gather_segment_sum``): row r of the sum by ``dst`` is
``w[src_r]`` times ``norm_r``, read straight from the table. The backward
permutes no [nnz, F] data: the same kernel sums the cotangent rows
``g[dst_srcsort]`` (entries in src-sorted order), scaled by the norm in
src-sorted order, over the src-sorted CSR ``src_indptr``:

    dw[s] = sum_{i: src_i = s} norm_i * g[dst_i]

With ``norm_grad`` (LearnMask) the backward also returns the SDDMM
``dnorm_i = g[dst_i] . w[src_i]`` (zero at padding). 'max' has no kernel
in the JAX package either: a torch scatter max computes it, and its
backward splits the gradient evenly over tied entries, as the JAX
segment max does.

Padding sorts to the tail of both entry orders, so only the first ``nnz``
entries are gathered: no out-of-range id is ever read.

``dir_gather``, ``dir_reduce`` and ``dir_propagate`` are the composable
pieces (JAX ``ops/exchange.py``): the gather ``w[src]`` over every padded
entry (ids clamped) through the B10 row-gather kernel, whose backward
permutes the cotangent into src-sorted order (one more B10 gather) and
sums it with K1 over ``src_indptr``; the reduce by ``dst`` through K1
('add', 'mean') or a scatter max, whose backward is a row gather.

Route: ``_Spmm`` runs the gather inside K1 in both directions, at every
width and with a runs-axis norm too (one launch a pass, no B10 and no K1
launch). It gives the bits of the pair it replaced (B10's gather, the
scale, K1) and was chosen over that pair in alternating pairs on an
NVIDIA H100 80GB HBM3 at 700 W: 0.4005 against 1.0210 ms over the bench
step's four passes (bf16, width 264) and 16.019 against 50.642 ms over
the walmart 20-run epoch's six (f32, 20 x 264), the pair writing and
reading back the [nnz, W] gathered table that the fused kernel never
forms (``python -m allset_tpu_torch.experiments.exp_fused_gather``;
PERF.md §6, PR 10).

Runs: every op here acts on whole rows, so a table with R runs folded into
its width, [rows, R*W], gives each run's columns exactly what the run's
own [rows, W] table gives (tests/test_torch_runs_epilogue.py). A norm with
a runs axis, [R, nnz_pad] (LearnMask's per-run importance), weights run
r's columns by its row r.
"""

from __future__ import annotations

import torch

from allset_tpu_torch.graph.incidence import Direction, SegOrder
from allset_tpu_torch.ops.cuda_segment import gather_segment_sum, scale_rows
from allset_tpu_torch.ops.segment import gather_rows, segment_reduce

Tensor = torch.Tensor


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, norm, d: Direction, norm_grad: bool):
        k = d.nnz
        ctx.d, ctx.norm_grad = d, norm_grad
        ctx.save_for_backward(w if norm_grad else None, norm)
        return gather_segment_sum(w, d.src[:k], d.indptr, d.num_dst, d.plan,
                                  None if norm is None else norm[..., :k])

    @staticmethod
    def backward(ctx, g):
        d, k = ctx.d, ctx.d.nnz
        w, norm = ctx.saved_tensors
        g = g.contiguous()
        dw = gather_segment_sum(g, d.dst_srcsort[:k], d.src_indptr, d.num_src, d.src_plan,
                                None if norm is None else norm[..., d.perm_srcsort[:k]])
        dnorm = None
        if ctx.norm_grad:
            # SDDMM in execution order, in f32 from the cotangent rounded to
            # w's dtype; exactly zero at the padded entries
            gd = g.to(w.dtype).index_select(0, d.dst[:k]).float()
            ws = w.index_select(0, d.src[:k]).float()
            prod = gd * ws
            if norm.dim() == 2:
                prod = prod.view(k, norm.shape[0], -1)
            dnorm = torch.zeros_like(norm)
            dnorm[..., :k] = prod.sum(dim=-1).t() if norm.dim() == 2 else prod.sum(dim=-1)
        return dw, dnorm, None, None


def _max(w: Tensor, d: Direction, norm, norm_grad: bool) -> Tensor:
    """'max' over the Direction's entries: gather, scale, scatter max; an
    empty segment gives 0."""
    msgs = w.index_select(0, d.src[: d.nnz])
    if norm is not None:
        msgs = scale_rows(msgs, (norm if norm_grad else norm.detach())[..., : d.nnz])
    idx = d.dst[: d.nnz, None].expand(-1, msgs.shape[1])
    # start from -inf, not 0: the backward splits a tie with the start
    # value too, include_self or not
    out = torch.full((d.num_dst, msgs.shape[1]), float("-inf"), dtype=msgs.dtype,
                     device=msgs.device)
    out = out.scatter_reduce(0, idx, msgs, "amax", include_self=False)
    return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))


def _core(w: Tensor, d: Direction, norm, reduce: str, norm_grad: bool) -> Tensor:
    if reduce == "max":
        return _max(w, d, norm, norm_grad)
    # without norm_grad the backward gives norm no gradient (a constant)
    return _Spmm.apply(w, norm, d, norm_grad and norm is not None)


def dir_spmm(w: Tensor, d: Direction, norm=None, reduce: str = "add",
             norm_grad: bool = False) -> Tensor:
    """Fused gather -> scale -> segment-reduce over a Direction; f32
    accumulation, the result dtype follows ``w``.

    ``norm`` (execution order, [nnz_pad] or [R, nnz_pad]) weights the
    entries; without ``norm_grad`` it is a constant (no gradient), with it
    the backward returns dnorm. ``reduce``: 'add' ('sum'), 'mean' or 'max'.

    Self-loop split Directions (the N-slot layout, see
    ``Incidence.v2e_split``): 'append' concatenates every source row after
    the core output, scaled by ``sl_norm`` when weighted; 'add' adds the
    source table's tail ``num_nodes`` rows scaled by ``sl_norm`` when
    weighted and by ``sl_mask`` (zero at holes) when not; under 'max' the
    tail rows enter the max where a self-loop exists. 'mean' divides by
    ``dst_count`` (the full destination degree) clamped at 1."""
    if reduce == "sum":
        reduce = "add"
    if reduce not in ("add", "mean", "max"):
        raise ValueError(f"unknown reduce {reduce!r}")
    core_reduce = "max" if reduce == "max" else "add"
    if d.sl_mode == "none":
        out = _core(w, d, norm, core_reduce, norm_grad)
    elif d.sl_mode == "append":
        core = _core(w, d, norm, core_reduce, norm_grad)
        rows = w if norm is None else w * d.sl_norm[:, None].to(w.dtype)
        out = torch.cat([core, rows], dim=0)
    elif d.sl_mode == "add":
        core = _core(w[: d.num_src], d, norm, core_reduce, norm_grad)
        scale = d.sl_mask if norm is None else d.sl_norm
        rows = w[d.num_src :] * scale[:, None].to(w.dtype)
        if reduce == "max":  # holes must not clamp a negative max to 0
            out = torch.where(d.sl_mask[:, None] > 0, torch.maximum(core, rows), core)
        else:
            out = core + rows
    else:
        raise ValueError(f"unknown sl_mode {d.sl_mode!r}")
    if reduce == "mean":
        out = out / d.dst_count.clamp_min(1.0)[:, None].to(out.dtype)
    return out


def dir_gather(x: Tensor, d: Direction) -> Tensor:
    """Row gather ``x[d.src]`` -> [nnz_pad, F] (B10, ids clamped) whose
    backward is a sorted segment-sum: the cotangent permuted into
    src-sorted order (B10) and summed by K1 over ``src_indptr`` (a
    scatter-add when x is not the source table). The padded entries read
    the last row and must get a zero cotangent (the norm/mask
    discipline)."""
    order = (SegOrder(d.perm_srcsort, d.src_indptr, d.src_plan) if x.shape[0] == d.num_src
             else None)
    return gather_rows(x, d.src, order)


def dir_reduce(msgs: Tensor, d: Direction, reduce: str = "add") -> Tensor:
    """Segment-reduce ``msgs`` (execution order, [nnz_pad, F]) by ``d.dst``
    -> [num_dst, F]: K1 for 'add' ('sum') and 'mean' (over ``dst_count``
    clamped at 1), a scatter max for 'max' (0 on an empty segment). The
    padded tail is never read."""
    reduce = "add" if reduce == "sum" else reduce
    if reduce not in ("add", "mean", "max"):
        raise ValueError(f"unknown reduce {reduce!r}")
    out = segment_reduce(msgs, d.dst, d.num_dst, "max" if reduce == "max" else "add",
                         SegOrder(None, d.indptr, d.plan))
    if reduce == "mean":
        out = out / d.dst_count[: d.num_dst].clamp_min(1.0)[:, None].to(out.dtype)
    return out


def dir_propagate(x: Tensor, d: Direction, norm=None, reduce: str = "add") -> Tensor:
    """gather -> (norm-scale) -> sorted segment-reduce."""
    msgs = dir_gather(x, d)
    w = d.norm if norm is None else norm
    if w is not None:
        msgs = msgs * w[:, None].to(msgs.dtype)
    return dir_reduce(msgs, d, reduce)
