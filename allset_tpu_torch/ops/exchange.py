"""Directed bipartite exchange: the fused gather -> sorted segment-reduce.

Counterpart of ``allset_tpu/ops/exchange.py::dir_spmm``, on unsplit
Directions and on the self-loop split ones (``sl_mode`` 'append' and
'add'):

    out[m] = reduce_{i: dst_i = m} norm_i * w[src_i]

with reduce 'add', 'mean' (the sum over max(count, 1)) or 'max' (0 for an
empty segment), and ``norm`` absent (the unweighted PMA exchange) or a
per-entry weight in execution order.

'add' and 'mean': gather ``w[src]`` over the valid entries, scale by
``norm``, then K1 by ``dst``. The backward permutes no [nnz, F] data: it
gathers the cotangent rows ``g[dst_srcsort]`` (entries in src-sorted
order), scales them by the norm in src-sorted order, then runs K1 over the
src-sorted CSR ``src_indptr``:

    dw[s] = sum_{i: src_i = s} norm_i * g[dst_i]

With ``norm_grad`` (LearnMask) the backward also returns the SDDMM
``dnorm_i = g[dst_i] . w[src_i]`` (zero at padding). 'max' has no kernel
in the JAX package either: a torch scatter max computes it, and its
backward splits the gradient evenly over tied entries, as the JAX
segment max does.

Padding sorts to the tail of both entry orders, so only the first ``nnz``
entries are gathered: no out-of-range id is ever read.

Runs: every op here acts on whole rows, so a table with R runs folded into
its width, [rows, R*W], gives each run's columns exactly what the run's
own [rows, W] table gives (tests/test_torch_runs_epilogue.py). A norm with
a runs axis, [R, nnz_pad] (LearnMask's per-run importance), weights run
r's columns by its row r.
"""

from __future__ import annotations

import torch

from allset_tpu_torch.graph.incidence import Direction
from allset_tpu_torch.ops.cuda_segment import segment_sum

Tensor = torch.Tensor


def _scale(rows: Tensor, n: Tensor) -> Tensor:
    """rows [k, W] (W = R*F with runs) times the per-entry weights n [k]
    or [R, k], in rows' dtype."""
    if n.dim() == 1:
        return rows * n[:, None].to(rows.dtype)
    k, R = rows.shape[0], n.shape[0]
    return (rows.view(k, R, -1) * n.t()[:, :, None].to(rows.dtype)).view(k, -1)


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, norm, d: Direction, norm_grad: bool):
        k = d.nnz
        msgs = w.index_select(0, d.src[:k])
        if norm is not None:
            msgs = _scale(msgs, norm[..., :k])
        ctx.d, ctx.norm_grad = d, norm_grad
        ctx.save_for_backward(w if norm_grad else None, norm)
        return segment_sum(msgs, d.indptr, d.num_dst, d.plan)

    @staticmethod
    def backward(ctx, g):
        d, k = ctx.d, ctx.d.nnz
        w, norm = ctx.saved_tensors
        g = g.contiguous()
        rows = g.index_select(0, d.dst_srcsort[:k])
        if norm is not None:
            rows = _scale(rows, norm[..., d.perm_srcsort[:k]])
        dw = segment_sum(rows, d.src_indptr, d.num_src, d.src_plan)
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
        msgs = _scale(msgs, (norm if norm_grad else norm.detach())[..., : d.nnz])
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
