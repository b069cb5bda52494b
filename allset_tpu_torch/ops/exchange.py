"""Directed bipartite exchange: the fused gather -> sorted segment-sum.

Counterpart of ``allset_tpu/ops/exchange.py``, limited to what the PMA
path needs: ``dir_spmm`` with ``reduce='add'`` and ``norm=None``, on
unsplit Directions and on the self-loop split ones (``sl_mode`` 'append'
and 'add').

    out[m] = sum_{i: dst_i = m} w[src_i]

Forward: gather ``w[src]`` over the valid entries, then K1 by ``dst``.
Backward, with no permutation of [nnz, F] data: gather the cotangent
rows ``g[dst_srcsort]`` (entries in src-sorted order), then K1 over the
src-sorted CSR ``src_indptr``:

    dw[s] = sum_{i: src_i = s} g[dst_i]

Padding sorts to the tail of both entry orders, so only the first
``nnz`` entries are gathered: no out-of-range id is ever read.

Every op here acts on whole rows, so a table with R runs folded into its
width, [rows, R*W], gives each run's columns exactly what the run's own
[rows, W] table gives (tests/test_torch_runs_epilogue.py).
"""

from __future__ import annotations

import torch

from allset_tpu_torch.graph.incidence import Direction
from allset_tpu_torch.ops.cuda_segment import segment_sum

Tensor = torch.Tensor


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, d: Direction):
        msgs = w.index_select(0, d.src[: d.nnz])
        ctx.d = d
        return segment_sum(msgs, d.indptr, d.num_dst, d.plan)

    @staticmethod
    def backward(ctx, g):
        d = ctx.d
        rows = g.contiguous().index_select(0, d.dst_srcsort[: d.nnz])
        return segment_sum(rows, d.src_indptr, d.num_src, d.src_plan), None


def dir_spmm(w: Tensor, d: Direction, norm=None, reduce: str = "add") -> Tensor:
    """Fused gather -> segment-sum over a Direction; f32 accumulation, the
    result dtype follows ``w``.

    Self-loop split Directions (the N-slot layout, see
    ``Incidence.v2e_split``): 'append' concatenates every source row after
    the core output, unscaled (norm=None is unweighted); 'add' adds the
    source table's tail ``num_nodes`` rows scaled by ``sl_mask`` (zero at
    holes)."""
    if norm is not None or reduce != "add":
        raise NotImplementedError(
            "dir_spmm: weighted, 'mean' and 'max' reduces come with the "
            "AllDeepSets port (ROADMAP Queue 1 item 6)"
        )
    if d.sl_mode == "none":
        return _Spmm.apply(w, d)
    if d.sl_mode == "append":
        return torch.cat([_Spmm.apply(w, d), w], dim=0)
    if d.sl_mode == "add":
        core = _Spmm.apply(w[: d.num_src], d)
        rows = w[d.num_src :] * d.sl_mask[:, None].to(w.dtype)
        return core + rows
    raise ValueError(f"unknown sl_mode {d.sl_mode!r}")
