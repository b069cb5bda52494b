"""Segment primitives over the incidence COO: gather, segment reduces,
segment softmax, propagate.

Counterpart of ``allset_tpu/ops/segment.py`` (without its
``indices_are_sorted`` hint: the ids' sort, ``order`` below, takes its
place), with torch_scatter
semantics (the reference's backend): 'mean' divides by per-segment counts
clamped to at least 1, 'max' gives 0 on an empty segment, and an
out-of-range segment id (the padding convention: ``num_segments``) drops
its entry.

  * ``gather_rows``: ``x[idx]`` with the ids clamped (``mode="clip"``), so
    a padded id equal to ``num_rows`` reads the last row; on the card the
    B10 row-gather kernel (``ops/cuda_gather.py``), or B9 where the ids'
    order says they are sorted and the row is narrow
    (``cuda_gather.gather_route``: the score tables of a softmax by
    sorted destination ids);
  * ``segment_sum`` and the reduces built on it;
  * ``segment_max``: a torch ``scatter_reduce`` (amax), whose backward
    splits the gradient evenly over tied entries, as the JAX segment max
    does;
  * ``segment_softmax`` (mask fill -1e30, denominator floor 1e-16) and
    ``propagate`` (gather -> scale -> reduce).

The sums and the gathers' transposes take ``order``, the ids' sort
(``graph.incidence.SegOrder``: ``Incidence.edge_order()`` or
``node_order()``), where the caller has one: the entries then go through
K1 in that order (after a B10 gather into it when the ids are not sorted
already), deterministic and without atomics; a sum's backward is then a
gather of the cotangent by id (B9 or B10, as ``gather_route`` picks).
Without an order the ids are taken as unsorted and the sum, or a
gather's transpose, is a torch scatter-add in f32 (``index_put_`` with
``accumulate``, which on the card sorts the ids and so adds in the same
order every run), as the JAX package leaves them to XLA outside any
Pallas kernel. Results have the data's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from allset_tpu_torch.graph.incidence import SegOrder
from allset_tpu_torch.ops import cuda_segment
from allset_tpu_torch.ops.cuda_gather import gather, gather_fwd, gather_routed

Tensor = torch.Tensor

_NEG_BIG = -1e30  # softmax mask fill; avoids -inf NaN propagation
_DEN_FLOOR = 1e-16


def _flat(t: Tensor) -> Tensor:
    return t.reshape(t.shape[0], -1)


def _num_valid(order: SegOrder) -> int:
    return int(order.indptr[-1]) if order.indptr.numel() else 0


def _sorted_rows(flat: Tensor, order: SegOrder, n: int) -> Tensor:
    """The first n entries in the order's sort (a B10 gather by perm)."""
    return flat if order.perm is None else gather_fwd(flat, order.perm[:n])


class _OrderedSum(torch.autograd.Function):
    """K1 over the entries in the order's sort; backward: the cotangent
    gathered by id for the valid entries, zero for the others."""

    @staticmethod
    def forward(ctx, data, ids, num_segments, order: SegOrder):
        ctx.save_for_backward(ids)
        ctx.dtype, ctx.order = data.dtype, order
        rows = _sorted_rows(_flat(data), order, _num_valid(order))
        out = cuda_segment.segment_sum(rows, order.indptr, num_segments, order.plan)
        return out.reshape((num_segments,) + tuple(data.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        dx = gather_routed(g.contiguous(), ids, ctx.order.perm is None)
        valid = (ids >= 0) & (ids < g.shape[0])
        dx = torch.where(valid.reshape((-1,) + (1,) * (dx.dim() - 1)), dx, torch.zeros_like(dx))
        return dx.to(ctx.dtype), None, None, None


class _OrderedGather(torch.autograd.Function):
    """Gather by ids (B9 where the order says they are sorted and the row is
    narrow, else B10); backward: the cotangent's valid entries in the
    order's sort, summed by K1 into the table's rows (one per segment)."""

    @staticmethod
    def forward(ctx, x, ids, order: SegOrder):
        if x.shape[0] != order.indptr.shape[0] - 1:
            raise ValueError(f"gather_rows: a table of {x.shape[0]} rows and an order over "
                             f"{order.indptr.shape[0] - 1} segments")
        ctx.order, ctx.dtype = order, x.dtype
        return gather_routed(x, ids, order.perm is None)

    @staticmethod
    def backward(ctx, g):
        order = ctx.order
        rows = _sorted_rows(_flat(g.contiguous()), order, _num_valid(order))
        dx = cuda_segment.segment_sum(rows, order.indptr, order.indptr.shape[0] - 1,
                                      order.plan)
        return dx.reshape((dx.shape[0],) + tuple(g.shape[1:])).to(ctx.dtype), None, None


def gather_rows(x: Tensor, idx: Tensor, order: Optional[SegOrder] = None) -> Tensor:
    """Row gather ``x[idx]`` with out-of-range ids clamped: padded entries
    read the last row and callers zero their contribution (their
    cotangent is dropped with ``order``, added to the last row without).
    ``order``: the ids' sort, whose K1 sum is the backward."""
    if order is None:
        return gather(x, idx)
    if x.dim() == 1:
        return _OrderedGather.apply(x[:, None], idx, order)[:, 0]
    return _OrderedGather.apply(x, idx, order)


def _drop(ids: Tensor, num_segments: int) -> Tensor:
    """Out-of-range ids -> the extra row ``num_segments``, sliced away."""
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, torch.full_like(ids, num_segments))


def segment_sum(data: Tensor, segment_ids: Tensor, num_segments: int,
                order: Optional[SegOrder] = None) -> Tensor:
    """Sum of ``data`` rows grouped by ``segment_ids`` -> [num_segments,
    ...] in data's dtype (f32 accumulation); out-of-range ids drop. With
    ``order`` (the ids' sort) K1 computes it."""
    if order is not None:
        return _OrderedSum.apply(data, segment_ids, num_segments, order)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]), dtype=torch.float32,
                      device=data.device)
    out = out.index_put((_drop(segment_ids, num_segments),), data.float(), accumulate=True)
    return out[:num_segments].to(data.dtype)


def segment_count(segment_ids: Tensor, num_segments: int) -> Tensor:
    """Entries per segment (out-of-range ids dropped), as float32."""
    ones = torch.ones(segment_ids.shape, dtype=torch.float32, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data: Tensor, segment_ids: Tensor, num_segments: int,
                 order: Optional[SegOrder] = None) -> Tensor:
    """Mean per segment; an empty segment gives 0 (count clamped at 1)."""
    total = segment_sum(data, segment_ids, num_segments, order)
    if order is not None:
        count = (order.indptr[1:] - order.indptr[:-1]).float()
    else:
        count = segment_count(segment_ids, num_segments)
    count = count.clamp_min(1.0).to(total.dtype)
    return total / count.reshape((num_segments,) + (1,) * (total.dim() - 1))


def _segment_max_raw(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """Max per segment, -inf on an empty one."""
    ids = _drop(segment_ids, num_segments)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)[:num_segments]


def segment_max(data: Tensor, segment_ids: Tensor, num_segments: int,
                order: Optional[SegOrder] = None) -> Tensor:
    """Max per segment; an empty segment gives 0 (torch_scatter). A
    scatter max needs no sort: ``order`` is not read."""
    out = _segment_max_raw(data, segment_ids, num_segments)
    return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))


_REDUCERS = {"add": segment_sum, "sum": segment_sum, "mean": segment_mean,
             "max": segment_max}


def segment_reduce(data: Tensor, segment_ids: Tensor, num_segments: int,
                   reduce: str = "add", order: Optional[SegOrder] = None) -> Tensor:
    """Dispatch on reduce in {'add'/'sum', 'mean', 'max'}."""
    try:
        fn = _REDUCERS[reduce]
    except KeyError:
        raise ValueError(f"Unknown reduce {reduce!r}; expected one of {sorted(_REDUCERS)}")
    return fn(data, segment_ids, num_segments, order)


def segment_softmax(scores: Tensor, segment_ids: Tensor, num_segments: int,
                    mask: Optional[Tensor] = None, order: Optional[SegOrder] = None) -> Tensor:
    """Softmax of per-entry ``scores`` ([nnz] or [nnz, H]) grouped by
    segment, max-subtracted; entries with ``mask`` False (or an
    out-of-range id) get exactly 0. ``order``: the ids' sort, for the
    denominator's sum and the gathers' transposes."""
    def expand(m):
        return m.reshape(m.shape + (1,) * (scores.dim() - m.dim()))

    if mask is not None:
        scores = torch.where(expand(mask), scores,
                             torch.full((), _NEG_BIG, dtype=scores.dtype, device=scores.device))
    seg_max = _segment_max_raw(scores, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    expd = torch.exp(scores - gather_rows(seg_max, segment_ids, order))
    if mask is not None:
        expd = torch.where(expand(mask), expd, torch.zeros_like(expd))
    denom = segment_sum(expd, segment_ids, num_segments, order)
    denom = denom.clamp_min(_DEN_FLOOR)
    return expd / gather_rows(denom, segment_ids, order)


def propagate(x: Tensor, src: Tensor, dst: Tensor, norm: Optional[Tensor],
              num_segments: int, reduce: str = "add",
              order: Optional[SegOrder] = None) -> Tensor:
    """gather -> (norm-scale) -> segment-reduce: the propagate() shape of
    the reference's message-passing layers. ``norm`` is the per-entry
    weight, 0 at padded entries; ``order`` is dst's sort."""
    msgs = gather_rows(x, src)
    if norm is not None:
        msgs = msgs * norm.reshape(norm.shape + (1,) * (msgs.dim() - 1)).to(msgs.dtype)
    return segment_reduce(msgs, dst, num_segments, reduce, order)
