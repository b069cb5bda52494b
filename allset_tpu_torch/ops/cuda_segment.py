"""Sorted CSR segment-sum (K1): the SpMM reduce of every exchange.

Counterpart of ``allset_tpu/ops/pallas_segment.py``; the CUDA kernel in
``csrc/segment_sum.cu`` replaces its ``_kernel`` (the TPU one-hot MXU
reduce). It is bound by bytes on the H100: one read of every message row,
one write of every segment row. The kernel splits the entries and the
segment ends into chunks of at most 64 rows and 65 segments
(``graph.incidence.chunk_plan``, a merge path built once per ``indptr``),
sums each chunk's rows in f32 in row order, and adds the
partials of a segment cut across chunks in chunk order in a second pass:
deterministic, no atomics, and the same bits for a column whatever the
row width. See the source for details.

``segment_sum`` launches the kernel for a CUDA tensor and takes the plain
version for a CPU tensor; any other device raises. ``segment_sum_planned``
is a plain version that follows the kernel's order of additions.

``gather_segment_sum`` is K1 with the gather inside (the counterpart of
``benchmarks/exp_fused_gather.py::take_gather``, B11): the chunk kernel
reads row r as ``w[clamp(ids[r])]``, scaled by a per-entry weight rounded
to the rows' dtype, so it gives bit for bit what B10's gather, the scale
and K1 give in three launches, without writing the [k, W] gathered table
(counter ``segment_sum_gather``). Its plain version is
``segment_sum_plain`` of the scaled gathered rows;
``gather_segment_sum_planned`` follows the kernel's order of additions.
"""

from __future__ import annotations

import torch

from allset_tpu_torch.graph.incidence import SegPlan
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.ops.cuda_gather import gather_fwd_plain

Tensor = torch.Tensor


def segment_sum_plain(msgs: Tensor, indptr: Tensor, num_seg: int) -> Tensor:
    """Plain PyTorch version: f32 accumulation, result in msgs.dtype.
    Rows past ``indptr[-1]`` are never read."""
    counts = (indptr[1:] - indptr[:-1]).long()
    ids = torch.repeat_interleave(
        torch.arange(num_seg, device=msgs.device), counts
    )
    out = torch.zeros(num_seg, msgs.shape[1], dtype=torch.float32, device=msgs.device)
    out.index_add_(0, ids, msgs[: ids.shape[0]].float())
    return out.to(msgs.dtype)


def segment_sum_planned(msgs: Tensor, indptr: Tensor, num_seg: int,
                        plan: SegPlan) -> Tensor:
    """Plain version in the kernel's order of f32 additions: each chunk's
    rows in row order (step i adds every chunk's i-th row to the sum of
    its segment's piece in that chunk), then each cut segment's partials
    in chunk order. The result has msgs.dtype."""
    dev, W = msgs.device, msgs.shape[1]
    ch = plan.chunks.long().to(dev)
    ip = indptr.long().to(dev)
    r0, r1, lo, hi = ch[:, 0], ch[:, 1], ch[:, 2], ch[:, 3]
    n = int(ip[-1])
    # every (chunk, segment) piece: its chunk c, segment s, first row
    c = torch.repeat_interleave(torch.arange(ch.shape[0], device=dev), hi - lo)
    s = lo[c] + torch.arange(c.shape[0], device=dev) - (torch.cumsum(hi - lo, 0) - (hi - lo))[c]
    first = torch.maximum(ip[s], r0[c])
    rows_seg = torch.searchsorted(ip, torch.arange(n, device=dev), right=True) - 1
    row_chunk = torch.repeat_interleave(torch.arange(ch.shape[0], device=dev), r1 - r0)
    row_first = torch.maximum(ip[rows_seg], r0[row_chunk])  # its piece's first row
    acc = torch.zeros(max(n, 1), W, dtype=torch.float32, device=dev)
    for i in range(int((r1 - r0).max()) if n else 0):
        rows = r0 + i
        rows = rows[rows < r1]
        acc.index_add_(0, row_first[rows], msgs[rows].float())
    val = torch.where((torch.minimum(ip[s + 1], r1[c]) > first)[:, None],
                      acc[first.clamp_max(max(n - 1, 0))], 0.0)
    head, tail = ip[s] < r0[c], ip[s + 1] > r1[c]
    part = torch.zeros(plan.num_partials, W, dtype=torch.float32, device=dev)
    part[ch[c[head], 4]] = val[head]
    tail &= ~head
    part[ch[c[tail], 5]] = val[tail]
    out = torch.zeros(num_seg, W, dtype=torch.float32, device=dev)
    whole = ~(head | tail)
    out[s[whole]] = val[whole]
    cuts = plan.cuts.long().to(dev)
    tot = torch.zeros(cuts.shape[0], W, dtype=torch.float32, device=dev)
    for i in range(int(cuts[:, 2].max()) if cuts.shape[0] else 0):
        live = cuts[:, 2] > i
        tot[live] += part[cuts[live, 1] + i]
    out[cuts[:, 0]] = tot
    return out.to(msgs.dtype)


def segment_sum_cuda(msgs: Tensor, indptr: Tensor, num_seg: int, plan: SegPlan) -> Tensor:
    """Launch K1 on the current stream; ``plan`` is indptr's chunk plan
    (``graph.incidence.chunk_plan``) on the same device."""
    if not (msgs.is_cuda and indptr.is_cuda and msgs.device == indptr.device):
        raise ValueError("segment_sum_cuda needs msgs and indptr on one CUDA device")
    if msgs.dim() != 2 or msgs.shape[1] % 8 != 0:
        raise ValueError(f"msgs must be [rows, W] with W % 8 == 0, got {tuple(msgs.shape)}")
    if indptr.dtype != torch.int32 or indptr.shape != (num_seg + 1,):
        raise ValueError("indptr must be int32 of length num_seg + 1")
    if plan.chunks.device != msgs.device or plan.chunks.dtype != torch.int32:
        raise ValueError("segment_sum_cuda needs indptr's chunk plan, int32 on msgs' device")
    msgs = msgs.contiguous()
    W = msgs.shape[1]
    out = torch.empty(num_seg, W, dtype=msgs.dtype, device=msgs.device)
    part = torch.empty(plan.num_partials, W, dtype=torch.float32, device=msgs.device)
    rc = _kernels.lib().allset_segment_sum(
        msgs.data_ptr(), indptr.contiguous().data_ptr(), plan.chunks.data_ptr(),
        plan.chunks.shape[0], plan.cuts.data_ptr(), plan.cuts.shape[0], part.data_ptr(),
        out.data_ptr(), W, _kernels.dtype_code(msgs), _kernels.stream_ptr(msgs),
    )
    _kernels.check(rc, "segment_sum")
    _kernels.launches["segment_sum"] += 1
    return out


def segment_sum(msgs: Tensor, indptr: Tensor, num_seg: int, plan: SegPlan) -> Tensor:
    """out[m] = sum of msgs rows indptr[m] .. indptr[m+1]-1 -> [num_seg, W].
    f32 accumulation; the result has msgs.dtype. ``plan``: indptr's chunk
    plan, which the kernel follows (the plain version does not need it).
    On the card any W runs through K1: a width that is not a multiple of 8
    (the raw features of a Deep Sets layer without MLPs) is padded with
    zero columns around the launch and sliced back; a column's sum does
    not depend on the width."""
    if msgs.is_cuda:
        W = msgs.shape[1]
        if W % 8:
            pad = msgs.new_zeros(msgs.shape[0], -W % 8)
            return segment_sum_cuda(torch.cat([msgs, pad], dim=1), indptr, num_seg,
                                    plan)[:, :W]
        return segment_sum_cuda(msgs, indptr, num_seg, plan)
    if msgs.device.type == "cpu":
        return segment_sum_plain(msgs, indptr, num_seg)
    raise ValueError(f"segment_sum: unsupported device {msgs.device}")


def scale_rows(rows: Tensor, n: Tensor) -> Tensor:
    """rows [k, W] (W = R*F with runs) times the per-entry weights n [k]
    or [R, k], in rows' dtype."""
    if n.dim() == 1:
        return rows * n[:, None].to(rows.dtype)
    k, R = rows.shape[0], n.shape[0]
    return (rows.view(k, R, -1) * n.t()[:, :, None].to(rows.dtype)).view(k, -1)


def _gathered(w: Tensor, ids: Tensor, norm) -> Tensor:
    rows = gather_fwd_plain(w, ids)
    return rows if norm is None else scale_rows(rows, norm)


def gather_segment_sum_plain(w: Tensor, ids: Tensor, indptr: Tensor, num_seg: int,
                             norm=None) -> Tensor:
    """Plain version: K1's plain version over ``w[clamp(ids)]`` scaled by
    ``norm`` ([k] or [R, k], in w's dtype)."""
    return segment_sum_plain(_gathered(w, ids, norm), indptr, num_seg)


def gather_segment_sum_planned(w: Tensor, ids: Tensor, indptr: Tensor, num_seg: int,
                               plan: SegPlan, norm=None) -> Tensor:
    """Plain version in the kernel's order of f32 additions."""
    return segment_sum_planned(_gathered(w, ids, norm), indptr, num_seg, plan)


def gather_segment_sum_cuda(w: Tensor, ids: Tensor, indptr: Tensor, num_seg: int,
                            plan: SegPlan, norm=None, run_w=None) -> Tensor:
    """Launch the gather inside K1 on the current stream: w [rows, W] (W %
    8 == 0), ids [k] int32 or int64 (at least indptr[-1] of them are
    read), norm None, [k] or [R, k]: run r's columns, ``run_w`` of them
    (default W / R), take row r, and columns past the last run row R - 1;
    indptr and its chunk plan as for segment_sum_cuda, all on w's device."""
    if not (w.is_cuda and ids.is_cuda and indptr.is_cuda and w.device == ids.device == indptr.device):
        raise ValueError("gather_segment_sum_cuda needs w, ids and indptr on one CUDA device")
    if w.dim() != 2 or w.shape[1] % 8 != 0 or w.shape[0] == 0:
        raise ValueError(f"w must be [rows > 0, W] with W % 8 == 0, got {tuple(w.shape)}")
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be 1-D int32 or int64, got {ids.dtype} {tuple(ids.shape)}")
    if indptr.dtype != torch.int32 or indptr.shape != (num_seg + 1,):
        raise ValueError("indptr must be int32 of length num_seg + 1")
    if plan.chunks.device != w.device or plan.chunks.dtype != torch.int32:
        raise ValueError("gather_segment_sum_cuda needs indptr's chunk plan, int32 on w's device")
    W, k = w.shape[1], ids.shape[0]
    if norm is None:
        scale, run_w, nruns = None, W, 1
    else:
        nruns = 1 if norm.dim() == 1 else norm.shape[0]
        run_w = W // nruns if run_w is None else run_w
        if (norm.shape[-1] != k or norm.dim() > 2 or not 0 < run_w * nruns <= W
                or norm.device != w.device):
            raise ValueError(f"norm must be [k] or [R, k] on w's device with R runs of run_w "
                             f"columns within W, got {tuple(norm.shape)} for k={k}, W={W}, "
                             f"run_w={run_w}")
        scale = norm.to(w.dtype).contiguous()
    w, ids = w.contiguous(), ids.contiguous()
    out = torch.empty(num_seg, W, dtype=w.dtype, device=w.device)
    part = torch.empty(plan.num_partials, W, dtype=torch.float32, device=w.device)
    rc = _kernels.lib().allset_segment_sum_gather(
        w.data_ptr(), w.shape[0], ids.data_ptr(), int(ids.dtype == torch.int64),
        None if scale is None else scale.data_ptr(), k, run_w, nruns,
        indptr.contiguous().data_ptr(), plan.chunks.data_ptr(), plan.chunks.shape[0],
        plan.cuts.data_ptr(), plan.cuts.shape[0], part.data_ptr(), out.data_ptr(), W,
        _kernels.dtype_code(w), _kernels.stream_ptr(w),
    )
    _kernels.check(rc, "segment_sum_gather")
    _kernels.launches["segment_sum_gather"] += 1
    return out


def gather_segment_sum(w: Tensor, ids: Tensor, indptr: Tensor, num_seg: int, plan: SegPlan,
                       norm=None) -> Tensor:
    """out[m] = sum over indptr[m] <= r < indptr[m+1] of w[clamp(ids[r])]
    (times norm[..., r], rounded to w's dtype) -> [num_seg, W] in w's
    dtype, f32 accumulation. On the card any W runs through the kernel: a
    width that is not a multiple of 8 is padded with zero columns (a copy
    of the table, not of the [k, W] rows) and sliced back, as
    ``segment_sum`` pads, so each call is one launch; a column's sum does
    not depend on the width, and a padded column past the last run takes
    the last run's weight (its rows are zero)."""
    if w.is_cuda:
        W = w.shape[1]
        if W % 8:
            pad = w.new_zeros(w.shape[0], -W % 8)
            run_w = None if norm is None else W // (1 if norm.dim() == 1 else norm.shape[0])
            return gather_segment_sum_cuda(torch.cat([w, pad], dim=1), ids, indptr, num_seg,
                                           plan, norm, run_w)[:, :W]
        return gather_segment_sum_cuda(w, ids, indptr, num_seg, plan, norm)
    if w.device.type == "cpu":
        return gather_segment_sum_plain(w, ids, indptr, num_seg, norm)
    raise ValueError(f"gather_segment_sum: unsupported device {w.device}")
