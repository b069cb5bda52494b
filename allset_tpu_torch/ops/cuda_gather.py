"""Row gather (B10): ``out[i] = table[clamp(ids[i], 0, rows - 1)]``.

Counterpart of ``benchmarks/exp_fused_gather.py::dma_gather`` (the TPU
per-row DMA gather, ``_dma_gather_kernel``) and of the JAX package's
``jnp.take(table, ids, axis=0, mode="clip")``; the CUDA kernel is
``csrc/gather.cu``. It is bound by bytes on the H100: each output row is
one table row read and written, plus the ids. Any width and element size
is served: 16-byte vector copies where the row and both base addresses
allow, narrower ones down to single bytes otherwise (the narrow [nnz, H]
score rows of an attention softmax). A gather is exact: the kernel and the
plain version agree bit for bit.

``gather_fwd`` launches the kernel for a CUDA tensor and takes the plain
version for a CPU tensor; any other device raises. ``gather`` adds the
backward: a scatter-add of the cotangent by the clamped ids in f32, as
XLA's transpose of ``jnp.take`` is, returned in the table's dtype.
"""

from __future__ import annotations

import torch

from allset_tpu_torch.ops import _kernels

Tensor = torch.Tensor


def gather_fwd_plain(table: Tensor, ids: Tensor) -> Tensor:
    """Plain PyTorch version: ``index_select`` after the clamp."""
    rows = table.shape[0]
    if rows == 0:
        raise ValueError("gather from an empty table")
    return table.index_select(0, ids.clamp(0, rows - 1))


def gather_fwd_cuda(table: Tensor, ids: Tensor) -> Tensor:
    """Launch B10 on the current stream: table [rows, ...] (any trailing
    shape, contiguous rows), ids [n] int32 or int64 on the same device."""
    if not (table.is_cuda and ids.is_cuda and table.device == ids.device):
        raise ValueError("gather_fwd_cuda needs table and ids on one CUDA device")
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be 1-D int32 or int64, got {ids.dtype} {tuple(ids.shape)}")
    if table.dim() < 1 or table.shape[0] == 0:
        raise ValueError(f"gather from a table of shape {tuple(table.shape)}")
    table, ids = table.contiguous(), ids.contiguous()
    out = torch.empty((ids.shape[0],) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    row_bytes = table[0].numel() * table.element_size()
    rc = _kernels.lib().allset_gather(
        table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64), out.data_ptr(),
        ids.shape[0], table.shape[0], row_bytes, _kernels.stream_ptr(table),
    )
    _kernels.check(rc, "gather")
    _kernels.launches["gather"] += 1
    return out


def gather_fwd(table: Tensor, ids: Tensor) -> Tensor:
    """B10 for a CUDA table, the plain version for a CPU one."""
    if table.is_cuda:
        return gather_fwd_cuda(table, ids)
    if table.device.type == "cpu":
        return gather_fwd_plain(table, ids)
    raise ValueError(f"gather: unsupported device {table.device}")


def scatter_add_rows(g: Tensor, ids: Tensor, rows: int) -> Tensor:
    """The gather's transpose: ``out[ids[i]] += g[i]`` in f32 over the
    clamped ids -> [rows, ...] f32 (``index_put_`` with ``accumulate``:
    the same order of additions every run)."""
    out = torch.zeros((rows,) + tuple(g.shape[1:]), dtype=torch.float32, device=g.device)
    return out.index_put_((ids.clamp(0, rows - 1),), g.float(), accumulate=True)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return gather_fwd(table, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return scatter_add_rows(g, ids, ctx.rows).to(ctx.dtype), None


def gather(table: Tensor, ids: Tensor) -> Tensor:
    """``table[clamp(ids)]`` along rows (``jnp.take(..., mode="clip")``),
    differentiable in ``table``; a 1-D table gathers scalars."""
    if table.dim() == 1:
        return _Gather.apply(table[:, None], ids)[:, 0]
    return _Gather.apply(table, ids)
