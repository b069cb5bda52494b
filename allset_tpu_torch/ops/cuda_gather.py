"""Row gathers ``out[i] = table[clamp(ids[i], 0, rows - 1)]``: B10 for any
ids, B9 for sorted ids and narrow rows.

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

B9 (``csrc/gather_sorted.cu``, counterpart of
``benchmarks/exp_fused_gather.py::vmem_gather``, the gather from a table
held on chip) serves the same function for ids that come in runs of equal
values: each warp takes a span of consecutive ids, reads each run's row
once into the registers of the lanes that write it and hands it to the
run's other ids by warp shuffles; B10 reads a row again for every id. It
is exact for any ids and takes any row. ``gather_route`` picks the kernel
by what the caller knows and the row's bytes: B9 for sorted ids and a row
of at most ``NARROW_BYTES``, B10 otherwise; each kernel counts its own
launches.
``gather_sorted_fwd`` launches B9 for a CUDA tensor and takes the plain
version (the same ``index_select`` after the clamp) for a CPU one.
"""

from __future__ import annotations

import math

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
    _check_cuda_args(table, ids, "gather_fwd_cuda")
    table, ids = table.contiguous(), ids.contiguous()
    out = torch.empty((ids.shape[0],) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    rc = _kernels.lib().allset_gather(
        table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64), out.data_ptr(),
        ids.shape[0], table.shape[0], row_bytes(table), _kernels.stream_ptr(table),
    )
    _kernels.check(rc, "gather")
    _kernels.launches["gather"] += 1
    return out


def _check_cuda_args(table: Tensor, ids: Tensor, name: str):
    if not (table.is_cuda and ids.is_cuda and table.get_device() == ids.get_device()):
        raise ValueError(f"{name} needs table and ids on one CUDA device")
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be 1-D int32 or int64, got {ids.dtype} {tuple(ids.shape)}")
    if table.dim() < 1 or table.shape[0] == 0:
        raise ValueError(f"gather from a table of shape {tuple(table.shape)}")


def row_bytes(table: Tensor) -> int:
    """Bytes of one row of ``table`` [rows, ...]."""
    return math.prod(table.shape[1:]) * table.element_size()


# the widest row that takes B9 when the ids are sorted: on an H100 (the
# bench graph's V2V destination ids, scripts/gather_sorted_sweep.py) B9 was
# within B10's spread for rows of 4 to 128 B and 6-11% slower from 256 B
NARROW_BYTES = 128


def gather_sorted_fwd_cuda(table: Tensor, ids: Tensor) -> Tensor:
    """Launch B9 on the current stream: table [rows, ...] (contiguous rows,
    fewer than 2^31 of them and of fewer than 2^31 bytes), ids [n] int32 or
    int64 on the same device, in any order (sorted ids share their rows)."""
    _check_cuda_args(table, ids, "gather_sorted_fwd_cuda")
    nbytes = row_bytes(table)
    if nbytes >= 2**31 or table.shape[0] >= 2**31:
        raise ValueError(f"B9 takes fewer than 2^31 rows of fewer than 2^31 bytes, got "
                         f"{tuple(table.shape)} {table.dtype}")
    table, ids = table.contiguous(), ids.contiguous()
    out = torch.empty((ids.shape[0],) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    rc = _kernels.lib().allset_gather_sorted(
        table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64), out.data_ptr(),
        ids.shape[0], table.shape[0], nbytes, _kernels.stream_ptr(table),
    )
    _kernels.check(rc, "gather_sorted")
    _kernels.launches["gather_sorted"] += 1
    return out


# B9's plain version: the same function as B10's
gather_sorted_fwd_plain = gather_fwd_plain


def gather_sorted_fwd(table: Tensor, ids: Tensor) -> Tensor:
    """B9 for a CUDA table, the plain version for a CPU one."""
    if table.is_cuda:
        return gather_sorted_fwd_cuda(table, ids)
    if table.device.type == "cpu":
        return gather_sorted_fwd_plain(table, ids)
    raise ValueError(f"gather_sorted: unsupported device {table.device}")


def gather_route(nbytes: int, ids_sorted: bool) -> str:
    """'sorted' (B9) for sorted ids and a row of at most NARROW_BYTES,
    'rows' (B10) otherwise: a choice by shape, made before any launch."""
    return "sorted" if ids_sorted and nbytes <= NARROW_BYTES else "rows"


def gather_routed(table: Tensor, ids: Tensor, ids_sorted: bool) -> Tensor:
    """The forward gather through gather_route's kernel."""
    if gather_route(row_bytes(table), ids_sorted) == "sorted":
        return gather_sorted_fwd(table, ids)
    return gather_fwd(table, ids)


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
