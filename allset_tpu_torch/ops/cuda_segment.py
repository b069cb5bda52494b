"""Sorted CSR segment-sum (K1): the SpMM reduce of every exchange.

Counterpart of ``allset_tpu/ops/pallas_segment.py``; the CUDA kernel in
``csrc/segment_sum.cu`` replaces its ``_kernel`` (the TPU one-hot MXU
reduce). It is bound by bytes on the H100: one read of every message row,
one write of every segment row. The kernel gives each segment one warp,
reads rows as 16-byte vectors, sums in f32 in row order (deterministic,
no atomics) and stores in the input dtype. See the source for details.

``segment_sum`` launches the kernel for a CUDA tensor and takes the plain
version for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import torch

from allset_tpu_torch.ops import _kernels

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


def segment_sum_cuda(msgs: Tensor, indptr: Tensor, num_seg: int) -> Tensor:
    """Launch K1 on the current stream."""
    if not (msgs.is_cuda and indptr.is_cuda and msgs.device == indptr.device):
        raise ValueError("segment_sum_cuda needs msgs and indptr on one CUDA device")
    if msgs.dim() != 2 or msgs.shape[1] % 8 != 0:
        raise ValueError(f"msgs must be [rows, W] with W % 8 == 0, got {tuple(msgs.shape)}")
    if indptr.dtype != torch.int32 or indptr.shape != (num_seg + 1,):
        raise ValueError("indptr must be int32 of length num_seg + 1")
    msgs = msgs.contiguous()
    indptr = indptr.contiguous()
    out = torch.empty(num_seg, msgs.shape[1], dtype=msgs.dtype, device=msgs.device)
    rc = _kernels.lib().allset_segment_sum(
        msgs.data_ptr(), indptr.data_ptr(), out.data_ptr(), num_seg,
        msgs.shape[1], _kernels.dtype_code(msgs), _kernels.stream_ptr(msgs),
    )
    _kernels.check(rc, "segment_sum")
    _kernels.launches["segment_sum"] += 1
    return out


def segment_sum(msgs: Tensor, indptr: Tensor, num_seg: int) -> Tensor:
    """out[m] = sum of msgs rows indptr[m] .. indptr[m+1]-1 -> [num_seg, W].
    f32 accumulation; the result has msgs.dtype."""
    if msgs.is_cuda:
        return segment_sum_cuda(msgs, indptr, num_seg)
    if msgs.device.type == "cpu":
        return segment_sum_plain(msgs, indptr, num_seg)
    raise ValueError(f"segment_sum: unsupported device {msgs.device}")
