"""The one-hot segment-sum experiments B1-B4 and B6 (``csrc/segsum_onehot.cu``).

Counterparts of the TPU round's prototypes of the sorted segment-sum:
``benchmarks/pallas_segsum_proto.py`` (B1), ``exp_nbuf.py`` (B2, NBUF-deep
buffers), ``exp_acc2.py`` (B3, NACC accumulators), ``exp_onehot.py`` (B4,
one-hot builds A, B, C) and ``exp_segsum_ablate.py``'s ``_kernel`` (B6,
ablation modes). They keep the JAX experiments' arguments: msgs and dst
padded past the last entry (``pad_for_kernel``), and one ``block_indptr``
entry per block of ``s_blk`` segments. For block b, start_al is
``block_indptr[b]`` rounded down to 128 and the block reads
cdiv(block_indptr[b + 1] - start_al, chunk) chunks from there. The output
is [num_segments, F] f32, num_segments a multiple of ``s_blk``.

Modes (B6): ``full`` the segment-sum over the block's chunks (an entry
counts in block dst // s_blk when it lies in that block's chunks);
``noonehot`` a constant one-hot, row r of a chunk into segment r % s_blk;
``nomatmul`` the chunk's first s_blk rows plus the indicator dst == the
block's first segment; ``dmaonly``, ``depth4`` (4 stages), ``nodst`` (no
ids copied) and ``nodst4`` the chunk's first s_blk rows (B6's ``depth4``
takes the surrogate too: its product runs only in ``full`` and
``noonehot``). A row past the end of msgs reads as zeros with no id.

``segsum_onehot`` launches the kernel for a CUDA tensor (counter
``segsum_onehot``, one for the whole family) and takes the plain version
for a CPU tensor; any other device raises. The plain version computes
each mode's function whatever nbuf, nacc and build: they change how the
kernel gets there, not what it computes.
"""

from __future__ import annotations

import torch

from allset_tpu_torch.ops import _kernels

Tensor = torch.Tensor

MODES = ("full", "noonehot", "nomatmul", "dmaonly", "depth4", "nodst", "nodst4")
BUILDS = ("A", "B", "C")
S_BLKS = (64, 128, 256)
NBUFS = (2, 3, 4, 6)
NACCS = (1, 2, 4)
# mode -> (kernel mode: 0 full, 1 noonehot, 2 nomatmul, 3 dmaonly; ids copied;
# stages, None: the caller's nbuf)
_MODE = {"full": (0, True, None), "noonehot": (1, True, None), "nomatmul": (2, True, None),
         "dmaonly": (3, True, None), "depth4": (3, True, 4), "nodst": (3, False, 2),
         "nodst4": (3, False, 4)}
ALIGN = 128  # a block's first row is its first entry rounded down to this


def block_indptr(dst_sorted, num_segments: int, s_blk: int) -> Tensor:
    """The entry offset of each block of s_blk segments in sorted ids
    (``allset_tpu/ops/pallas_segment.py::build_block_indptr``)."""
    d = torch.as_tensor(dst_sorted)
    bounds = torch.arange(0, num_segments + s_blk, s_blk, dtype=d.dtype, device=d.device)
    return torch.searchsorted(d.contiguous(), bounds).to(torch.int32)


def pad_for_kernel(n: int, chunk: int = 512) -> int:
    """The rows msgs and dst are padded to: a multiple of chunk plus one
    spare chunk (``pallas_segment.py::pad_for_kernel``)."""
    return ((n + chunk - 1) // chunk + 1) * chunk


def _check_args(msgs, dst, bip, num_segments, s_blk, chunk, nbuf, nacc, build, mode):
    if mode not in MODES or build not in BUILDS or nbuf not in NBUFS or nacc not in NACCS:
        raise ValueError(f"segsum_onehot: mode {mode!r} in {MODES}, build {build!r} in "
                         f"{BUILDS}, nbuf {nbuf} in {NBUFS}, nacc {nacc} in {NACCS}")
    if s_blk not in S_BLKS or num_segments % s_blk or chunk % 64 or not s_blk <= chunk:
        raise ValueError(f"segsum_onehot: s_blk in {S_BLKS} dividing num_segments "
                         f"{num_segments}, chunk a multiple of 64 and >= s_blk, got s_blk "
                         f"{s_blk}, chunk {chunk}")
    if msgs.dim() != 2 or dst.shape != (msgs.shape[0],):
        raise ValueError(f"msgs [rows, F] and dst [rows], got {tuple(msgs.shape)}, "
                         f"{tuple(dst.shape)}")
    if bip.shape != (num_segments // s_blk + 1,):
        raise ValueError("block_indptr must have num_segments / s_blk + 1 entries")


def windows(bip: Tensor, chunk: int):
    """(start_al, nchunks) of each block, int64."""
    b = bip.long()
    start_al = b[:-1] // ALIGN * ALIGN
    nchunks = torch.clamp(b[1:] - start_al, min=0)
    return start_al, (nchunks + chunk - 1) // chunk


def _rows_of_blocks(counts: Tensor):
    """(block, offset) of every row of blocks that read counts[b] rows."""
    blk = torch.repeat_interleave(torch.arange(counts.shape[0], device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    return blk, torch.arange(blk.shape[0], device=counts.device) - first[blk]


def segsum_onehot_plain(msgs: Tensor, dst: Tensor, block_indptr: Tensor, num_segments: int,
                        s_blk: int, chunk: int, nbuf: int = 2, nacc: int = 1, build: str = "A",
                        mode: str = "full") -> Tensor:
    """Plain version: the mode's function in f32 (see the module)."""
    _check_args(msgs, dst, block_indptr, num_segments, s_blk, chunk, nbuf, nacc, build, mode)
    dev, F = msgs.device, msgs.shape[1]
    start_al, nchunks = windows(block_indptr.to(dev), chunk)
    need = int((start_al + nchunks * chunk).max()) if nchunks.numel() else 0
    x = msgs.float()
    ids = dst.long()
    if need > x.shape[0]:  # rows past the end: zeros with no id
        x = torch.cat([x, x.new_zeros(need - x.shape[0], F)])
        ids = torch.cat([ids, ids.new_full((need - ids.shape[0],), -1)])
    out = torch.zeros(num_segments, F, dtype=torch.float32, device=dev)
    kind = _MODE[mode][0]
    if kind == 0:
        e = torch.arange(x.shape[0], device=dev)
        blk = torch.div(ids, s_blk, rounding_mode="floor").clamp(0, start_al.shape[0] - 1)
        lo = start_al[blk]
        keep = ((ids >= 0) & (ids < num_segments) & (e >= lo) & (e < lo + nchunks[blk] * chunk))
        return out.index_add_(0, ids[keep], x[keep])
    if kind == 1:  # every row of the block's chunks, row r of a chunk into r % s_blk
        blk, off = _rows_of_blocks(nchunks * chunk)
        seg = blk * s_blk + (off % chunk) % s_blk
        return out.index_add_(0, seg, x[start_al[blk] + off])
    # the first s_blk rows of each chunk
    blk, off = _rows_of_blocks(nchunks * s_blk)
    rows = start_al[blk] + torch.div(off, s_blk, rounding_mode="floor") * chunk + off % s_blk
    val = x[rows]
    if kind == 2:
        val = val + (ids[rows] == blk * s_blk).float()[:, None]
    return out.index_add_(0, blk * s_blk + off % s_blk, val)


def segsum_onehot_cuda(msgs: Tensor, dst: Tensor, block_indptr: Tensor, num_segments: int,
                       s_blk: int, chunk: int, nbuf: int = 2, nacc: int = 1, build: str = "A",
                       mode: str = "full") -> Tensor:
    """Launch the kernel on the current stream: msgs [rows, F] f32 or bf16
    (F a multiple of 64), dst [rows] int32, block_indptr int32, all on one
    CUDA device."""
    _check_args(msgs, dst, block_indptr, num_segments, s_blk, chunk, nbuf, nacc, build, mode)
    if not (msgs.is_cuda and dst.device == msgs.device == block_indptr.device):
        raise ValueError("segsum_onehot_cuda needs msgs, dst and block_indptr on one CUDA device")
    if msgs.shape[1] % 64 or dst.dtype != torch.int32 or block_indptr.dtype != torch.int32:
        raise ValueError("segsum_onehot_cuda takes F a multiple of 64 and int32 ids and indptr")
    kind, load_ids, stages = _MODE[mode]
    msgs, dst, bip = msgs.contiguous(), dst.contiguous(), block_indptr.contiguous()
    F = msgs.shape[1]
    out = torch.empty(num_segments, F, dtype=torch.float32, device=msgs.device)
    rc = _kernels.lib().allset_segsum_onehot(
        msgs.data_ptr(), dst.data_ptr(), bip.data_ptr(), msgs.shape[0], num_segments // s_blk,
        F, s_blk, chunk, nbuf if stages is None else stages, nacc, kind, BUILDS.index(build),
        int(load_ids), out.data_ptr(), _kernels.dtype_code(msgs), _kernels.stream_ptr(msgs),
    )
    _kernels.check(rc, "segsum_onehot")
    _kernels.launches["segsum_onehot"] += 1
    return out


def segsum_onehot(msgs: Tensor, dst: Tensor, block_indptr: Tensor, num_segments: int,
                  s_blk: int, chunk: int, nbuf: int = 2, nacc: int = 1, build: str = "A",
                  mode: str = "full") -> Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    args = (msgs, dst, block_indptr, num_segments, s_blk, chunk, nbuf, nacc, build, mode)
    if msgs.is_cuda:
        return segsum_onehot_cuda(*args)
    if msgs.device.type == "cpu":
        return segsum_onehot_plain(*args)
    raise ValueError(f"segsum_onehot: unsupported device {msgs.device}")
