"""The streaming probes B5, B7 and B8 (``csrc/stream.cu``).

Counterparts of the TPU round's read-rate probes:
``benchmarks/exp_segsum_ablate.py``'s ``_flat_kernel`` (B5: 8 chunks a
TPU grid block), its ``_dual_kernel`` (B7: two arrays, 4 chunks a block)
and ``benchmarks/exp_autopipe.py``'s ``_kernel`` (B8: TMA bulk copies on
an mbarrier ring here, the card's automatic pipeline). Each returns
``seed`` plus a [16, F] f32 sum:

    stream_flat(x, seed, chunk):  the first 16 rows of each chunk of x,
                                  over the whole blocks of 8 chunks;
    stream_dual(a, b, seed, chunk): the same over a and b, blocks of 4;
    stream_fold(x, seed, chunk, "fold"): every row r of the whole chunks
                                  into acc[r % 16]; "first16": each
                                  chunk's first 16 rows.

B5 and B7 read only what their sums use, each chunk's first 16 rows, as
vectors into registers. The TPU probes streamed every row of their
chunks because they compared DMA mechanisms; on the card the streaming
rate is B8's to measure (its fold reads every row, and it streams whole
chunks for "first16" too). The TPU kernels of B5 and B7 read a static
slot 0 whose contents depend on when each DMA lands; these read each
chunk's own rows (the two agree on input whose chunks are all alike).
B5 and B7 are one launch: a thread block owns a few 16-byte vectors of
the [16, F] span over every chunk, its threads sum runs of consecutive
chunks and add the runs in order. B8's thread blocks each take a run of
consecutive chunks (``chunk_runs``, at most ``FOLD_BLOCKS`` runs) and
write a partial; a second pass adds the partials to the seed in block
order.

The ``stream_*`` functions launch the kernel for a CUDA tensor (counters
``stream_flat``, ``stream_dual``, ``stream_fold``) and take the plain
version for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import torch

from allset_tpu_torch.ops import _kernels

Tensor = torch.Tensor

FLAT_CHUNKS, DUAL_CHUNKS = 8, 4  # chunks in a TPU grid block
FOLD_BLOCKS = 264  # B8's thread blocks at most (two waves of an H100's 132 SMs)
BODIES = ("fold", "first16")


def chunk_runs(nchunks: int, blocks: int = FOLD_BLOCKS) -> tuple:
    """B8's (chunks a thread block, thread blocks): runs of consecutive
    chunks, run g holding chunks [g * cpb, min((g + 1) * cpb, nchunks)), at
    most ``blocks`` of them."""
    cpb = max(1, -(-nchunks // blocks))
    return cpb, -(-nchunks // cpb)


def _first16(x: Tensor, nchunks: int, chunk: int) -> Tensor:
    return x[: nchunks * chunk].view(nchunks, chunk, -1)[:, :16].float().sum(0)


def stream_flat_plain(x: Tensor, seed: Tensor, chunk: int) -> Tensor:
    n = x.shape[0] // (chunk * FLAT_CHUNKS) * FLAT_CHUNKS
    return seed + _first16(x, n, chunk)


def stream_dual_plain(a: Tensor, b: Tensor, seed: Tensor, chunk: int) -> Tensor:
    n = a.shape[0] // (chunk * DUAL_CHUNKS) * DUAL_CHUNKS
    return seed + (_first16(a, n, chunk) + _first16(b, n, chunk))


def stream_fold_plain(x: Tensor, seed: Tensor, chunk: int, body: str = "fold") -> Tensor:
    _check_body(body)
    n = x.shape[0] // chunk
    if body == "first16":
        return seed + _first16(x, n, chunk)
    return seed + x[: n * chunk].view(-1, 16, x.shape[1]).float().sum(0)


def _check_body(body):
    if body not in BODIES:
        raise ValueError(f"stream_fold: body {body!r} not in {BODIES}")


def _launch(kind: int, name: str, a: Tensor, b, seed: Tensor, chunk: int, nchunks: int) -> Tensor:
    arrays = (a,) if b is None else (a, b)
    F, dt, di = a.shape[1], a.dtype, a.get_device()
    if di < 0 or seed.get_device() != di or any(t.get_device() != di for t in arrays):
        raise ValueError(f"{name} needs its arrays and seed on one CUDA device")
    arrays = [t if t.is_contiguous() else t.contiguous() for t in arrays]
    seed = seed if seed.is_contiguous() else seed.contiguous()
    if (any(t.dim() != 2 or t.shape[1] != F or t.dtype != dt or t.data_ptr() % 16
            for t in arrays) or (F * a.element_size()) % 16 or chunk % 16
            or seed.shape != (16, F) or seed.dtype != torch.float32):
        raise ValueError(f"{name}: [rows, F] arrays of one dtype, 16-byte aligned, with F * "
                         f"itemsize a multiple of 16, chunk a multiple of 16, seed [16, F] f32")
    out = torch.empty(16, F, dtype=torch.float32, device=a.device)
    part, cpb = None, 1  # B5, B7: one launch, no partials
    if kind >= 2:
        cpb, grid = chunk_runs(nchunks)
        part = torch.empty(max(grid, 1), 16, F, dtype=torch.float32, device=a.device)
    rc = _kernels.lib().allset_stream(
        arrays[0].data_ptr(), None if b is None else arrays[1].data_ptr(), seed.data_ptr(), F,
        chunk, nchunks, cpb, kind, None if part is None else part.data_ptr(), out.data_ptr(),
        _kernels.dtype_code(a),
        _kernels.stream_ptr(a),
    )
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def stream_flat(x: Tensor, seed: Tensor, chunk: int) -> Tensor:
    """B5: seed + the first 16 rows of each chunk over whole blocks of 8."""
    if x.is_cuda:
        n = x.shape[0] // (chunk * FLAT_CHUNKS) * FLAT_CHUNKS
        return _launch(0, "stream_flat", x, None, seed, chunk, n)
    if x.device.type == "cpu":
        return stream_flat_plain(x, seed, chunk)
    raise ValueError(f"stream_flat: unsupported device {x.device}")


def stream_dual(a: Tensor, b: Tensor, seed: Tensor, chunk: int) -> Tensor:
    """B7: B5 over a and b at once, blocks of 4 chunks (a's rows)."""
    if a.is_cuda:
        if b.shape[0] < a.shape[0]:
            raise ValueError("stream_dual: b has fewer rows than a")
        n = a.shape[0] // (chunk * DUAL_CHUNKS) * DUAL_CHUNKS
        return _launch(1, "stream_dual", a, b, seed, chunk, n)
    if a.device.type == "cpu":
        return stream_dual_plain(a, b, seed, chunk)
    raise ValueError(f"stream_dual: unsupported device {a.device}")


def stream_fold(x: Tensor, seed: Tensor, chunk: int, body: str = "fold") -> Tensor:
    """B8: seed + every row r of the whole chunks into row r % 16 ("fold";
    chunk a multiple of 16), or each chunk's first 16 rows ("first16")."""
    _check_body(body)
    if x.is_cuda:
        n = x.shape[0] // chunk
        return _launch(2 if body == "fold" else 3, "stream_fold", x, None, seed, chunk, n)
    if x.device.type == "cpu":
        return stream_fold_plain(x, seed, chunk, body)
    raise ValueError(f"stream_fold: unsupported device {x.device}")
