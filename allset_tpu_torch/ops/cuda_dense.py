"""The runs-folded f32 dense product on the card: ``csrc/runs_dense.cu``.

    y[:, r] = x[:, r] @ W[r] (+ b[r])     x [rows, R, K] (or [rows, K] shared
                                         by the runs), W [R, K, N], b [R, N]

with its gradients, as one ``torch.autograd.Function``: the forward and dX
on ``runs_dense_mm_kernel`` (3xTF32 ``wgmma``, the activations read in
place through a TMA tensor map, the bias added in the epilogue, the
output written into [rows, R, N] in place), dW and db on
``runs_dense_dw_kernel``'s partials over row chunks and their reduce, the
weights laid out as the products' stages by ``runs_dense_slabs_kernel``.
A single run is R = 1 (x [rows, K], W [K, N]). The kernels replace no TPU
kernel: the JAX package leaves these products to XLA.

Who takes it: ``nn/modules.py``'s ``TorchDense`` and ``PMA``'s [lin_V |
Wa] product, where :func:`route` admits the product: f32 operands on a
CUDA device, x of rows [rows, R, K] or [rows, K], and the gate
:func:`admits`, which reads rows, K and N (never R). Every other product
keeps its route: the plain version (one product a run on a contiguous
slice, a bias pass, a stack) on the CPU always, and on the card below the
gate's rows and for bf16, whose rounding points are the JAX package's.
An f32 CUDA product that :func:`route` turns away counts in
``_kernels.declined["runs_dense"]``.

Numbers: each product term is within ~3 * 2^-22 of a*b (the split's error,
``pma_epilogue.cuh``), sums in f32 on the tensor cores; the bits depend
neither on R nor on the other runs (the column tiles, the row chunks of dW
and the order of every sum are fixed by rows, K and N).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.ops.cuda_pma import wg_slabs

Tensor = torch.Tensor

# The gate: the fewest rows that take the kernels (chip_smoke.py's
# time_dense at the zoo's shapes, PERF.md §6)
DENSE_MIN_ROWS = 256
NP_BUCKETS = (2, 8, 16, 17)  # 8-column chunks of a column tile: csrc's instantiations
KA = 32  # k-columns of a product stage
KR = 32  # rows of a dW stage
CHUNKS_MAX = 32  # dW's row chunks: at most this many, of at least CHUNK_MIN_ROWS rows
CHUNK_MIN_ROWS = 1024


def admits(rows: int, K: int, N: int) -> bool:
    """Whether the kernels take a product of ``rows`` rows, ``K`` inputs
    and ``N`` outputs: from DENSE_MIN_ROWS rows, K and N taken whole. For
    20 runs the kernels beat the loop of library products 5-20x at every
    row count measured, from 128 up; for a single run below a few thousand rows both run at the
    host's launch rate, either ahead by up to 0.3 ms from call to call
    (``chip_smoke.py`` phase 4g at the zoo's shapes), so the line sits
    low."""
    return rows >= DENSE_MIN_ROWS


def takes(xs, ws) -> bool:
    """Whether the kernels take x @ W by the shapes: x [rows, R, K] or
    [rows, K] against W [R, K, N] (a single run: x [rows, K], W [K, N]),
    and :func:`admits`."""
    fits = len(ws) in (2, 3) and xs[-1] == ws[-2] and (
        len(xs) == 2 or (len(xs) == 3 and len(ws) == 3 and xs[1] == ws[0]))
    return fits and admits(xs[0], ws[-2], ws[-1])


def route(x: Tensor, W: Tensor) -> bool:
    """True where :func:`runs_dense` takes ``x @ W``: f32 on a CUDA device
    and :func:`takes`. An f32 CUDA product sent elsewhere counts as
    declined."""
    if not (x.is_cuda and x.dtype == torch.float32 and W.dtype == torch.float32):
        return False
    if takes(x.shape, W.shape):
        return True
    _kernels.declined["runs_dense"] += 1
    return False


def col_tiles(N: int):
    """(np, ntn): the column tiles of an N-column product, ntn tiles of 8 np
    columns (np from NP_BUCKETS, at most 136 columns a tile)."""
    chunks = -(-N // 8)
    ntn = -(-chunks // NP_BUCKETS[-1])
    per = -(-chunks // ntn)
    return next(b for b in NP_BUCKETS if b >= per), ntn


def chunk_plan(rows: int):
    """(nch, chunk_rows): dW's row chunks, a multiple of KR rows each, by
    rows alone (so no sum depends on R)."""
    nch = min(CHUNKS_MAX, max(1, -(-rows // CHUNK_MIN_ROWS)))
    per = -(-rows // nch)
    chunk = -(-per // KR) * KR
    return -(-rows // chunk), chunk


def _ptr(t: Optional[Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def slabs(Bt: Tensor, np_: int, ntn: int) -> Tensor:
    """The products' weight stages of B_r [Nn, Kk] (``Bt`` [R, Nn, Kk], any
    strides: row n is the right operand's column n) on the card:
    ``runs_dense_slabs_kernel``, [R, ntn, Kp / 16, 2, 16 TN] f32 with Kp
    = Kk rounded up to KA, TF32 hi | lo per slab of 16 k-rows."""
    R, Nn, Kk = Bt.shape
    TN, Kp = 8 * np_, -(-Kk // KA) * KA
    out = torch.empty(R, ntn, Kp // 16, 2, 16 * TN, dtype=torch.float32, device=Bt.device)
    _kernels.check(_kernels.lib().allset_runs_dense_slabs(
        Bt.data_ptr(), *Bt.stride(), R, Nn, Kk, TN, ntn, Kp, out.data_ptr(),
        _kernels.stream_ptr(Bt)), "runs_dense slabs")
    _kernels.launches["runs_dense_slabs"] += 1
    return out


def slabs_plain(Bt: Tensor, np_: int, ntn: int) -> Tensor:
    """:func:`slabs`' plain version: zero padding, then the warpgroup
    kernels' K-major slabs (``cuda_pma.wg_slabs``' layout) of each column
    tile."""
    R, Nn, Kk = Bt.shape
    TN, Kp = 8 * np_, -(-Kk // KA) * KA
    B = F.pad(Bt.float(), (0, Kp - Kk, 0, ntn * TN - Nn)).reshape(R, ntn, TN, Kp)
    return wg_slabs(B, 16, True).reshape(R, ntn, Kp // 16, 2, 16 * TN)


def _operand(t: Tensor) -> Tensor:
    """x [rows, R, F] or [rows, F] as the kernels read it: contiguous
    [rows, R or 1, Fa] f32 with Fa = F rounded up to 4 (zero columns: the
    tensor map's rows are whole 16-byte vectors) and a 16-byte aligned
    base. An input broadcast over the runs is read once, as R = 1."""
    if t.dim() == 3 and t.shape[1] > 1 and t.stride(1) == 0:
        t = t[:, 0]
    t = t[:, None] if t.dim() == 2 else t
    if t.shape[-1] % 4:
        t = F.pad(t, (0, 4 - t.shape[-1] % 4))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _mm(a: Tensor, Bt: Tensor, bias: Optional[Tensor], R: int) -> Tensor:
    """[rows, R, Nn] = a[:, r or 0] @ B_r (+ bias[r]): a from :func:`_operand`,
    B_r [Nn, Kk] given as ``Bt`` [R, Nn, Kk] (Kk <= a's width)."""
    rows, Ra, Ka = a.shape
    Nn = Bt.shape[1]
    np_, ntn = col_tiles(Nn)
    B = slabs(Bt, np_, ntn)
    out = torch.empty(rows, R, Nn, dtype=torch.float32, device=a.device)
    _kernels.check(_kernels.lib().allset_runs_dense_mm(
        a.data_ptr(), rows, Ra, Ka, B.data_ptr(), _ptr(bias), out.data_ptr(), R * Nn, R, Nn,
        B.shape[2] // 2, ntn, np_, _kernels.stream_ptr(a)), "runs_dense mm")
    _kernels.launches["runs_dense_mm"] += 1
    return out


def _dw(xa: Tensor, ga: Tensor, K: int, N: int, want_db: bool):
    """(dW [R, K, N], db [R, N] or None): xa [rows, R or 1, Kx] and ga [rows,
    R, Ny] from :func:`_operand`."""
    rows, Rx, Kx = xa.shape
    R, Ny = ga.shape[1], ga.shape[2]
    np_, ntn = col_tiles(N)
    nch, chunk = chunk_plan(rows)
    dev, f32 = xa.device, torch.float32
    part = torch.empty(R, nch, K, N, dtype=f32, device=dev)
    part_b = torch.empty(R, nch, N, dtype=f32, device=dev) if want_db else None
    dW = torch.empty(R, K, N, dtype=f32, device=dev)
    db = torch.empty(R, N, dtype=f32, device=dev) if want_db else None
    _kernels.check(_kernels.lib().allset_runs_dense_dw(
        xa.data_ptr(), Rx, Kx, ga.data_ptr(), Ny, rows, R, K, N, np_, ntn, nch, chunk,
        part.data_ptr(), _ptr(part_b), dW.data_ptr(), _ptr(db), _kernels.stream_ptr(xa)),
        "runs_dense dw")
    _kernels.launches["runs_dense_dw"] += 1
    _kernels.launches["runs_dense_reduce"] += 1
    return dW, db


class _RunsDense(torch.autograd.Function):
    """x @ W (+ b) for every run (:func:`runs_dense`)."""

    @staticmethod
    def forward(ctx, x, W, b):
        single = W.dim() == 2
        W3 = W[None] if single else W
        b2 = None if b is None else (b[None] if single else b)
        R, K, N = W3.shape
        xa = _operand(x)
        y = _mm(xa, W3.transpose(1, 2), None if b2 is None else b2.contiguous(), R)
        ctx.save_for_backward(xa, W)
        ctx.x_shape = x.shape
        return y.view(x.shape[0], N) if single else y

    @staticmethod
    def backward(ctx, gy):
        xa, W = ctx.saved_tensors
        single = W.dim() == 2
        W3 = W[None] if single else W
        R, K, N = W3.shape
        rows = xa.shape[0]
        ga = _operand(gy.reshape(rows, R, N))
        dx = dW = db = None
        if ctx.needs_input_grad[0]:
            dxr = _mm(ga, W3, None, R)  # dY_r @ W_r^T: B_r = W_r [K, N]
            dx = dxr.view(ctx.x_shape) if single or len(ctx.x_shape) == 3 else dxr.sum(1)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dW, db = _dw(xa, ga, K, N, ctx.needs_input_grad[2])
            if single:
                dW, db = dW[0], None if db is None else db[0]
        return dx, dW, db


def runs_dense(x: Tensor, W: Tensor, b: Optional[Tensor] = None) -> Tensor:
    """x @ W (+ b) run by run on the card: x [rows, R, K] or [rows, K]
    shared by the runs, W [R, K, N], b [R, N] -> [rows, R, N]; a single run
    x [rows, K], W [K, N], b [N] -> [rows, N]. f32 CUDA tensors only
    (:func:`route` decides where it runs)."""
    if not (x.is_cuda and x.dtype == W.dtype == torch.float32):
        raise ValueError("runs_dense takes f32 CUDA tensors")
    return _RunsDense.apply(x, W, b)
