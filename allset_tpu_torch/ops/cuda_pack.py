"""PMA's score+pack (K4 global max, K5 pack): the packed exchange table.

Counterpart of ``allset_tpu/ops/pallas_pack.py``; the CUDA kernels in
``csrc/pma_pack.cu`` replace its ``_gmax_kernel`` (K4) and ``_pack_kernel``
(K5). From the ``[lin_V | Wa]`` GEMM output ``yf = [x_V | scores | 0]``,
padded with zero GEMM columns to ``WP = packed_width(HC, H)``:

    alpha = leaky_relu(f32(yf[:, HC:HC+H]) + ba, 0.2)
    gmax  = max(0, colmax(alpha))   K4, over all rows; carries no gradient
    e     = exp(alpha - gmax)       rounded to the activation dtype
    w     = [(yf[:, :HC] + bV) * expand(e) | e | 0]   K5, [rows, WP]

On the TPU the kernels sat behind an opt-in gate; here every PMA forward
of a CUDA tensor launches them, in one host call (``pack_fwd``: K4, then
K5, on the current stream); ``gmax_cuda`` and ``pack_cuda`` launch one of
them through the same C entry. Both are bound by bytes on the H100: K5
reads yf once and writes w once, K4 reads only the score columns. K4 is
one launch that writes gmax itself: each block folds its maxima into a
row of a scratch table, and the last block of each run (an atomic ticket
that wraps back to zero, so the per-device tickets, kept beside the
scratch in ``_Workspace``, need no memset) folds the rows; the grid
comes from ``gmax_grid``. The
backward is the vjp of the plain composition with gmax detached, as the
JAX package's ``custom_vjp`` takes it, written out (``pack_vjp``) from
the saved yf and K4's gmax: the same ops autograd would run through
``pack_plain``, without its forward recompute. There is no backward
kernel.

With R runs folded: ``yf [rows, R, WP]``, ``bV [R, HC]``, ``ba [R, H]`` ->
``w [rows, R*WP]``, the folded table ``dir_spmm`` takes. One launch of
each kernel serves every run (a second grid axis over r), and run r's
columns equal a single-run launch on its slice bit for bit; the plain
versions run run by run on contiguous [rows, WP] slices.

``pma_pack`` launches the kernels for CUDA tensors and takes the plain
version for CPU tensors; any other device raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from allset_tpu_torch.ops import _kernels

Tensor = torch.Tensor

NEGATIVE_SLOPE = 0.2  # PMA's leaky_relu on the seed scores
MAX_HEADS = 256  # K4's shared-memory table
GMAX_THREADS = 256  # K4's block (csrc/pma_pack.cu THREADS)
GMAX_INFLIGHT = 8  # head vectors a K4 thread loads at once
GMAX_BLOCKS_PER_SM = 4  # K4's grid fills this many blocks on every SM


def _alpha(yf: Tensor, ba: Tensor, H: int, HC: int) -> Tensor:
    return F.leaky_relu(yf[:, HC : HC + H].float() + ba, NEGATIVE_SLOPE)


def gmax_plain(yf: Tensor, ba: Tensor, H: int, HC: int) -> Tensor:
    """Plain PyTorch version of K4: f32 [H] over all rows of yf [rows, WP];
    NaN propagates."""
    return _alpha(yf, ba, H, HC).detach().amax(dim=0).clamp_min(0.0)


def pack_plain(yf: Tensor, bV: Tensor, ba: Tensor, H: int,
               gmax: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch version of K4 + K5 (K5 alone, given K4's gmax),
    differentiable with gmax detached: yf [rows, WP], bV [HC], ba [H] ->
    w [rows, WP] in yf.dtype."""
    HC = bV.shape[0]
    C = HC // H
    if gmax is None:  # shift over ALL rows (N-slot hole rows included on E->V)
        gmax = gmax_plain(yf, ba, H, HC)
    x_V = yf[:, :HC] + bV.to(yf.dtype)
    e = torch.exp(_alpha(yf, ba, H, HC) - gmax).to(yf.dtype)  # <= 1
    # per-head column expansion as a broadcast: its backward is a plain
    # sum over C (repeat_interleave's may scatter with atomics)
    e_cols = e[:, :, None].expand(-1, H, C).reshape(-1, HC)
    parts = [x_V * e_cols, e]
    pad = yf.shape[1] - HC - H
    if pad:
        parts.append(yf.new_zeros(yf.shape[0], pad))
    return torch.cat(parts, dim=1)


def pack_runs_plain(yf: Tensor, bV: Tensor, ba: Tensor, H: int,
                    gmax: Optional[Tensor] = None) -> Tensor:
    """Plain version of the runs grid: pack_plain on each run's contiguous
    slice of yf [rows, R, WP] (gmax [R, H] if given) -> w [rows, R*WP]."""
    return torch.cat([pack_plain(yf[:, r].contiguous(), bV[r], ba[r], H,
                                 None if gmax is None else gmax[r])
                      for r in range(bV.shape[0])], dim=1)


def pack_vjp(gw: Tensor, yf: Tensor, bV: Tensor, ba: Tensor, gmax: Tensor, H: int,
             dyf: Tensor) -> tuple:
    """The vjp of pack_plain for one run, written out: the ops autograd
    runs through the composition, in its order and dtypes, so the result
    is the same bits. gw, yf, dyf: [rows, WP] (views allowed); bV [HC],
    ba [H], gmax [H]. Writes yf's gradient into dyf; returns (dbV, dba)."""
    HC = bV.shape[0]
    C = HC // H
    rows = yf.shape[0]
    x_V = yf[:, :HC] + bV.to(yf.dtype)
    s = yf[:, HC : HC + H].float() + ba
    ex = torch.exp(F.leaky_relu(s, NEGATIVE_SLOPE) - gmax)  # f32, before rounding
    e = ex.to(yf.dtype)
    g_vals = gw[:, :HC]
    dx = (g_vals.reshape(rows, H, C) * e[:, :, None]).reshape(rows, HC)
    de = gw[:, HC : HC + H] + (g_vals * x_V).view(rows, H, C).sum(-1)
    ds = torch.ops.aten.leaky_relu_backward(de.float() * ex, s, NEGATIVE_SLOPE, False)
    dyf[:, :HC] = dx
    dyf[:, HC : HC + H] = ds
    dyf[:, HC + H :] = 0
    return dx.sum(0).to(bV.dtype), ds.sum(0)


def _check_cuda_args(yf: Tensor, ba: Tensor, H: int, HC: int):
    """Validate a K4/K5 launch on yf [rows, WP] (one run, ba [H]) or [rows,
    R, WP] (ba [R, H]): contiguous, 16-byte aligned, on ba's CUDA device,
    H <= MAX_HEADS dividing HC, WP % 8 == 0 and WP >= HC + H. Returns
    (rows, R, WP)."""
    if not (yf.is_cuda and ba.get_device() == yf.get_device()):
        raise ValueError("the PMA pack kernels need yf and ba on one CUDA device")
    if not (yf.is_contiguous() and yf.data_ptr() % 16 == 0):
        raise ValueError("the PMA pack kernels need yf contiguous and 16-byte aligned")
    runs = yf.dim() == 3
    R = yf.shape[1] if runs else 1
    WP = yf.shape[-1]
    if not (yf.dim() in (2, 3) and ba.shape == ((R,) if runs else ()) + (H,)
            and 0 < H <= MAX_HEADS and HC % H == 0 and WP % 8 == 0 and WP >= HC + H):
        raise ValueError(
            f"unsupported pack shape: yf {tuple(yf.shape)}, ba {tuple(ba.shape)}, HC={HC}, "
            f"H={H} (need H <= {MAX_HEADS} dividing HC, WP % 8 == 0, WP >= HC + H)")
    return yf.shape[0], R, WP


def head_vec(HC: int, H: int, WP: int, item: int) -> int:
    """Heads a K4 thread loads at once: the widest vector, from 16 bytes
    down to one element, that H, HC and WP keep aligned (the kernel's
    ``launch_gmax``)."""
    vh = 16 // item
    while vh > 1 and (H % vh or HC % vh or WP % vh):
        vh //= 2
    return vh


def gmax_grid(rows: int, R: int, H: int, vh: int, sms: int) -> int:
    """K4's blocks a run: enough that each thread loads at least
    GMAX_INFLIGHT head vectors, at most what fills every SM with
    GMAX_BLOCKS_PER_SM blocks over the R runs; at least one."""
    want = -(-rows * (H // vh) // (GMAX_INFLIGHT * GMAX_THREADS))
    return max(1, min(want, sms * GMAX_BLOCKS_PER_SM // R))


class _Workspace:
    """K4's per-device tickets (zero at rest: the kernel resets them) and
    scratch, and the launch geometry by shape. The two are apart so that
    no launch's scratch reaches another's tickets."""

    def __init__(self, dev):
        self.dev = dev
        self.tickets = torch.zeros(0, dtype=torch.int32, device=dev)
        self.scratch = torch.empty(0, dtype=torch.int32, device=dev)
        self.sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.geom = {}

    def args(self, rows: int, R: int, WP: int, HC: int, H: int, item: int) -> tuple:
        """(blocks, tickets pointer, scratch pointer, head vector) of a K4
        launch."""
        key = (rows, R, WP, HC, H, item)
        g = self.geom.get(key)
        if g is None:
            vh = head_vec(HC, H, WP, item)
            blocks = gmax_grid(rows, R, H, vh, self.sms)
            # a buffer outgrown is replaced (tickets zeroed once): the old
            # pointers go
            if self.tickets.numel() < R:
                self.tickets = torch.zeros(R, dtype=torch.int32, device=self.dev)
                self.geom.clear()
            if self.scratch.numel() < R * blocks * H:
                self.scratch = torch.empty(R * blocks * H, dtype=torch.int32, device=self.dev)
                self.geom.clear()
            g = self.geom[key] = (blocks, self.tickets.data_ptr(), self.scratch.data_ptr(), vh)
        return g


_workspaces = {}  # CUDA device index -> _Workspace


def _workspace(t: Tensor) -> _Workspace:
    """The workspace of t's CUDA device."""
    ws = _workspaces.get(t.get_device())
    if ws is None:
        ws = _workspaces[t.get_device()] = _Workspace(t.device)
    return ws


K4, K5 = 1, 2  # the parts of a pack launch (allset_pma_score_pack)


def _launch(yf: Tensor, bV, ba: Tensor, gmax: Tensor, H: int, HC: int, parts: int):
    """One call of the pack's C entry: K4 into gmax (parts & K4), then K5
    from gmax (parts & K5) -> w [rows, R*WP], or None without K5. gmax:
    f32, contiguous, ba's shape, on yf's device."""
    rows, R, WP = _check_cuda_args(yf, ba, H, HC)
    blocks = tickets = scratch = vh = 0
    if parts & K4:
        blocks, tickets, scratch, vh = _workspace(yf).args(rows, R, WP, HC, H,
                                                           yf.element_size())
    w = None
    if parts & K5:
        if not (bV.shape == ba.shape[:-1] + (HC,) and bV.device == yf.device):
            raise ValueError(f"pack: bV {tuple(bV.shape)} must match ba {tuple(ba.shape)} "
                             f"and HC={HC} on yf's device")
        bV = bV.float().contiguous()
        w = torch.empty(rows, R * WP, dtype=yf.dtype, device=yf.device)
    ba = ba.float().contiguous()
    rc = _kernels.lib().allset_pma_score_pack(
        yf.data_ptr(), None if bV is None else bV.data_ptr(), ba.data_ptr(), gmax.data_ptr(),
        None if w is None else w.data_ptr(), scratch, tickets, blocks, vh, rows, R, WP, HC, H,
        _kernels.dtype_code(yf), parts, _kernels.stream_ptr(yf),
    )
    _kernels.check(rc, "pma_score_pack")
    if parts & K4:
        _kernels.launches["pma_gmax"] += 1
    if parts & K5:
        _kernels.launches["pma_pack"] += 1
    return w


def gmax_cuda(yf: Tensor, ba: Tensor, H: int, HC: int) -> Tensor:
    """Launch K4 alone -> f32 gmax [H] ([R, H] for yf [rows, R, WP])."""
    gmax = ba.new_empty(ba.shape, dtype=torch.float32)
    _launch(yf, None, ba, gmax, H, HC, K4)
    return gmax


def pack_cuda(yf: Tensor, bV: Tensor, ba: Tensor, gmax: Tensor, H: int) -> Tensor:
    """Launch K5 alone with K4's gmax -> w [rows, WP] ([rows, R*WP] for yf
    [rows, R, WP])."""
    if not (gmax.shape == ba.shape and gmax.dtype == torch.float32 and gmax.is_contiguous()
            and gmax.get_device() == yf.get_device()):
        raise ValueError(f"pack_cuda: gmax must be f32 {tuple(ba.shape)} on yf's device")
    return _launch(yf, bV, ba, gmax, H, bV.shape[-1], K5)


def score_pack_cuda(yf: Tensor, bV: Tensor, ba: Tensor, H: int) -> tuple:
    """The pack's forward on the card: K4 then K5 in one host call ->
    (w, gmax)."""
    gmax = ba.new_empty(ba.shape, dtype=torch.float32)
    return _launch(yf, bV, ba, gmax, H, bV.shape[-1], K4 | K5), gmax


def pack_fwd(yf: Tensor, bV: Tensor, ba: Tensor, H: int) -> tuple:
    """The forward alone -> (w, gmax): K4 then K5 in one host call on a
    CUDA tensor, the plain version on a CPU tensor."""
    HC = bV.shape[-1]
    if yf.is_cuda:
        return score_pack_cuda(yf, bV, ba, H)
    if yf.device.type == "cpu":
        if yf.dim() == 2:
            gmax = gmax_plain(yf, ba, H, HC)
            return pack_plain(yf, bV, ba, H, gmax), gmax
        gmax = torch.stack([gmax_plain(yf[:, r], ba[r], H, HC) for r in range(ba.shape[0])])
        return pack_runs_plain(yf, bV, ba, H, gmax), gmax
    raise ValueError(f"pma pack: unsupported device {yf.device}")


class _Pack(torch.autograd.Function):
    """K4 + K5 forward; the backward is pack_vjp, run by run, from the
    saved yf and gmax."""

    @staticmethod
    def forward(ctx, yf, bV, ba, H):
        w, gmax = pack_fwd(yf, bV, ba, H)
        ctx.save_for_backward(yf, bV, ba, gmax)
        ctx.H = H
        return w

    @staticmethod
    def backward(ctx, gw):
        yf, bV, ba, gmax = ctx.saved_tensors
        dyf = torch.empty_like(yf, memory_format=torch.contiguous_format)
        if yf.dim() == 2:
            return (dyf, *pack_vjp(gw, yf, bV, ba, gmax, ctx.H, dyf), None)
        WP = yf.shape[-1]
        per = [pack_vjp(gw[:, r * WP : (r + 1) * WP], yf[:, r], bV[r], ba[r], gmax[r],
                        ctx.H, dyf[:, r]) for r in range(bV.shape[0])]
        return dyf, *(torch.stack(g) for g in zip(*per)), None


def pma_pack(yf: Tensor, bV: Tensor, ba: Tensor, H: int) -> Tensor:
    """PMA's packed exchange table from the padded GEMM output: yf [rows,
    WP], bV [HC], ba [H] -> w [rows, WP]; with R runs yf [rows, R, WP], bV
    [R, HC], ba [R, H] -> w [rows, R*WP]. Forward K4 + K5; the backward is
    the plain composition's vjp (pack_vjp)."""
    return _Pack.apply(yf, bV, ba, H)
