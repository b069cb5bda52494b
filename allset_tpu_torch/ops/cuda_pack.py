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
of a CUDA tensor launches them. Both are bound by bytes on the H100: K5
reads yf once and writes w once, K4 reads only the score columns. The
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
    """Validate a K4/K5 launch; yf is [rows, WP] (one run, ba [H]) or [rows,
    R, WP] (ba [R, H]). Returns (rows, R, WP)."""
    if not (yf.is_cuda and ba.device == yf.device):
        raise ValueError("the PMA pack kernels need yf and ba on one CUDA device")
    runs = yf.dim() == 3
    R = yf.shape[1] if runs else 1
    WP = yf.shape[-1]
    if not (yf.dim() in (2, 3) and yf.is_contiguous() and yf.data_ptr() % 16 == 0
            and ba.shape == ((R,) if runs else ()) + (H,)
            and 0 < H <= MAX_HEADS and HC % H == 0 and WP % 8 == 0 and WP >= HC + H):
        raise ValueError(
            f"unsupported pack shape: yf {tuple(yf.shape)} (contiguous, 16-byte "
            f"aligned), ba {tuple(ba.shape)}, HC={HC}, H={H} (need H <= {MAX_HEADS} "
            "dividing HC, WP % 8 == 0, WP >= HC + H)")
    return yf.shape[0], R, WP


def gmax_cuda(yf: Tensor, ba: Tensor, H: int, HC: int) -> Tensor:
    """Launch K4 -> f32 gmax [H] ([R, H] for yf [rows, R, WP])."""
    rows, R, WP = _check_cuda_args(yf, ba, H, HC)
    gmax = torch.zeros(ba.shape, dtype=torch.float32, device=yf.device)
    ba = ba.float().contiguous()
    rc = _kernels.lib().allset_pma_gmax(
        yf.data_ptr(), ba.data_ptr(), gmax.data_ptr(), rows, R, WP, HC, H,
        _kernels.dtype_code(yf), _kernels.stream_ptr(yf),
    )
    _kernels.check(rc, "pma_gmax")
    _kernels.launches["pma_gmax"] += 1
    return gmax


def pack_cuda(yf: Tensor, bV: Tensor, ba: Tensor, gmax: Tensor, H: int) -> Tensor:
    """Launch K5 with K4's gmax -> w [rows, WP] ([rows, R*WP] for yf [rows,
    R, WP])."""
    HC = bV.shape[-1]
    rows, R, WP = _check_cuda_args(yf, ba, H, HC)
    if not (bV.shape == ba.shape[:-1] + (HC,) and gmax.shape == ba.shape
            and gmax.dtype == torch.float32
            and bV.device == gmax.device == yf.device):
        raise ValueError(f"pack_cuda: bV {tuple(bV.shape)} and f32 gmax "
                         f"{tuple(gmax.shape)} must match ba {tuple(ba.shape)}")
    bV, ba, gmax = (t.float().contiguous() for t in (bV, ba, gmax))
    w = torch.empty(rows, R * WP, dtype=yf.dtype, device=yf.device)
    rc = _kernels.lib().allset_pma_pack(
        yf.data_ptr(), bV.data_ptr(), ba.data_ptr(), gmax.data_ptr(), w.data_ptr(),
        rows, R, WP, HC, H, _kernels.dtype_code(yf), _kernels.stream_ptr(yf),
    )
    _kernels.check(rc, "pma_pack")
    _kernels.launches["pma_pack"] += 1
    return w


def pack_fwd(yf: Tensor, bV: Tensor, ba: Tensor, H: int) -> tuple:
    """The forward alone -> (w, gmax): K4 then K5 on a CUDA tensor, the
    plain version on a CPU tensor."""
    HC = bV.shape[-1]
    if yf.is_cuda:
        gmax = gmax_cuda(yf, ba, H, HC)
        return pack_cuda(yf, bV, ba, gmax, H), gmax
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
