"""The model's LayerNorm: forward (B12) and backward (B13) kernels.

The CUDA kernels in ``csrc/layer_norm.cu`` replace the fused LayerNorm
experiment of ``benchmarks/exp_ln.py`` (``_fwd_kernel``, B12, and
``_bwd_kernel``, B13) and put it on the path of the system: every 'ln'
``NormLayer`` of the port runs through :func:`layer_norm`. They compute
flax's ``nn.LayerNorm`` as the JAX model uses it (f32 statistics, the
fast variance ``max(E[x^2] - mu^2, 0)``, eps 1e-5, the output in the
layer's dtype), with the backward in B13's one-pass form

    dx = rstd * (g*gamma - mean(g*gamma) - xhat * mean(g*gamma * xhat))

and dgamma, dbeta summed from per-block f32 partials in a fixed order (no
atomics: the bits repeat). The backward reads each row of x and g from
memory once: up to F = 1024 a warp holds its row in registers and adds its
columns' g * xhat and g over its rows, the warps of a block add theirs in
shared memory, and the block writes one partial pair; ``bwd_plan`` gives
the blocks' row ranges, from rows and F alone.

Runs: ``x [rows, R, F]`` (or a ``[rows, F]`` shared by every run) with
``gamma``, ``beta [R, F]`` is one launch; run r's outputs equal a launch on
run r alone, bit for bit. Any F is taken.

``layer_norm`` launches the kernels for CUDA tensors and takes the plain
versions for CPU tensors; any other device raises. The plain versions
apply the same math run by run on contiguous ``[rows, F]`` tensors, so a
run's bits on the CPU do not depend on how many runs are folded.
"""

from __future__ import annotations

import torch

from allset_tpu_torch.ops import _kernels

Tensor = torch.Tensor

LN_EPS = 1e-5  # torch/flax LayerNorm default
# B13's plan (csrc/layer_norm.cu's rows_per_block): up to REG_F columns the
# register path's blocks of 8 warps, about REG_BLOCKS of them (8 per SM of
# the H100's 132) and at least a row per warp; wider rows one warp a block,
# about WIDE_BLOCKS
REG_F = 1024
REG_BLOCKS, REG_MIN_ROWS = 1056, 8
WIDE_BLOCKS, WIDE_MIN_ROWS = 4224, 16
BWD_WARPS = 8  # warps of a register-path block


def bwd_plan(rows: int, F: int):
    """(rows per block, blocks) of B13's launch: each block owns a
    contiguous range of rows and writes one dgamma/dbeta partial pair. By
    rows and F alone, so a run folded with others is cut as a launch on it
    alone."""
    reg = F <= REG_F
    blocks, least = (REG_BLOCKS, REG_MIN_ROWS) if reg else (WIDE_BLOCKS, WIDE_MIN_ROWS)
    rpb = max(-(-rows // blocks), least)
    return rpb, -(-rows // rpb)


def _runs(x: Tensor, R: int) -> list:
    """Run r's input as a contiguous [rows, F] tensor: a slice of x [rows,
    R, F], or a shared x [rows, F] itself."""
    if x.dim() == 2:
        return [x] * R
    return [t.contiguous() for t in x.unbind(1)]


def _stats(xf: Tensor):
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return mu, torch.rsqrt(var + LN_EPS)


def _fwd_one(x, gamma, beta, out_dtype):
    xf = x.float()
    mu, rstd = _stats(xf)
    return ((xf - mu) * (rstd * gamma) + beta).to(out_dtype)


def _bwd_one(g, x, gamma):
    xf = x.float()
    mu, rstd = _stats(xf)
    xhat = (xf - mu) * rstd
    gf = g.float()
    gg = gf * gamma
    m1 = gg.mean(dim=-1, keepdim=True)
    m2 = (gg * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (gg - m1 - xhat * m2)).to(x.dtype)
    return dx, (gf * xhat).sum(dim=0), gf.sum(dim=0)


def ln_fwd_plain(x: Tensor, gamma: Tensor, beta: Tensor, out_dtype: torch.dtype) -> Tensor:
    """Plain PyTorch version of B12: x [rows, F], gamma, beta [F] -> y
    [rows, F]; with runs gamma, beta [R, F] and x [rows, R, F] or [rows, F]
    -> y [rows, R, F]. y has ``out_dtype``."""
    if gamma.dim() == 1:
        return _fwd_one(x, gamma, beta, out_dtype)
    R = gamma.shape[0]
    return torch.stack([_fwd_one(xr, gamma[r], beta[r], out_dtype)
                        for r, xr in enumerate(_runs(x, R))], dim=1)


def ln_bwd_plain(g: Tensor, x: Tensor, gamma: Tensor):
    """Plain PyTorch version of B13 -> (dx in y's layout and x's dtype,
    dgamma, dbeta f32 shaped as gamma)."""
    if gamma.dim() == 1:
        return _bwd_one(g, x, gamma)
    outs = [_bwd_one(gr, xr, gamma[r])
            for r, (gr, xr) in enumerate(zip(_runs(g, gamma.shape[0]), _runs(x, gamma.shape[0])))]
    return tuple(torch.stack(t, dim=d) for t, d in zip(zip(*outs), (1, 0, 0)))


def _layout(x: Tensor, gamma: Tensor):
    """(rows, R, F, row stride, run stride) of x in elements."""
    F = x.shape[-1]
    if gamma.dim() == 1:
        if x.dim() != 2 or gamma.shape != (F,):
            raise ValueError(f"layer_norm: x {tuple(x.shape)}, gamma {tuple(gamma.shape)}")
        return x.shape[0], 1, F, F, 0
    R = gamma.shape[0]
    if gamma.shape != (R, F) or not (x.dim() == 2 or x.shape[1] == R):
        raise ValueError(f"layer_norm: x {tuple(x.shape)}, gamma {tuple(gamma.shape)}")
    if x.dim() == 2:  # shared by every run
        return x.shape[0], R, F, F, 0
    return x.shape[0], R, F, R * F, F


def _check_cuda(*ts):
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError("the LayerNorm kernels need CUDA tensors on one device")


def ln_fwd_cuda(x: Tensor, gamma: Tensor, beta: Tensor, out_dtype: torch.dtype) -> Tensor:
    """Launch B12 on the current stream."""
    _check_cuda(x, gamma, beta)
    x = x.contiguous()
    rows, R, F, xs_row, xs_run = _layout(x, gamma)
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
    shape = (rows, F) if gamma.dim() == 1 else (rows, R, F)
    y = torch.empty(shape, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    rc = _kernels.lib().allset_layer_norm_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), rows, R, F,
        xs_row, xs_run, _kernels.dtype_code(x), _kernels.dtype_code(y),
        _kernels.stream_ptr(x),
    )
    _kernels.check(rc, "layer_norm_fwd")
    _kernels.launches["layer_norm_fwd"] += 1
    return y


def ln_bwd_cuda(g: Tensor, x: Tensor, gamma: Tensor, need_dx: bool = True):
    """Launch B13 (the rows with their partials, then the partials' sum)
    on the current stream -> (dx in y's layout and x's dtype, or None without
    ``need_dx``; dgamma, dbeta f32 shaped as gamma)."""
    _check_cuda(g, x, gamma)
    x, g = x.contiguous(), g.contiguous()
    rows, R, F, xs_row, xs_run = _layout(x, gamma)
    shape = (rows, F) if gamma.dim() == 1 else (rows, R, F)
    if g.shape != shape:
        raise ValueError(f"layer_norm backward: g {tuple(g.shape)}, expected {shape}")
    gamma = gamma.float().contiguous()
    dev, f32 = x.device, torch.float32
    dx = torch.empty(shape, dtype=x.dtype, device=dev) if need_dx else None
    if rows == 0 or F == 0:
        z = torch.zeros(gamma.shape, dtype=f32, device=dev)
        return dx, z, z.clone()
    _, nblk = bwd_plan(rows, F)
    part = torch.empty(2, R, nblk, F, dtype=f32, device=dev)
    dgb = torch.empty((2,) + tuple(gamma.shape), dtype=f32, device=dev)
    rc = _kernels.lib().allset_layer_norm_bwd(
        g.data_ptr(), x.data_ptr(), gamma.data_ptr(), 0 if dx is None else dx.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), dgb[0].data_ptr(), dgb[1].data_ptr(),
        rows, R, F, xs_row, xs_run, nblk, _kernels.dtype_code(x), _kernels.dtype_code(g),
        _kernels.stream_ptr(x),
    )
    _kernels.check(rc, "layer_norm_bwd")
    _kernels.launches["layer_norm_bwd"] += 1
    return dx, dgb[0], dgb[1]


def ln_fwd(x: Tensor, gamma: Tensor, beta: Tensor, out_dtype: torch.dtype) -> Tensor:
    if x.is_cuda:
        return ln_fwd_cuda(x, gamma, beta, out_dtype)
    if x.device.type == "cpu":
        return ln_fwd_plain(x, gamma, beta, out_dtype)
    raise ValueError(f"layer_norm: unsupported device {x.device}")


def ln_bwd(g: Tensor, x: Tensor, gamma: Tensor, need_dx: bool = True):
    if x.is_cuda:
        return ln_bwd_cuda(g, x, gamma, need_dx)
    if x.device.type == "cpu":
        dx, dg, db = ln_bwd_plain(g, x, gamma)
        return (dx if need_dx else None), dg, db
    raise ValueError(f"layer_norm: unsupported device {x.device}")


class LayerNormFn(torch.autograd.Function):
    """B12 forward, B13 backward -> (dx, dgamma, dbeta)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, out_dtype):
        ctx.save_for_backward(x, gamma)
        return ln_fwd(x, gamma, beta, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        dx, dg, db = ln_bwd(g, x, gamma, need_dx=ctx.needs_input_grad[0])
        if dx is not None and dx.dim() > x.dim():  # x shared by the runs
            dx = dx.sum(dim=1)
        return dx, dg, db, None


def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor, out_dtype=None) -> Tensor:
    """LayerNorm over the last axis with f32 statistics -> ``out_dtype``
    (default x's). x [rows, F] with gamma, beta [F]; with R runs gamma, beta
    [R, F] and x [rows, R, F] or [rows, F] shared -> [rows, R, F]. Forward
    B12, backward B13."""
    return LayerNormFn.apply(x, gamma, beta, x.dtype if out_dtype is None else out_dtype)
