"""Fused PMA epilogue (K2 forward, K3 backward; K2R/K3R with runs).

Counterpart of ``allset_tpu/ops/pallas_pma.py``; the CUDA kernels in
``csrc/pma_epilogue.cu`` replace its ``_fwd_kernel`` and ``_bwd_kernel``,
both the single-run grids (K2, K3) and the runs grids R > 1 that the
vmapped statistical runs take (K2R, K3R). Per row of the packed aggregate
``agg [M, WP] = [vals HC | den H | pad]``:

    out0 = vals / expand(max(den, 1e-16)) + seed
    z    = LN0(out0)                     f32, fast variance E[x^2] - mu^2
    y    = LN1(zb + relu(rFF(zb)))       zb = z in the activation dtype
    y    = relu(y)                       when ``relu`` (SetGNN's folded
                                         inter-stage activation)

On the H100 the rFF products bound it. The kernels keep each 64-row
tile's intermediates in registers (16 warps: two row halves, each warp
an eighth of the columns), stage the tile's rows and the weights in
shared memory, and run every product on the tensor cores: bf16 operands as bf16 MMA
with f32 accumulation, the products the JAX package takes in f32 as
3xTF32 (operands split into two TF32 parts, three products; f32
accuracy, see the source note). The backward recomputes the forward per
tile and sums the parameter gradients through per-block f32 partials and
second reduce kernels, so they repeat bit for bit.

With R runs folded into the width, ``agg`` is ``[M, R*WP]`` (run r in
columns ``[r*WP, (r+1)*WP)``), ``y`` is ``[M, R*HC]``, every parameter
carries a leading ``[R]`` axis, and the backward returns ``dW [R, L, HC,
HC]`` and ``dsmall [R, 8, HC]``. The runs kernels are the single-run
kernels with a second grid axis over r: run r's outputs equal a
single-run launch on run r's slice bit for bit.

The plain versions below follow the kernel's math (``_fwd_recompute`` and
``_ln_bwd`` of the JAX module), including its rounding points; the runs
versions apply them run by run. The plain versions take any HC, head
count and rFF depth L. For CUDA tensors :func:`epilogue_route` picks the
route by shape: the kernels where :func:`epilogue_supported` holds, the
plain versions where the JAX package's gate composes the epilogue too
(an rFF of L outside (1, 2), HC not a multiple of 128), and a raise for
the rest (HC a multiple of 128 above 256 with L in (1, 2), where the JAX
package runs its fused kernel and the port has none yet). CPU tensors
take the plain versions; any other device raises.
"""

from __future__ import annotations

import torch

from allset_tpu_torch.ops import _kernels

Tensor = torch.Tensor

EPS = 1e-5  # torch/flax LayerNorm default
DEN_FLOOR = 1e-16  # softmax denominator clamp

TILE_ROWS = 64  # rows per tile of the kernels
_BWD_MAX_BLOCKS = 264  # row-kernel blocks (= small-grad partials) of K3: 2 waves of 132
_BWD_MAX_CHUNKS = 64  # row chunks (= dW partials) of K3


def _ln(x, g, b):
    """LayerNorm in f32, fast variance; returns (y, xhat, rstd)."""
    mu = x.mean(dim=1, keepdim=True)
    var = (x * x).mean(dim=1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + EPS)
    xhat = (x - mu) * rstd
    return xhat * g + b, xhat, rstd


def _ln_bwd(gy, xhat, rstd, g):
    gg = gy * g
    m1 = gg.mean(dim=1, keepdim=True)
    m2 = (gg * xhat).mean(dim=1, keepdim=True)
    dx = rstd * (gg - m1 - xhat * m2)
    return dx, (gy * xhat).sum(dim=0), gy.sum(dim=0)


def _mm(a, b):
    """The plain versions' rFF products, in f32 (the kernels: bf16 MMA or
    3xTF32, see the CUDA source; the tests emulate the split here)."""
    return a @ b


def _fwd_recompute(agg, seed, g0, b0, Wrff, brff, g1, b1, H):
    """Forward chain in f32 with the kernel's rounding points; returns
    every intermediate the backward needs."""
    cdt = agg.dtype
    HC = seed.shape[0]
    a = agg.float()
    v = a[:, :HC]
    den_raw = a[:, HC : HC + H]
    deninv = 1.0 / den_raw.clamp_min(DEN_FLOOR)
    denE = deninv.repeat_interleave(HC // H, dim=1)
    out0 = v * denE + seed
    z, xhat0, rstd0 = _ln(out0, g0, b0)
    zb = z.to(cdt)
    h = zb
    pres = []
    for l in range(Wrff.shape[0]):
        # TorchDense rounding: f32 accumulation of the rounded operands,
        # output rounded to the activation dtype, bias added, rounded again
        p32 = _mm(h.float(), Wrff[l].to(cdt).float())
        p = (p32.to(cdt).float() + brff[l]).to(cdt).float()
        pres.append(p)
        if l < Wrff.shape[0] - 1:
            h = p.clamp_min(0.0).to(cdt)
    out2 = zb.float() + pres[-1].clamp_min(0.0)
    y, xhat1, rstd1 = _ln(out2, g1, b1)
    return dict(v=v, den_raw=den_raw, deninv=deninv, denE=denE, zb=zb,
                pres=pres, xhat0=xhat0, rstd0=rstd0, xhat1=xhat1,
                rstd1=rstd1, y=y)


def epilogue_fwd_plain(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    """Plain PyTorch version of K2 -> y [M, HC] in agg.dtype."""
    y = _fwd_recompute(agg, seed, g0, b0, Wrff, brff, g1, b1, H)["y"].to(agg.dtype)
    return y.clamp_min(0) if relu else y


def epilogue_bwd_plain(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    """Plain PyTorch version of K3 -> (dagg [M, WP] in agg.dtype,
    dW [L, HC, HC] f32, dsmall [8, HC] f32 = dseed, dg0, db0, dg1, db1,
    dbrff[0..L), zero rows)."""
    cdt = agg.dtype
    M, WP = agg.shape
    HC = seed.shape[0]
    L = Wrff.shape[0]
    r = _fwd_recompute(agg, seed, g0, b0, Wrff, brff, g1, b1, H)
    gy = gy.float()
    if relu:  # mask on the ROUNDED output, as the composition does
        gy = gy * (r["y"].to(cdt).float() > 0)
    dout2, dg1, db1 = _ln_bwd(gy, r["xhat1"], r["rstd1"], g1)
    dz = dout2
    dp = dout2 * (r["pres"][-1] > 0)
    dbr, dW = [None] * L, [None] * L
    for l in range(L - 1, -1, -1):
        dbr[l] = dp.sum(dim=0)
        hin = r["zb"] if l == 0 else r["pres"][l - 1].clamp_min(0.0).to(cdt)
        dW[l] = _mm(hin.float().T, dp)
        dh = _mm(dp, Wrff[l].float().T)
        if l > 0:
            dp = dh * (r["pres"][l - 1] > 0)
        else:
            dz = dz + dh
    dout0, dg0, db0 = _ln_bwd(dz, r["xhat0"], r["rstd0"], g0)
    dseed = dout0.sum(dim=0)
    dv = dout0 * r["denE"]
    dden = -(dout0 * r["v"]).reshape(M, H, HC // H).sum(dim=2) * (
        r["deninv"] * r["deninv"]
    )
    dden = torch.where(r["den_raw"] > DEN_FLOOR, dden, torch.zeros_like(dden))
    pad = torch.zeros(M, WP - HC - H, device=agg.device)
    dagg = torch.cat([dv, dden, pad], dim=1).to(cdt)
    zeros = [torch.zeros(HC, device=agg.device)] * (3 - L)
    dsmall = torch.stack([dseed, dg0, db0, dg1, db1, *dbr, *zeros])
    return dagg, torch.stack(dW), dsmall


def epilogue_fwd_runs_plain(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    """Plain PyTorch version of K2R: K2's plain version on each run's
    slice -> y [M, R*HC]."""
    R, WP = seed.shape[0], agg.shape[1] // seed.shape[0]
    return torch.cat([
        epilogue_fwd_plain(agg[:, r * WP : (r + 1) * WP], seed[r], g0[r], b0[r],
                           Wrff[r], brff[r], g1[r], b1[r], H, relu)
        for r in range(R)
    ], dim=1)


def epilogue_bwd_runs_plain(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    """Plain PyTorch version of K3R: K3's plain version on each run's
    slice -> (dagg [M, R*WP], dW [R, L, HC, HC], dsmall [R, 8, HC])."""
    R, HC = seed.shape
    WP = agg.shape[1] // R
    outs = [
        epilogue_bwd_plain(agg[:, r * WP : (r + 1) * WP], gy[:, r * HC : (r + 1) * HC],
                           seed[r], g0[r], b0[r], Wrff[r], brff[r], g1[r], b1[r],
                           H, relu)
        for r in range(R)
    ]
    return (torch.cat([o[0] for o in outs], dim=1), torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


def epilogue_supported(HC: int, H: int, L: int, WP: int, R: int = 1) -> bool:
    """The shapes K2/K3 (R = 1) and K2R/K3R (R runs) take: HC % 64 == 0,
    HC <= 256, H dividing HC, a packed width WP >= HC + H of whole 16-byte
    rows (WP % 8 == 0), an rFF of L in (1, 2) layers and at most 65535
    runs."""
    return (HC % 64 == 0 and 0 < HC <= 256 and H >= 1 and HC % H == 0
            and WP >= HC + H and WP % 8 == 0 and L in (1, 2) and 1 <= R <= 65535)


def epilogue_route(HC: int, H: int, L: int, WP: int, R: int = 1) -> str:
    """The epilogue's route on the card: 'kernel' where
    :func:`epilogue_supported` holds; 'plain' where the JAX package's gate
    (``allset_tpu/ops/pallas_pma.py::epilogue_active``) composes the
    epilogue as well, an rFF of L outside (1, 2) or HC not a multiple of
    128; a raise for any other shape, since the JAX package runs its fused
    kernel there (HC 512: ROADMAP Queue 3)."""
    if epilogue_supported(HC, H, L, WP, R):
        return "kernel"
    if L not in (1, 2) or HC % 128 != 0:
        return "plain"
    raise ValueError(
        f"no epilogue kernel for HC={HC}, H={H}, L={L}, WP={WP}, runs={R}: K2/K3 take HC "
        "% 64 == 0, HC <= 256, H dividing HC, WP >= HC + H, WP % 8 == 0, runs <= 65535, "
        "and the JAX package runs its fused kernel at this shape (ROADMAP Queue 3)"
    )


def _check_cuda_args(agg, seed, Wrff, H, R):
    """Validate K2/K3 (R=None: unbatched parameters) or K2R/K3R (R runs,
    parameters [R, ...]); returns (M, WP, HC, L) with WP per run."""
    if not agg.is_cuda:
        raise ValueError("the PMA epilogue kernels need CUDA tensors")
    runs = 1 if R is None else R
    lead = () if R is None else (R,)
    M, W = agg.shape
    HC = seed.shape[-1]
    L = Wrff.shape[-3]
    WP = W // runs
    if not (seed.shape == lead + (HC,) and Wrff.shape == lead + (L, HC, HC)
            and W == runs * WP and epilogue_supported(HC, H, L, WP, runs)):
        raise ValueError(
            f"unsupported epilogue shape: agg {tuple(agg.shape)}, seed "
            f"{tuple(seed.shape)}, Wrff {tuple(Wrff.shape)}, H={H} (need HC % 64 "
            "== 0, HC <= 256, H dividing HC, WP >= HC + H, WP % 8 == 0 (16-byte "
            "rows), L in (1, 2), runs <= 65535)"
        )
    return M, WP, HC, L


def _f32(*ts):
    return [t.float().contiguous() for t in ts]


def _weights(Wrff, cdt):
    """The rFF weights as the kernels read them: f32 [in][out] and, on the
    bf16 path, bf16 [out][in] (None in f32)."""
    Wf = Wrff.float().contiguous()
    if cdt == torch.float32:
        return Wf, None
    return Wf, Wrff.to(cdt).transpose(-1, -2).contiguous()


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch_fwd(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu, R=None):
    """K2 (R=None) or K2R (R runs) on the current stream."""
    M, WP, HC, L = _check_cuda_args(agg, seed, Wrff, H, R)
    runs = 1 if R is None else R
    agg = agg.contiguous()
    Wf, Wbt = _weights(Wrff, agg.dtype)
    seed, g0, b0, brff, g1, b1 = _f32(seed, g0, b0, brff, g1, b1)
    out = torch.empty(M, runs * HC, dtype=agg.dtype, device=agg.device)
    rc = _kernels.lib().allset_pma_epilogue_fwd(
        agg.data_ptr(), seed.data_ptr(), g0.data_ptr(), b0.data_ptr(),
        Wf.data_ptr(), _ptr(Wbt), brff.data_ptr(), g1.data_ptr(), b1.data_ptr(),
        out.data_ptr(), M, WP, HC, H, L, runs, int(relu),
        _kernels.dtype_code(agg), _kernels.stream_ptr(agg),
    )
    _kernels.check(rc, "pma_epilogue_fwd")
    return out


def _launch_bwd(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu, R=None):
    """K3 (R=None) or K3R (R runs): the row pass, dW partials and the two
    final reduces, on the current stream."""
    M, WP, HC, L = _check_cuda_args(agg, seed, Wrff, H, R)
    runs = 1 if R is None else R
    lead = () if R is None else (R,)
    dev, cdt = agg.device, agg.dtype
    agg = agg.contiguous()
    gy = gy.to(cdt).contiguous()
    Wf, Wbt = _weights(Wrff, cdt)
    seed, g0, b0, brff, g1, b1 = _f32(seed, g0, b0, brff, g1, b1)
    grid_rows = max(1, min(-(-M // TILE_ROWS), _BWD_MAX_BLOCKS))
    chunk_rows = -(-max(M, 1) // _BWD_MAX_CHUNKS)
    chunk_rows = -(-chunk_rows // 32) * 32
    nch = max(1, -(-M // chunk_rows))
    f32 = torch.float32
    dagg = torch.empty(M, runs * WP, dtype=cdt, device=dev)
    dW = torch.empty(lead + (L, HC, HC), dtype=f32, device=dev)
    dsmall = torch.empty(lead + (8, HC), dtype=f32, device=dev)
    # scratch, per run: K3a's stored rFF inputs and output gradients, and
    # the per-block (small vectors) and per-chunk (dW) f32 partials
    hin = torch.empty(runs, L, M, HC, dtype=cdt, device=dev)
    dpbuf = torch.empty(runs, L, M, HC, dtype=f32, device=dev)
    part_small = torch.empty(runs, grid_rows, 8, HC, dtype=f32, device=dev)
    part_w = torch.empty(runs, nch, L, HC, HC, dtype=f32, device=dev)
    rc = _kernels.lib().allset_pma_epilogue_bwd(
        agg.data_ptr(), gy.data_ptr(), seed.data_ptr(), g0.data_ptr(),
        b0.data_ptr(), Wf.data_ptr(), _ptr(Wbt), brff.data_ptr(),
        g1.data_ptr(), b1.data_ptr(), dagg.data_ptr(), dW.data_ptr(),
        dsmall.data_ptr(), hin.data_ptr(), dpbuf.data_ptr(),
        part_small.data_ptr(), part_w.data_ptr(), M, WP, HC, H, L, runs,
        int(relu), _kernels.dtype_code(agg), grid_rows, nch, chunk_rows,
        _kernels.stream_ptr(agg),
    )
    _kernels.check(rc, "pma_epilogue_bwd")
    return dagg, dW, dsmall


def epilogue_fwd_cuda(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    """Launch K2."""
    out = _launch_fwd(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu)
    _kernels.launches["pma_epilogue_fwd"] += 1
    return out


def epilogue_bwd_cuda(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    """Launch K3."""
    out = _launch_bwd(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu)
    _kernels.launches["pma_epilogue_bwd"] += 1
    return out


def epilogue_fwd_runs_cuda(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    """Launch K2R: the runs grid over R = seed.shape[0] folded runs."""
    out = _launch_fwd(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu, R=seed.shape[0])
    _kernels.launches["pma_epilogue_fwd_runs"] += 1
    return out


def epilogue_bwd_runs_cuda(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    """Launch K3R: the runs grid over R = seed.shape[0] folded runs."""
    out = _launch_bwd(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu,
                      R=seed.shape[0])
    _kernels.launches["pma_epilogue_bwd_runs"] += 1
    return out


def _use_kernel(agg, seed, Wrff, H) -> bool:
    """For a CUDA tensor, epilogue_route's choice (by shape, before any
    launch: a kernel that fails still raises); the plain version for a CPU
    tensor; any other device raises."""
    if agg.is_cuda:
        R = seed.shape[0] if seed.dim() == 2 else 1
        return epilogue_route(seed.shape[-1], H, Wrff.shape[-3], agg.shape[1] // R,
                              R) == "kernel"
    if agg.device.type == "cpu":
        return False
    raise ValueError(f"pma epilogue: unsupported device {agg.device}")


def epilogue_fwd(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    fn = epilogue_fwd_cuda if _use_kernel(agg, seed, Wrff, H) else epilogue_fwd_plain
    return fn(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu)


def epilogue_bwd(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    fn = epilogue_bwd_cuda if _use_kernel(agg, seed, Wrff, H) else epilogue_bwd_plain
    return fn(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu)


def epilogue_fwd_runs(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    fn = (epilogue_fwd_runs_cuda if _use_kernel(agg, seed, Wrff, H)
          else epilogue_fwd_runs_plain)
    return fn(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu)


def epilogue_bwd_runs(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    fn = (epilogue_bwd_runs_cuda if _use_kernel(agg, seed, Wrff, H)
          else epilogue_bwd_runs_plain)
    return fn(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu)


class _Epilogue(torch.autograd.Function):
    """K2 forward, K3 backward; with ``runs`` K2R/K3R over the leading [R]
    axis of the parameters."""

    @staticmethod
    def forward(ctx, agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu, runs):
        ctx.save_for_backward(agg, seed, g0, b0, Wrff, brff, g1, b1)
        ctx.H, ctx.relu, ctx.runs = H, relu, runs
        fwd = epilogue_fwd_runs if runs else epilogue_fwd
        return fwd(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu)

    @staticmethod
    def backward(ctx, gy):
        agg, seed, g0, b0, Wrff, brff, g1, b1 = ctx.saved_tensors
        bwd = epilogue_bwd_runs if ctx.runs else epilogue_bwd
        dagg, dW, ds = bwd(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, ctx.H, ctx.relu)
        L = Wrff.shape[-3]
        ds = ds.movedim(-2, 0)  # [8, (R,) HC]
        return (dagg, ds[0], ds[1], ds[2], dW, ds[5 : 5 + L].movedim(0, -2), ds[3],
                ds[4], None, None, None)


def pma_epilogue(agg, seed, g0, b0, Wrff, brff, g1, b1, H: int, relu: bool):
    """y = LN1(z + relu(rFF(z))), z = LN0(agg_vals / denom + seed), with
    an optional folded relu; forward K2, backward K3. ``agg`` is
    dir_spmm's packed [M, WP] aggregate, ``Wrff`` the stacked [L, HC, HC]
    rFF kernels (layout [in, out]) and ``brff`` the stacked [L, HC]
    biases; the other parameters are [HC] vectors."""
    return _Epilogue.apply(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu, False)


def pma_epilogue_runs(agg, seed, g0, b0, Wrff, brff, g1, b1, H: int, relu: bool):
    """``pma_epilogue`` for R runs folded into the width: ``agg`` [M, R*WP]
    -> [M, R*HC]; the parameters carry a leading [R] axis (``Wrff`` [R, L,
    HC, HC], ``brff`` [R, L, HC], the others [R, HC]). Forward K2R,
    backward K3R."""
    return _Epilogue.apply(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu, True)
