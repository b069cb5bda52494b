"""Fused PMA epilogue (K2 forward, K3 backward; K2R/K3R with runs).

Counterpart of ``allset_tpu/ops/pallas_pma.py``; the CUDA kernels in
``csrc/pma_epilogue_fwd.cu`` (K2 at HC 64 to 192, and 256 in bf16),
``csrc/pma_epilogue_wg.cu`` (K3 at HC 256, WG_WIDTHS, and K2 in f32 at
HC 256, WG_FWD_WIDTHS), ``csrc/pma_epilogue_cluster.cu`` (K2 at HC 384
and 512, CLUSTER_FWD_WIDTHS), ``csrc/pma_epilogue_cluster_bwd.cu`` (K3
at HC 384 and 512, CLUSTER_BWD_WIDTHS) and ``csrc/pma_epilogue.cu`` (K3
at HC 64 to 192; the code and design note these share in
``csrc/pma_epilogue.cuh``, the Hopper primitives and K3b in
``csrc/pma_wgmma.cuh``, the cluster layout in ``csrc/pma_cluster.cuh``)
replace its ``_fwd_kernel`` and ``_bwd_kernel``,
both the single-run grids (K2, K3) and the runs grids R > 1 that the
vmapped statistical runs take (K2R, K3R). Per row of the packed aggregate
``agg [M, WP] = [vals HC | den H | pad]``:

    out0 = vals / expand(max(den, 1e-16)) + seed
    z    = LN0(out0)                     f32, fast variance E[x^2] - mu^2
    y    = LN1(zb + relu(rFF(zb)))       zb = z in the activation dtype
    y    = relu(y)                       when ``relu`` (SetGNN's folded
                                         inter-stage activation)

On the H100 the rFF products bound it. Every product runs on the tensor
cores: bf16 operands as bf16 products with f32 accumulation, the products
the JAX package takes in f32 as 3xTF32 (operands split into two TF32
parts, three products; f32 accuracy, see the source notes). The backward
(K3) recomputes the forward per tile and sums the parameter gradients
through per-block f32 partials and second reduce kernels, so they repeat
bit for bit. At HC 256 (WG_WIDTHS) K3 runs on Hopper's warpgroup
products: 64-row tiles over four warpgroups of 64 columns, the weights
streamed by bulk copies into a ring of shared memory as slabs laid out
here (:func:`wg_weights`), the rFF inputs and output gradients written
transposed for the dW pass (:func:`wg_chunk_plan`). K2 in f32 at HC 256
(WG_FWD_WIDTHS, :func:`fwd_kernel`) runs K3a's forward on the same
layout, a persistent block over the (run, tile) items reading the forward
slabs (:func:`wg_fwd_weights`). K2 at HC 384 and 512 (CLUSTER_FWD_WIDTHS)
takes a 64-row tile on a cluster of two blocks, each block half the
output columns on the same warpgroup products, the A operand's halves
and the row statistics exchanged through distributed shared memory, each
block streaming only its column half of the weight slabs
(:func:`cluster_fwd_weights`; f32 as plain f32, split in shared memory).
K3 at HC 384 and 512 (CLUSTER_BWD_WIDTHS, :func:`bwd_kernel`) runs K3a on
the same cluster layout, the forward recompute and the backward's
exchanges (the LN1 and LN0 backward's row sums, the dp_l halves) through
distributed shared memory, each block streaming its column half of the
forward and backward slabs (:func:`cluster_bwd_weights`), and K3b over
the transposed scratch as at HC 256. K2 in bf16 up to 256, and K2 and K3
at HC 64 to 192, keep each row tile's intermediates in registers (16
warps: two row halves, each warp an eighth of the columns; 64-row tiles,
:func:`tile_rows`) with ``mma.sync`` products; that K2 is a persistent
kernel that fetches the next tile's rows while it multiplies the current
one.
Above 512, at any HC that is a multiple of 128 up to WIDE_MAX
(``csrc/pma_epilogue_wide_wg.cu``, HC at run time), the row phases and
the products run as separate kernels over [R, M, HC] tables: LN0, then
per layer a persistent warpgroup product of 128 x 128 tiles fed by bulk
copies (its A tables zb, h1, dp_l tiled by 128 rows and 128 bytes of
columns, swizzled; the weights as :func:`wide_fwd_weights`,
:func:`wide_bwd_weights` lay them out) with the
bias, rounding and relu (backward: the mask of the layer below, dbrff's
column sums, dz += dh) in its epilogue, LN1 or its backward, dW over a
few row chunks (:func:`wide_dw_plan`), LN0's backward, K3c's reduce;
every partial in a fixed order per 128-row tile (:func:`wide_tiles`).

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
route by shape: the kernels where :func:`epilogue_supported` holds (HC
in {64, 128, 192, 256, 384, 512}, or any multiple of 128 above 512), the
plain versions where the JAX package's gate composes the epilogue too (an
rFF of L outside (1, 2), HC not a multiple of 128), and a raise for the
rest (heads not dividing HC, a packed width the kernels' rows refuse).
CPU tensors take the plain versions; any other device raises.
"""

from __future__ import annotations

import torch

from allset_tpu_torch.ops import _kernels

Tensor = torch.Tensor

EPS = 1e-5  # torch/flax LayerNorm default
DEN_FLOOR = 1e-16  # softmax denominator clamp

KERNEL_WIDTHS = (64, 128, 192, 256, 384, 512)  # the HC the tiled kernels take
WIDE_TR = 128  # rows per tile of the wide route: its products, row phases, partials
WIDE_MAX = 2048  # the widest HC the wide route takes (its row phases' column chunks)
# dW blocks a layer the wide route's chunk plan aims at: about three waves
# of two an SM on an H100's 132 (12 chunks at HC 1024, 3 at 2048), which
# keeps K3R's scratch at --MLP_hidden 1024 under that of the FMA pair before it
WIDE_DW_BLOCKS = 768
# K2's tables on the wide route at most (wide_fwd_rows): at --MLP_hidden
# 1024 whole-M tables raised the CLI's peak per run above the FMA pair's
WIDE_FWD_BYTES = 256 << 20
ROW_LN0, ROW_LN1, ROW_LN1_BWD, ROW_LN0_BWD = range(4)  # the wide route's row phases
EP_H, EP_V, EP_DP, EP_DZ = range(4)  # the wide route's product epilogues
_BWD_MAX_BLOCKS = 264  # row-kernel blocks (= small-grad partials) of K3: 2 waves of 132
DW_PARTIALS = 64  # row chunks of K3, each a dW partial (part_w below)
# K3/K3R on the warpgroup kernels (csrc/pma_epilogue_wg.cu) at these widths:
# in alternating pairs on the card (scripts/k3_parts.py) they beat the
# 16-warp K3 at HC 256 and lost to it at 64, 128 and 192
WG_WIDTHS = (256,)
# K2/K2R on the warpgroup kernel (beside K3a, csrc/pma_epilogue_wg.cu) at
# these widths in f32: in alternating pairs on the card (PERF.md,
# scripts/pair_timing.py) it beats the tiled K2 there (the 20-run epoch's
# K2R) and loses to it in bf16 (the bench step), which keeps the tiled K2
WG_FWD_WIDTHS = (256,)
# K2/K2R on the cluster kernel (csrc/pma_epilogue_cluster.cu) at these
# widths, in both dtypes: in alternating pairs on the card against the
# tiled K2 (PERF.md, scripts/pair_timing.py, 2 pairs) it won at both, every
# reading lower: per bench step in bf16 1.95 against 2.08 ms (HC 384) and
# 2.18 against 3.95 (512); per 20-run epoch in f32 154.2 against 170.3
# and 216.2 against 287.8
CLUSTER_FWD_WIDTHS = (384, 512)
# K3/K3R on the cluster kernel (csrc/pma_epilogue_cluster_bwd.cu) at these
# widths, in both dtypes: in alternating pairs on the card against the
# tiled K3 (PERF.md, scripts/k3_parts.py, 2 pairs) it won at both, every
# reading lower: per bench step in bf16 12.18 against 13.92 ms (HC 384)
# and 15.35 against 26.14 (512); per 20-run epoch in f32 226.4 against
# 283.9 and 325.9 against 507.8
CLUSTER_BWD_WIDTHS = (384, 512)
CLUSTER_BWD_ENTRIES = 66  # clusters of the cluster K3a, each a set of small-vector partials
CB_KSB = 32  # k rows per bf16 forward slab of the cluster K3a (the bytes of an f32 one)
WG_BLOCKS = 132  # K3a's persistent blocks per run: one per SM of an H100
WG_TILE = 64  # rows per K3a tile
WG_KSF, WG_KSB = 16, 64  # k rows per weight slab: f32 (TF32 hi and lo), bf16


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
    dagg, hins, dps, dsmall = bwd_rows_plain(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H,
                                             relu)
    dW = [_mm(h.float().T, dp) for h, dp in zip(hins, dps)]
    return dagg, torch.stack(dW), dsmall


def bwd_rows_plain(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    """Plain PyTorch version of K3's row pass (K3a) -> (dagg, the rFF
    inputs h_l and output gradients dp_l, one [M, HC] each per layer,
    dsmall); dW_l = h_l^T dp_l is K3b's and K3c's."""
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
    dbr, hins, dps = [None] * L, [None] * L, [None] * L
    for l in range(L - 1, -1, -1):
        dbr[l] = dp.sum(dim=0)
        hins[l] = r["zb"] if l == 0 else r["pres"][l - 1].clamp_min(0.0).to(cdt)
        dps[l] = dp
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
    return dagg, hins, dps, dsmall


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


def tile_rows(HC: int) -> int:
    """Rows per tile of K2 and K3 at width HC: 64 up to HC 512 (at 384
    and 512 on the cluster kernels), the wide route's WIDE_TR above."""
    return WIDE_TR if wide(HC) else 64


def wide(HC: int) -> bool:
    """HC is served by the wide route (csrc/pma_epilogue_wide_wg.cu)."""
    return HC > KERNEL_WIDTHS[-1]


def wide_tiles(M: int) -> int:
    """The wide route's 128-row tiles at M rows, each a set of small-vector
    partials."""
    return max(1, -(-M // WIDE_TR))


def wide_fwd_rows(M: int, HC: int, L: int, runs: int, itemsize: int) -> int:
    """Rows a pass of K2's wide route: its tables (zb and h1 in the dtype,
    p in f32) within WIDE_FWD_BYTES, a multiple of the 128-row tile, at
    most M rounded up to it. Every row is computed alike in any pass."""
    per_row = runs * HC * (itemsize * L + 4)
    rows = max(WIDE_TR, WIDE_FWD_BYTES // per_row // WIDE_TR * WIDE_TR)
    return min(rows, wide_tiles(M) * WIDE_TR)


def wide_dw_plan(M: int, HC: int, L: int):
    """(chunk_rows, nch): the wide route's dW row chunks, each a dW
    partial: about WIDE_DW_BLOCKS blocks of 128 x 128 dW tiles a layer, at
    most DW_PARTIALS chunks, chunk_rows a multiple of 32, the last chunk
    short. Fixed by M and HC alone (not by the runs), so a folded run sums
    as a single-run launch does."""
    want = min(DW_PARTIALS, max(1, -(-WIDE_DW_BLOCKS // (HC // 128) ** 2)))
    chunk_rows = -(-(-(-max(M, 1) // want)) // 32) * 32
    return chunk_rows, max(1, -(-M // chunk_rows))


def epilogue_supported(HC: int, H: int, L: int, WP: int, R: int = 1) -> bool:
    """The shapes K2/K3 (R = 1) and K2R/K3R (R runs) take: HC in
    KERNEL_WIDTHS or any multiple of 128 above them up to WIDE_MAX (the
    wide route), H dividing HC, a packed width WP >= HC + H of whole
    16-byte rows (WP % 8 == 0), an rFF of L in (1, 2) layers and at most
    65535 runs."""
    width_ok = HC in KERNEL_WIDTHS or (wide(HC) and HC % 128 == 0 and HC <= WIDE_MAX)
    return (width_ok and H >= 1 and HC % H == 0
            and WP >= HC + H and WP % 8 == 0 and L in (1, 2) and 1 <= R <= 65535)


def epilogue_route(HC: int, H: int, L: int, WP: int, R: int = 1) -> str:
    """The epilogue's route on the card: 'kernel' where
    :func:`epilogue_supported` holds; 'plain' where the JAX package's gate
    (``allset_tpu/ops/pallas_pma.py::epilogue_active``) composes the
    epilogue as well, an rFF of L outside (1, 2) or HC not a multiple of
    128; a raise for any other shape, which the kernels' layout refuses."""
    if epilogue_supported(HC, H, L, WP, R):
        return "kernel"
    if L not in (1, 2) or HC % 128 != 0:
        return "plain"
    raise ValueError(
        f"no epilogue kernel for HC={HC}, H={H}, L={L}, WP={WP}, runs={R}: the kernels need "
        f"H dividing HC, WP >= HC + H, WP % 8 == 0, HC <= {WIDE_MAX} and runs <= 65535"
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
            and W == runs * WP
            and epilogue_supported(HC, H, L, WP, runs)):
        raise ValueError(
            f"unsupported epilogue shape: agg {tuple(agg.shape)}, seed "
            f"{tuple(seed.shape)}, Wrff {tuple(Wrff.shape)}, H={H} (need HC in "
            f"{KERNEL_WIDTHS} or a multiple of 128 above, up to {WIDE_MAX}, "
            "H dividing HC, WP >= HC + H, WP % 8 == 0 (16-byte rows), L in (1, 2), "
            "runs <= 65535)"
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


def tf32_round(x: Tensor) -> Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: 10 explicit
    mantissa bits, ties away from zero, the low 13 bits of the f32 zero
    (finite inputs)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: Tensor):
    """(hi, lo): x = hi + lo up to |x - hi - lo| <= 2^-22 |x|, both TF32
    (the 3xTF32 products' split; the kernels split A the same way with
    cvt.rna)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def wg_slabs(B: Tensor, ks: int, split: bool) -> Tensor:
    """A K-major operand B [..., N, K] (row n holds B's column n) as the
    warpgroup kernels' slabs: [..., K / ks, parts, ks / V, N / 8, 8, V]
    with V = 16 bytes of elements, the 8 x 16-byte core matrices that
    wgmma reads without swizzle, one slab of ks k-rows after another; with
    ``split`` the f32 values' TF32 hi and lo parts (two parts), else B
    itself."""
    *lead, N, K = B.shape
    V = 16 // B.element_size()
    parts = tf32_split(B) if split else (B,)
    nd = len(lead)
    perm = (*range(nd), nd + 2, nd + 3, nd, nd + 1, nd + 4)
    blocks = [p.reshape(*lead, N // 8, 8, K // ks, ks // V, V).permute(perm) for p in parts]
    return torch.stack(blocks, dim=nd + 1).contiguous()


def wg_fwd_weights(Wrff: Tensor, cdt) -> Tensor:
    """The rFF weights [..., L, HC, HC] ([in][out]) as the forward
    products' slabs of the warpgroup kernels (K2, K3a): B = W^T, bf16 on
    the bf16 path (WG_KSB k-rows a slab), else TF32 hi | lo (WG_KSF)."""
    Wt = Wrff.transpose(-1, -2)
    if cdt == torch.float32:
        return wg_slabs(Wt.float(), WG_KSF, True)
    return wg_slabs(Wt.to(cdt), WG_KSB, False)


def cluster_fwd_weights(Wrff: Tensor, cdt) -> Tensor:
    """The rFF weights [..., L, HC, HC] ([in][out]) as the cluster K2's
    slabs: B = W^T cut into its two column halves (block c of a cluster
    reads half c), [..., 2, L, HC / ks, 1, ks / V, HC / 16, 8, V], each
    half's slabs laid out as :func:`wg_slabs` lays them out; bf16 on the
    bf16 path (WG_KSB k-rows a slab), else plain f32 (WG_KSF), which the
    kernel splits into TF32 hi and lo in shared memory."""
    halves = _halves(Wrff.transpose(-1, -2))
    if cdt == torch.float32:
        return wg_slabs(halves.float(), WG_KSF, False)
    return wg_slabs(halves.to(cdt), WG_KSB, False)


def _halves(B: Tensor) -> Tensor:
    """A K-major operand B [..., L, N, K] cut into its two N halves (block c
    of a cluster reads half c): [..., 2, L, N / 2, K]."""
    *lead, L, N, K = B.shape
    return B.reshape(*lead, L, 2, N // 2, K).movedim(-3, -4)


def cluster_bwd_weights(Wrff: Tensor, cdt):
    """The rFF weights [..., L, HC, HC] ([in][out]) as the cluster K3a's
    slabs, (wf, wb), each [..., 2, L, HC / ks, 1, ks / V, HC / 16, 8, V]
    (block c of a cluster reads half c, laid out as :func:`wg_slabs` lays
    them out): wf the forward products' B = W^T cut into its column halves
    (bf16 on the bf16 path, CB_KSB k-rows a slab, else plain f32, WG_KSF),
    wb the backward's dp @ W^T, B = W cut into its row halves, plain f32
    (WG_KSF) in both dtypes. The kernel splits f32 slabs into TF32 hi and
    lo in shared memory. Every slab takes 32 HC bytes."""
    Wt = _halves(Wrff.transpose(-1, -2))
    wb = wg_slabs(_halves(Wrff).float(), WG_KSF, False)
    if cdt == torch.float32:
        return wg_slabs(Wt.float(), WG_KSF, False), wb
    return wg_slabs(Wt.to(cdt), CB_KSB, False), wb


def wide_slabs(B: Tensor, cdt) -> Tensor:
    """A K-major operand B [..., L, HC, HC] (row n holds B's column n) as
    the wide route's product slabs: its 128-column tiles one after another,
    [..., L, HC / 128, HC / ks, parts, ks / V, 16, 8, V], each tile's slabs
    laid out as :func:`wg_slabs` lays them out; bf16 (WG_KSB k-rows a slab,
    one a stage) or TF32 hi | lo (WG_KSF, two a stage)."""
    *lead, L, N, K = B.shape
    tiles = B.reshape(*lead, L, N // 128, 128, K)
    if cdt == torch.float32:
        return wg_slabs(tiles.float(), WG_KSF, True)
    return wg_slabs(tiles.to(cdt), WG_KSB, False)


def wide_fwd_weights(Wrff: Tensor, cdt) -> Tensor:
    """The rFF weights [..., L, HC, HC] ([in][out]) as the wide forward
    products' slabs: B = W^T, bf16 on the bf16 path, else TF32 hi | lo."""
    return wide_slabs(Wrff.transpose(-1, -2), cdt)


def wide_bwd_weights(Wrff: Tensor) -> Tensor:
    """The wide backward's dp @ W^T slabs: B = W, TF32 hi | lo (the
    unrounded f32 weights in both dtypes)."""
    return wide_slabs(Wrff, torch.float32)


def wg_weights(Wrff: Tensor, cdt):
    """K3a's slabs: the forward products' (:func:`wg_fwd_weights`) and the
    backward's dp @ W^T, B = W (TF32 hi | lo, WG_KSF a slab)."""
    return wg_fwd_weights(Wrff, cdt), wg_slabs(Wrff.float(), WG_KSF, True)


def fwd_kernel(HC: int, dtype) -> str:
    """Which K2 serves width HC in ``dtype`` on the card: 'wg' (the
    warpgroup K2 beside K3a in csrc/pma_epilogue_wg.cu: f32 at
    WG_FWD_WIDTHS), 'cluster' (csrc/pma_epilogue_cluster.cu, at
    CLUSTER_FWD_WIDTHS), 'wide' (csrc/pma_epilogue_wide_wg.cu, above 512) or
    'tiled' (csrc/pma_epilogue_fwd.cu)."""
    if wide(HC):
        return "wide"
    if HC in CLUSTER_FWD_WIDTHS:
        return "cluster"
    return "wg" if HC in WG_FWD_WIDTHS and dtype == torch.float32 else "tiled"


def bwd_kernel(HC: int, dtype) -> str:
    """Which K3 serves width HC in ``dtype`` on the card: 'wg' (the
    warpgroup K3a in csrc/pma_epilogue_wg.cu, at WG_WIDTHS), 'cluster'
    (csrc/pma_epilogue_cluster_bwd.cu, at CLUSTER_BWD_WIDTHS), 'wide'
    (csrc/pma_epilogue_wide_wg.cu, above 512) or 'tiled'
    (csrc/pma_epilogue.cu). The first two share K3b over the transposed
    scratch (:func:`wg_chunk_plan`)."""
    if wide(HC):
        return "wide"
    if HC in CLUSTER_BWD_WIDTHS:
        return "cluster"
    return "wg" if HC in WG_WIDTHS else "tiled"


def cluster_bwd_entries(M: int) -> int:
    """The cluster K3a's clusters at M rows, each a set of small-vector
    partials: one per 64-row tile up to CLUSTER_BWD_ENTRIES."""
    return max(1, min(-(-M // WG_TILE), CLUSTER_BWD_ENTRIES))


def dw_chunk_plan(rows: int):
    """(chunk_rows, nch): K3b's row chunks, each a dW partial: at most
    DW_PARTIALS chunks of chunk_rows, a multiple of 32, the last one
    short."""
    chunk_rows = -(-(-(-max(rows, 1) // DW_PARTIALS)) // 32) * 32
    return chunk_rows, max(1, -(-rows // chunk_rows))


def wg_chunk_plan(M: int):
    """(Mp, chunk_rows, nch) of K3b on the warpgroup route: the transposed
    scratch holds Mp = M rounded up to 8 rows (16-byte rows of both
    dtypes; rows past M are zeros), cut by :func:`dw_chunk_plan`."""
    Mp = -(-max(M, 1) // 8) * 8
    return (Mp, *dw_chunk_plan(Mp))


def bwd_scratch_bytes(M: int, HC: int, L: int, itemsize: int) -> int:
    """Bytes of K3's scratch per run at M rows: the stored rFF inputs and
    output gradients (transposed on the warpgroup and cluster routes), the
    small vectors' and dW's partials. The wide route: zb (and h1) in the
    dtype and dp_l in f32 (dp_0 in f32 over h1's table), tiled over M
    rounded up to 128 rows, the f32 table of the last layer's p (then dz),
    the partials per 128-row tile and dW chunk (:func:`wide_dw_plan`),
    and its weight slabs."""
    route = bwd_kernel(HC, torch.float32 if itemsize == 4 else torch.bfloat16)
    if route in ("wg", "cluster"):
        Mp, _, nch = wg_chunk_plan(M)
        tables = L * HC * Mp * (itemsize + 4)
        blocks = (min(-(-M // WG_TILE), WG_BLOCKS) if route == "wg"
                  else 4 * cluster_bwd_entries(M))
    elif route == "wide":
        nch = wide_dw_plan(M, HC, L)[1]
        Mp = wide_tiles(M) * WIDE_TR
        tiled = itemsize + 4 + (itemsize + (4 if itemsize == 2 else 0) if L == 2 else 0)
        slabs = L * HC * HC * ((2 if itemsize == 2 else 8) + 8)
        return (HC * (Mp * tiled + M * 4) + 4 * (wide_tiles(M) * 8 * HC + nch * L * HC * HC)
                + slabs)
    else:
        tables = L * HC * M * (itemsize + 4)
        nch = dw_chunk_plan(M)[1]
        blocks = min(-(-M // tile_rows(HC)), _BWD_MAX_BLOCKS)
    return tables + 4 * (blocks * 8 * HC + nch * L * HC * HC)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch_fwd(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu, R=None):
    """K2 (R=None) or K2R (R runs) on the current stream."""
    M, WP, HC, L = _check_cuda_args(agg, seed, Wrff, H, R)
    runs = 1 if R is None else R
    agg = agg.contiguous()
    route = fwd_kernel(HC, agg.dtype)
    _kernels.routes[f"pma_fwd_{route}"] += 1
    if route == "wide":
        call, out = _wide_fwd_setup(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu, runs,
                                    M, WP, HC, L)
        call()
        return out
    seed, g0, b0, brff, g1, b1 = _f32(seed, g0, b0, brff, g1, b1)
    out = torch.empty(M, runs * HC, dtype=agg.dtype, device=agg.device)
    if route in ("wg", "cluster"):
        slabs, entry = ((wg_fwd_weights, "allset_pma_epilogue_fwd_wg") if route == "wg" else
                        (cluster_fwd_weights, "allset_pma_epilogue_fwd_cluster"))
        wf = slabs(Wrff, agg.dtype)
        rc = getattr(_kernels.lib(), entry)(
            agg.data_ptr(), seed.data_ptr(), g0.data_ptr(), b0.data_ptr(), wf.data_ptr(),
            brff.data_ptr(), g1.data_ptr(), b1.data_ptr(), out.data_ptr(), M, WP, HC, H, L,
            runs, int(relu), _kernels.dtype_code(agg), _kernels.stream_ptr(agg),
        )
        _kernels.check(rc, f"pma_epilogue_fwd ({route})")
        return out
    Wf, Wbt = _weights(Wrff, agg.dtype)
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
    call, outs = _bwd_setup(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu, R)
    call()
    _kernels.routes[f"pma_bwd_{bwd_kernel(Wrff.shape[-1], agg.dtype)}"] += 1
    return outs


ALL_PARTS = 7  # K3a (1), K3b (2), K3c (4)


def _bwd_setup(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu, R=None):
    """K3's (R=None) or K3R's outputs and scratch, and ``call(parts)``,
    which launches K3a (parts & 1), K3b (2) and K3c (4) on them, in that
    order; returns (call, (dagg, dW, dsmall)). ``call()`` is one whole
    launch. Other masks serve timing only (chip_smoke.py,
    scripts/k3_parts.py): a single part, after a whole launch, times that
    part alone. The wide route takes the whole launch only (its phases:
    ``call(mark=f)``)."""
    M, WP, HC, L = _check_cuda_args(agg, seed, Wrff, H, R)
    runs = 1 if R is None else R
    lead = () if R is None else (R,)
    dev, cdt = agg.device, agg.dtype
    agg = agg.contiguous()
    gy = gy.to(cdt).contiguous()
    route = bwd_kernel(HC, cdt)
    if route == "wide":
        return _wide_bwd_setup(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu, runs,
                               lead, M, WP, HC, L)
    if route in ("wg", "cluster"):
        return _wg_bwd_setup(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu, runs,
                             lead, M, WP, HC, L, route)
    Wf, Wbt = _weights(Wrff, cdt)
    seed, g0, b0, brff, g1, b1 = _f32(seed, g0, b0, brff, g1, b1)
    grid_rows = max(1, min(-(-M // tile_rows(HC)), _BWD_MAX_BLOCKS))
    chunk_rows, nch = dw_chunk_plan(M)
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

    def call(parts=ALL_PARTS):
        rc = _kernels.lib().allset_pma_epilogue_bwd(
            agg.data_ptr(), gy.data_ptr(), seed.data_ptr(), g0.data_ptr(),
            b0.data_ptr(), Wf.data_ptr(), _ptr(Wbt), brff.data_ptr(),
            g1.data_ptr(), b1.data_ptr(), dagg.data_ptr(), dW.data_ptr(),
            dsmall.data_ptr(), hin.data_ptr(), dpbuf.data_ptr(),
            part_small.data_ptr(), part_w.data_ptr(), M, WP, HC, H, L, runs,
            int(relu), _kernels.dtype_code(agg), grid_rows, nch, chunk_rows, parts,
            _kernels.stream_ptr(agg),
        )
        _kernels.check(rc, "pma_epilogue_bwd")
    return call, (dagg, dW, dsmall)


def _wg_bwd_setup(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu, runs, lead, M, WP,
                  HC, L, route):
    """K3/K3R on the warpgroup (route 'wg', WG_WIDTHS) or cluster ('cluster',
    CLUSTER_BWD_WIDTHS) K3a (_bwd_setup's contract), K3b over the
    transposed scratch (wg_chunk_plan), K3c. grid_rows: the small-vector
    partials per run, K3a's blocks (wg) or 4 per cluster (one per warp of a
    warpgroup's rows)."""
    dev, cdt, f32 = agg.device, agg.dtype, torch.float32
    if route == "wg":
        wf, wb = wg_weights(Wrff, cdt)
        grid_rows = max(1, min(-(-M // WG_TILE), WG_BLOCKS))
        entry, arg = "allset_pma_epilogue_bwd_wg", grid_rows
    else:
        wf, wb = cluster_bwd_weights(Wrff, cdt)
        arg = cluster_bwd_entries(M)
        grid_rows = 4 * arg
        entry = "allset_pma_epilogue_bwd_cluster"
    seed, g0, b0, brff, g1, b1 = _f32(seed, g0, b0, brff, g1, b1)
    Mp, chunk_rows, nch = wg_chunk_plan(M)
    dagg = torch.empty(M, runs * WP, dtype=cdt, device=dev)
    dW = torch.empty(lead + (L, HC, HC), dtype=f32, device=dev)
    dsmall = torch.empty(lead + (8, HC), dtype=f32, device=dev)
    hT = torch.empty(runs, L, HC, Mp, dtype=cdt, device=dev)
    dpT = torch.empty(runs, L, HC, Mp, dtype=f32, device=dev)
    part_small = torch.empty(runs, grid_rows, 8, HC, dtype=f32, device=dev)
    part_w = torch.empty(runs, nch, L, HC, HC, dtype=f32, device=dev)

    def call(parts=ALL_PARTS):
        rc = getattr(_kernels.lib(), entry)(
            agg.data_ptr(), gy.data_ptr(), seed.data_ptr(), g0.data_ptr(), b0.data_ptr(),
            wf.data_ptr(), wb.data_ptr(), brff.data_ptr(), g1.data_ptr(), b1.data_ptr(),
            dagg.data_ptr(), dW.data_ptr(), dsmall.data_ptr(), hT.data_ptr(), dpT.data_ptr(),
            part_small.data_ptr(), part_w.data_ptr(), M, Mp, WP, HC, H, L, runs, int(relu),
            _kernels.dtype_code(agg), arg, nch, chunk_rows, parts,
            _kernels.stream_ptr(agg),
        )
        _kernels.check(rc, f"pma_epilogue_bwd ({route})")
        for bit, name in ((1, "pma_bwd_rows"), (2, "pma_bwd_dw"), (4, "pma_bwd_reduce")):
            if parts & bit:
                _kernels.launches[name] += 1
    return call, (dagg, dW, dsmall)


def _zero_pad_rows(t, M):
    """Zeros in rows M.. of a tiled table [R, Mp, HC]'s last 128-row tile
    (its 128-byte column blocks hold a tile's rows contiguous): the dW
    kernel's bulk copies read them, and the kernels write rows below M
    only."""
    R, Mp, HC = t.shape
    if M % WIDE_TR:
        KA = 128 // t.element_size()
        t.view(R, Mp // WIDE_TR, HC // KA, WIDE_TR, KA)[:, -1, :, M % WIDE_TR:] = 0


def _wide_call(entry: str, what: str, *args) -> None:
    _kernels.check(getattr(_kernels.lib(), entry)(*args), f"{what} (wide)")


def _wide_products(zb, h1, pz, wf, brff, M, HC, L, runs, cdt, stream):
    """The wide route's forward products: layer l's A is zb (l = 0) or h1,
    its epilogue writes h1 = round(relu(p_l)) below the last layer and the
    last layer's p (f32) into pz."""
    dt = _kernels.dtype_code(zb)
    for l in range(L):
        last = l == L - 1
        _wide_call("allset_pma_wide_gemm", "pma_epilogue products", EP_V if last else EP_H,
                   (zb if l == 0 else h1).data_ptr(), wf.data_ptr(), brff.data_ptr(),
                   _ptr(None if last else h1), pz.data_ptr() if last else 0, 0, M, HC, L, l,
                   0, runs, dt, stream)


def _wide_fwd_setup(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu, runs, M, WP, HC, L):
    """K2/K2R above HC 512 (csrc/pma_epilogue_wide_wg.cu), in passes of
    wide_fwd_rows rows: LN0 into zb, the L products (wide_fwd_weights'
    slabs), LN1 into y; returns (call, y). ``call(mark=f)`` calls f(name)
    after each phase (timing only: scripts/wide_phases.py)."""
    dev, cdt = agg.device, agg.dtype
    wf = wide_fwd_weights(Wrff, cdt)
    seed, g0, b0, brff, g1, b1 = _f32(seed, g0, b0, brff, g1, b1)
    out = torch.empty(M, runs * HC, dtype=cdt, device=dev)
    step = wide_fwd_rows(M, HC, L, runs, agg.element_size())
    # one pass's tables, each pass viewing [runs, rows, HC] at its rows
    zb_buf = torch.empty(runs * step * HC, dtype=cdt, device=dev)
    h1_buf = torch.empty(runs * step * HC, dtype=cdt, device=dev) if L == 2 else None
    pz_buf = torch.empty(runs * step * HC, dtype=torch.float32, device=dev)
    stream, dt = _kernels.stream_ptr(agg), _kernels.dtype_code(agg)

    def call(mark=None):
        mark = mark or (lambda name: None)
        for m0 in range(0, M, step):
            mc = min(step, M - m0)
            mp = wide_tiles(mc) * WIDE_TR
            zb = zb_buf[: runs * mp * HC].view(runs, mp, HC)
            h1 = None if h1_buf is None else h1_buf[: runs * mp * HC].view(runs, mp, HC)
            pz = pz_buf[: runs * mc * HC].view(runs, mc, HC)

            def rows(mode):
                _wide_call("allset_pma_wide_rows", "pma_epilogue_fwd rows", mode,
                           agg[m0:].data_ptr(), 0, seed.data_ptr(), g0.data_ptr(),
                           b0.data_ptr(), g1.data_ptr(), b1.data_ptr(), zb.data_ptr(),
                           pz.data_ptr(), 0, out[m0:].data_ptr(), 0, mc, WP, HC, H, L, runs,
                           int(relu), dt, stream)

            rows(ROW_LN0)
            mark("ln0")
            _wide_products(zb, h1, pz, wf, brff, mc, HC, L, runs, cdt, stream)
            mark("products")
            rows(ROW_LN1)
            mark("ln1")
    return call, out


def _wide_bwd_setup(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu, runs, lead, M, WP,
                    HC, L):
    """K3/K3R above HC 512 (_bwd_setup's contract; csrc/pma_epilogue_wide_wg.cu):
    the forward recomputed (zb, h1, the last layer's p into pz), LN1's
    backward (dz into pz in place, dp of the last layer), per layer from
    the last: dW_l's chunk partials and dp_l @ W_l^T (wide_bwd_weights'
    slabs, f32 W) with the relu mask of the layer below (dp_0: in f32 into
    h1's table, which it replaces element for element) or dz += dh; LN0's
    backward into dagg; K3c's reduce. ``call(mark=f)`` calls f(name) after
    each phase (timing only: scripts/wide_phases.py)."""
    dev, cdt, f32 = agg.device, agg.dtype, torch.float32
    wb = wide_bwd_weights(Wrff)
    seed, g0, b0, brff, g1, b1 = _f32(seed, g0, b0, brff, g1, b1)
    NP = wide_tiles(M)
    chunk_rows, nch = wide_dw_plan(M, HC, L)
    dagg = torch.empty(M, runs * WP, dtype=cdt, device=dev)
    dW = torch.empty(lead + (L, HC, HC), dtype=f32, device=dev)
    dsmall = torch.empty(lead + (8, HC), dtype=f32, device=dev)
    Mp = NP * WIDE_TR  # the products' A tables, tiled by 128 rows
    zb = torch.empty(runs, Mp, HC, dtype=cdt, device=dev)
    h1 = torch.empty(runs, Mp, HC, dtype=cdt, device=dev) if L == 2 else None
    pz = torch.empty(runs, M, HC, dtype=f32, device=dev)
    dpl = torch.empty(runs, Mp, HC, dtype=f32, device=dev)
    if L == 1:
        dp0 = dpl
    else:
        dp0 = h1 if cdt == f32 else torch.empty(runs, Mp, HC, dtype=f32, device=dev)
    part_s = torch.empty(runs, NP, 8, HC, dtype=f32, device=dev)
    part_w = torch.empty(runs, nch, L, HC, HC, dtype=f32, device=dev)
    for t in {id(t): t for t in (zb, h1, dpl, dp0) if t is not None}.values():
        _zero_pad_rows(t, M)
    stream, dt = _kernels.stream_ptr(agg), _kernels.dtype_code(agg)

    def rows(mode):
        _wide_call("allset_pma_wide_rows", "pma_epilogue_bwd rows", mode, agg.data_ptr(),
                   gy.data_ptr(), seed.data_ptr(), g0.data_ptr(), b0.data_ptr(), g1.data_ptr(),
                   b1.data_ptr(), zb.data_ptr(), pz.data_ptr(), dpl.data_ptr(),
                   dagg.data_ptr(), part_s.data_ptr(), M, WP, HC, H, L, runs, int(relu), dt,
                   stream)

    def dw(l, h, dp):
        _wide_call("allset_pma_wide_dw", "pma_epilogue_bwd dW", h.data_ptr(), dp.data_ptr(),
                   part_w.data_ptr(), M, HC, L, l, runs, nch, chunk_rows, dt, stream)

    def dh(mode, l, dp, h, out):
        _wide_call("allset_pma_wide_gemm", "pma_epilogue_bwd products", mode, dp.data_ptr(),
                   wb.data_ptr(), 0, _ptr(h), out.data_ptr(), part_s.data_ptr(), M, HC, L, l,
                   4 + l, runs, dt, stream)

    def call(parts=ALL_PARTS, mark=None):
        if parts != ALL_PARTS:
            raise ValueError(f"the wide route launches whole, not parts {parts}")
        mark = mark or (lambda name: None)
        rows(ROW_LN0)
        mark("ln0")
        # the forward slabs live only through the forward products
        _wide_products(zb, h1, pz, wide_fwd_weights(Wrff, cdt), brff, M, HC, L, runs, cdt,
                       stream)
        mark("products")
        rows(ROW_LN1_BWD)
        mark("ln1_bwd")
        if L == 2:
            dw(1, h1, dpl)
            mark("dw")
            dh(EP_DP, 1, dpl, h1, dp0)  # dp_0 and dbrff[0]'s partials (row 5)
            mark("dh")
        dh(EP_DZ, 0, dp0, None, pz)
        mark("dh")
        dw(0, zb, dp0)
        mark("dw")
        rows(ROW_LN0_BWD)
        mark("ln0_bwd")
        _wide_call("allset_pma_wide_reduce", "pma_epilogue_bwd reduce", part_w.data_ptr(), nch,
                   dW.data_ptr(), part_s.data_ptr(), NP, dsmall.data_ptr(), HC, L, runs,
                   stream)
        mark("reduce")
    return call, (dagg, dW, dsmall)


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
    launch: a kernel that fails still raises; the plain route counts as
    declined); the plain version for a CPU tensor; any other device
    raises."""
    if agg.is_cuda:
        R = seed.shape[0] if seed.dim() == 2 else 1
        if epilogue_route(seed.shape[-1], H, Wrff.shape[-3], agg.shape[1] // R,
                          R) == "kernel":
            return True
        _kernels.declined["pma_epilogue"] += 1
        return False
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
