"""K3's warpgroup route (csrc/pma_epilogue_wg.cu, HC 256) and cluster
route (csrc/pma_epilogue_cluster_bwd.cu, HC 384 and 512) on their host
side: the route by width and dtype, the weights' TF32 split and their
slab layouts against the descriptor arithmetic the kernels hand wgmma
(the cluster's column and row halves), the bf16 x 3 split of dp that K3b
multiplies with a bf16 h, the chunk plan of the transposed scratch, the
scratch the trainer counts, and the epilogue with the routes' products
emulated against the JAX kernel in interpret mode."""

import numpy as np
import pytest
import torch

from allset_tpu_torch.ops import cuda_pma
from tests.test_torch_pma import _check_against_jax, split_mm, tf32
from tests.test_torch_pma_fwd import read_slab


def slab_element(slabs, n, k, ks, part=0):
    """B[n][k] read back from wg_slabs' bytes as the kernel addresses them:
    slab k // ks; in it, part ``part`` (TF32 hi 0, lo 1) of ks * N
    elements, 16-byte chunk kc = (k % ks) // V along k at LBO = 16 N bytes,
    core-matrix row group n // 8 at SBO = 128 bytes, row n % 8 at 16 bytes,
    element k % V."""
    N = slabs.shape[-3] * 8
    V = slabs.shape[-1]
    flat = slabs.reshape(slabs.shape[0], -1)  # [slab, bytes / itemsize]
    item = slabs.element_size()
    kl = k % ks
    byte = (part * ks * N * item + (kl // V) * 16 * N + (n // 8) * 128 + (n % 8) * 16
            + (kl % V) * item)
    return flat[k // ks, byte // item]


@pytest.mark.parametrize("HC", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_slabs_follow_the_descriptor_layout(HC, dtype):
    """Both layouts K3a streams: the forward products' B = W^T (bf16 on
    the bf16 path, else TF32 hi | lo) and the backward's B = W (always
    TF32 hi | lo), each element where the kernel's descriptors (LBO = 16
    HC, SBO = 128, a slab of WG_KSB bf16 or WG_KSF f32 k-rows, a slot of
    128 HC bytes) read it; hi is exact in TF32 (its low 13 bits are 0) and
    |W - hi - lo| <= 2^-22 |W|."""
    rng = np.random.default_rng(HC)
    W = torch.from_numpy(rng.normal(size=(2, HC, HC)).astype(np.float32))
    wf, wb = cuda_pma.wg_weights(W, dtype)
    for slabs, B, ks in ((wf, W.transpose(-1, -2), cuda_pma.WG_KSB if dtype == torch.bfloat16
                          else cuda_pma.WG_KSF), (wb, W, cuda_pma.WG_KSF)):
        assert slabs[0].numel() * slabs.element_size() == HC * 128 * HC // ks
        for l in range(2):
            s = slabs[l]
            split = s.dtype == torch.float32
            for n, k in ((0, 0), (7, 5), (HC - 1, HC - 1), (HC // 2 + 3, (ks + 9) % HC),
                         (13, HC - 17)):
                b = B[l, n, k]
                hi = slab_element(s, n, k, ks, 0)
                if not split:
                    assert hi == b.to(dtype)
                    continue
                lo = slab_element(s, n, k, ks, 1)
                assert hi == tf32(b.reshape(1))[0] and lo == tf32((b - hi).reshape(1))[0]
            if split:
                parts = s.reshape(HC // ks, 2, -1)
                hi, lo = parts[:, 0], parts[:, 1]
                assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
                assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    hi, lo = cuda_pma.tf32_split(W)
    assert ((W - hi - lo).abs() <= W.abs() * 2.0**-22).all()
    assert torch.equal(hi, tf32(W))


def bf16x3(x):
    """K3b's split of an f32 dp for the bf16 products: d1 = bf16(x), d2 =
    bf16(x - d1), d3 = bf16(x - d1 - d2), each difference exact in f32."""
    d1 = x.to(torch.bfloat16)
    r1 = x - d1.float()
    d2 = r1.to(torch.bfloat16)
    return d1, d2, (r1 - d2.float()).to(torch.bfloat16)


def test_bf16x3_split_of_dp_is_exact():
    """8 + 8 + 8 significant bits hold an f32's 24: the three bf16 parts
    add up to dp exactly (normal f32 values), so h^T dp on three bf16
    products of a bf16 h is exact up to the f32 accumulation."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(4096,)) * 10.0 ** rng.uniform(-20, 20, 4096))
                         .astype(np.float32))
    d1, d2, d3 = bf16x3(x)
    assert torch.equal(d1.double() + d2.double() + d3.double(), x.double())
    h = torch.from_numpy(rng.normal(size=(300, 64)).astype(np.float32)).to(torch.bfloat16)
    dp = torch.from_numpy(rng.normal(size=(300, 32)).astype(np.float32))
    parts = bf16x3(dp)
    got = sum(h.double().T @ p.double() for p in parts)
    want = h.double().T @ dp.double()
    assert (got - want).abs().max().item() <= 1e-13 * want.abs().max().item()


def wg_mm(a, b):
    """The warpgroup route's products: an A exact in bf16 against any B
    (the bf16 forward, and K3b's h^T dp with a bf16 h) as bf16 products of
    B's bf16 x 3 split (exact), everything else as 3xTF32 (split_mm)."""
    a, b = a.float(), b.float()
    if torch.equal(a, a.to(torch.bfloat16).float()):
        return sum(a.double() @ p.double() for p in bf16x3(b)).float()
    return split_mm(a, b)


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("HC", [256, 384, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_on_the_route_products_matches_jax_kernel(dtype, HC, L, monkeypatch):
    """The plain epilogue with every rFF product taken as the warpgroup
    and cluster routes take it (wg_mm) stays within the JAX kernel's
    tolerances, at HC 256, 384 and 512, 8 heads, 1 and 2 layers, a few
    hundred rows."""
    monkeypatch.setattr(cuda_pma, "_mm", wg_mm)
    _check_against_jax(dtype, L, True, 8, HC, 200 if HC == 256 else 90, HC + 8,
                       blk=64 if HC == 256 else 32)


@pytest.mark.parametrize("M", [1, 7, 8, 1000, 131_072, 158_766, 196_608])
def test_chunk_plan_of_the_transposed_scratch(M):
    """K3b's chunks cover the Mp = M rounded up to 8 rows of the transposed
    tables (16-byte rows, zeros past M) in at most DW_PARTIALS chunks of a
    multiple of 32 rows, each 16-byte aligned, none empty; K3a's row grid
    covers Mp too."""
    Mp, rows, nch = cuda_pma.wg_chunk_plan(M)
    assert Mp % 8 == 0 and M <= Mp < M + 8
    assert rows % 32 == 0 and 1 <= nch <= cuda_pma.DW_PARTIALS
    assert (nch - 1) * rows < Mp <= nch * rows
    tiles = -(-M // cuda_pma.WG_TILE)
    assert tiles * cuda_pma.WG_TILE >= Mp


@pytest.mark.parametrize("HC,itemsize,per_elem", [(256, 4, 8), (256, 2, 6), (128, 4, 8),
                                                  (384, 4, 8), (384, 2, 6),
                                                  (512, 4, 8), (512, 2, 6)])
def test_scratch_bytes_match_the_route(HC, itemsize, per_elem, monkeypatch):
    """The scratch the trainer counts per run (bwd_scratch_bytes) is what
    K3R's setup allocates beside its outputs, at the walmart preset's V->E
    rows and 3 runs: on the warpgroup (HC 256) and cluster (384, 512)
    routes h and dp transposed over Mp rows, at the other widths up to 512
    over M rows (per_elem bytes a row and column), the small vectors' and
    dW's partials (on the cluster route 4 per cluster of the
    CLUSTER_BWD_ENTRIES)."""
    M, L, H, R = 158_766, 2, 8, 3
    WP = HC + 8
    dt = torch.float32 if itemsize == 4 else torch.bfloat16
    made = []
    empty = torch.empty

    def recording_empty(*a, **k):
        made.append(empty(*a, **k))
        return made[-1]

    # the setup's checks need a CUDA tensor; its allocations do not
    monkeypatch.setattr(cuda_pma, "_check_cuda_args", lambda *a: (M, WP, HC, L))
    agg, gy = empty(M, R * WP, dtype=dt), empty(M, R * HC, dtype=dt)
    small = [torch.zeros(R, HC)] * 3
    W, brff, g1, b1 = torch.zeros(R, L, HC, HC), torch.zeros(R, L, HC), *[torch.zeros(R, HC)] * 2
    monkeypatch.setattr(torch, "empty", recording_empty)
    _, outs = cuda_pma._bwd_setup(agg, gy, *small, W, brff, g1, b1, H, True, R)
    monkeypatch.setattr(torch, "empty", empty)
    scratch = [t for t in made if not any(t is o for o in outs)]
    assert len(scratch) == 4
    assert sum(t.nbytes for t in scratch) == R * cuda_pma.bwd_scratch_bytes(M, HC, L, itemsize)
    route = cuda_pma.bwd_kernel(HC, dt)
    Mp = cuda_pma.wg_chunk_plan(M)[0] if route in ("wg", "cluster") else M
    assert scratch[0].nbytes + scratch[1].nbytes == R * L * HC * Mp * per_elem
    if route == "cluster":
        assert scratch[2].shape == (R, 4 * cuda_pma.CLUSTER_BWD_ENTRIES, 8, HC)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_backward_route_by_width_and_dtype(dtype):
    """K3 at HC 256 takes the warpgroup kernel, at 384 and 512 the cluster
    kernel (CLUSTER_BWD_WIDTHS), from 64 to 192 the tiled K3, above 512 the
    wide pair, in both dtypes; K3's tile is 64 rows up to 512 and the
    cluster's small-vector partials one set per 64-row tile up to
    CLUSTER_BWD_ENTRIES."""
    assert cuda_pma.CLUSTER_BWD_WIDTHS == (384, 512)
    for HC in (64, 128, 192, 256, 384, 512, 640, 1024):
        want = ("wide" if HC > 512 else "cluster" if HC in (384, 512)
                else "wg" if HC == 256 else "tiled")
        assert cuda_pma.bwd_kernel(HC, dtype) == want
        assert cuda_pma.tile_rows(HC) == (64 if HC <= 512 else cuda_pma.WIDE_TR)
    for M, want in ((1, 1), (64, 1), (65, 2), (4224, 66), (4225, 66), (158_766, 66)):
        assert cuda_pma.cluster_bwd_entries(M) == want


@pytest.mark.parametrize("HC", [384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_bwd_slabs_follow_the_descriptor_layout(HC, dtype):
    """cluster_bwd_weights' two slab sequences, read at the cluster K3a's
    descriptor offsets (LBO = 16 HC / 2 bytes, SBO = 128, a slot of 32 HC
    bytes): block c's forward slab s of layer l is W_l^T's column half c
    (B [k][n] = W_l[k][c HC/2 + n]) in the dtype's values, CB_KSB bf16 or
    WG_KSF f32 k-rows; its backward slab s is W_l's row half c (B [k][n] =
    W_l[c HC/2 + n][k]) in f32, WG_KSF k-rows, in both dtypes."""
    R, L, N = 2, 2, HC // 2
    W = torch.from_numpy(np.random.default_rng(HC).normal(size=(R, L, HC, HC))
                         .astype(np.float32))
    wf, wb = cuda_pma.cluster_bwd_weights(W, dtype)
    ksf = cuda_pma.CB_KSB if dtype == torch.bfloat16 else cuda_pma.WG_KSF
    ksb = cuda_pma.WG_KSF
    assert wf.shape[:4] == (R, 2, L, HC // ksf) and wf.dtype == dtype
    assert wb.shape[:4] == (R, 2, L, HC // ksb) and wb.dtype == torch.float32
    for slabs in (wf, wb):
        assert slabs[0, 0, 0, 0].numel() * slabs.element_size() == 32 * HC
    Wd = W.to(dtype)
    for r in range(R):
        for c in range(2):
            for l in range(L):
                fwd = torch.cat([read_slab(wf[r, c, l, s], N, ksf) for s in range(HC // ksf)])
                assert torch.equal(fwd, Wd[r, l, :, c * N:(c + 1) * N])
                bwd = torch.cat([read_slab(wb[r, c, l, s], N, ksb) for s in range(HC // ksb)])
                assert torch.equal(bwd, W[r, l, c * N:(c + 1) * N, :].T)
