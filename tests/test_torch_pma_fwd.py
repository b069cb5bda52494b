"""K2's warpgroup route (f32 at HC 256, beside K3a in
csrc/pma_epilogue_wg.cu) and its cluster route (HC 384 and 512, both
dtypes, csrc/pma_epilogue_cluster.cu) on their host side: the route by
width and dtype in ``fwd_kernel``, ``epilogue_route`` and ``_launch_fwd``
(the entry point and the slabs it is handed), the cluster's column-half
slabs read as the kernel reads them, and the forward with the kernels'
products (at HC 384 and 512 also with the cluster's row statistics, block
0's half-row sums plus block 1's) against the JAX kernel in interpret
mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allset_tpu.ops.pallas_pma import pma_epilogue as jax_epilogue
from allset_tpu_torch.ops import _kernels, cuda_pma
from tests.test_torch_pma import _inputs, split_mm


def test_the_route_by_width_and_dtype():
    """K2 in f32 at HC 256 takes the warpgroup kernel; both dtypes at 384
    and 512 the cluster kernel; bf16 at 256, and both dtypes from 64 to
    192, the tiled K2; above 512 the wide pair; every one of them is the
    'kernel' route of epilogue_route."""
    assert cuda_pma.WG_FWD_WIDTHS == (256,)
    assert cuda_pma.CLUSTER_FWD_WIDTHS == (384, 512)
    for HC in (64, 128, 192, 256, 384, 512, 640, 1024):
        for dt in (torch.float32, torch.bfloat16):
            want = ("wide" if HC > 512 else "cluster" if HC in (384, 512)
                    else "wg" if HC == 256 and dt == torch.float32 else "tiled")
            assert cuda_pma.fwd_kernel(HC, dt) == want
        assert cuda_pma.epilogue_route(HC, 8, 2, HC + 8) == "kernel"
    assert cuda_pma.epilogue_route(256, 8, 3, 264) == "plain"


class _Lib:
    """Records the C entry points _launch_fwd calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("HC,R", [(256, None), (256, 3), (128, None), (512, 2), (384, None),
                                  (512, None), (384, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_fwd_calls_the_routed_entry(HC, R, dtype, monkeypatch):
    """_launch_fwd hands f32 at HC 256 to allset_pma_epilogue_fwd_wg with
    the forward slabs of wg_fwd_weights (K3a's, TF32 hi | lo), HC 384 and
    512 to allset_pma_epilogue_fwd_cluster with the column halves' slabs
    of cluster_fwd_weights (plain f32 or bf16), and bf16 at 256 and the
    other widths to allset_pma_epilogue_fwd; the shapes as the kernels
    read them."""
    lib = _Lib()
    M, H, L = 100, 8, 2
    WP, runs = HC + 8, R or 1
    monkeypatch.setattr(_kernels, "lib", lambda: lib)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(cuda_pma, "_check_cuda_args", lambda *a: (M, WP, HC, L))
    lead = () if R is None else (R,)
    agg = torch.zeros(M, runs * WP, dtype=dtype)
    vec = torch.zeros(*lead, HC)
    W = torch.randn(*lead, L, HC, HC)
    made, made_cl = [], []
    real, real_cl = cuda_pma.wg_fwd_weights, cuda_pma.cluster_fwd_weights
    monkeypatch.setattr(cuda_pma, "wg_fwd_weights",
                        lambda *a: made.append(real(*a)) or made[-1])
    monkeypatch.setattr(cuda_pma, "cluster_fwd_weights",
                        lambda *a: made_cl.append(real_cl(*a)) or made_cl[-1])
    out = cuda_pma._launch_fwd(agg, vec, vec, vec, W, torch.zeros(*lead, L, HC), vec, vec, H,
                               True, R)
    assert out.shape == (M, runs * HC) and out.dtype == dtype
    (name, args), = lib.calls
    if HC == 256 and dtype == torch.float32:
        assert name == "allset_pma_epilogue_fwd_wg"
        assert args[4] == made[0].data_ptr()
        assert made[0].numel() * made[0].element_size() == runs * L * HC * HC * 8  # hi | lo
        assert torch.equal(made[0], cuda_pma.wg_weights(W, dtype)[0])
        assert args[9:17] == (M, WP, HC, H, L, runs, 1, _kernels.dtype_code(agg))
        assert not made_cl
    elif HC in (384, 512):
        assert name == "allset_pma_epilogue_fwd_cluster" and not made
        (slabs,) = made_cl
        assert args[4] == slabs.data_ptr() and slabs.dtype == dtype
        assert slabs.numel() == runs * L * HC * HC  # one element each, no split
        assert torch.equal(slabs, cuda_pma.cluster_fwd_weights(W, dtype))
        assert args[9:17] == (M, WP, HC, H, L, runs, 1, _kernels.dtype_code(agg))
    else:
        assert name == "allset_pma_epilogue_fwd" and not made and not made_cl
        assert args[10:18] == (M, WP, HC, H, L, runs, 1, _kernels.dtype_code(agg))


def route_mm(a, b):
    """K2's products at HC 256: an A exact in bf16 against bf16 weights as
    exact bf16 products summed in f32 (emulated in f64; the tiled K2), f32
    as 3xTF32 (the warpgroup K2)."""
    a, b = a.float(), b.float()
    if torch.equal(a, a.to(torch.bfloat16).float()) and torch.equal(
            b, b.to(torch.bfloat16).float()):
        return (a.double() @ b.double()).float()
    return split_mm(a, b)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("H,L", [(8, 1), (8, 2), (32, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_at_hc_256_on_route_products_matches_jax_kernel(dtype, H, L, relu, monkeypatch):
    """K2's plain version at HC 256 (8 and 32 heads, 1 and 2 layers, relu
    on and off) with the kernels' products against the JAX
    kernel's forward in interpret mode, on 70 rows (not a multiple of the
    64-row tile), at the forward's tolerances (f32 2e-5, bf16 5e-2)."""
    monkeypatch.setattr(cuda_pma, "_mm", route_mm)
    HC, M = 256, 70
    WP = -(-(HC + H) // 8) * 8
    agg, params, _ = _inputs(L, H=H, HC=HC, M=M, WP=WP)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    y_ref = jax_epilogue(H, 64, True, relu, jnp.asarray(agg, jd),
                         *[jnp.asarray(p) for p in params])
    y = cuda_pma.epilogue_fwd(torch.tensor(agg).to(td), *[torch.tensor(p) for p in params], H,
                              relu)
    assert y.dtype == td and y.shape == (M, HC)
    tol = 5e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_ref, np.float32), atol=tol,
                               rtol=tol)


def read_slab(slab: torch.Tensor, N: int, ks: int) -> torch.Tensor:
    """B [ks, N] of one slab, read element by element at the byte offsets
    the kernel's wgmma descriptors give (K-major core matrices of 8 rows x
    16 bytes: LBO = N * 16 bytes between k chunks, SBO = 128 between
    groups of 8 columns)."""
    flat = slab.reshape(-1)
    item = flat.element_size()
    V = 16 // item
    k = torch.arange(ks)[:, None]
    n = torch.arange(N)[None, :]
    byte = (k // V) * (N * 16) + (n // 8) * 128 + (n % 8) * 16 + (k % V) * item
    return flat[byte // item]


@pytest.mark.parametrize("HC", [384, 512])
@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_slabs_reassemble_w_transposed(HC, L, dtype):
    """cluster_fwd_weights' slab s of column half c, layer l, run r, read
    at the kernel's descriptor offsets, is W_l[s ks : (s + 1) ks, c HC/2 :
    (c + 1) HC/2] exactly (B = W^T, K-major), in the dtype's values; its
    f32 slabs split as the kernel splits them (cvt.rna hi, lo of the rest)
    give tf32_split's parts of W, hi + lo within 2^-22 of W."""
    R, N = 2, HC // 2
    W = torch.from_numpy(np.random.default_rng(HC + L).normal(size=(R, L, HC, HC))
                         .astype(np.float32))
    slabs = cuda_pma.cluster_fwd_weights(W, dtype)
    ks = cuda_pma.WG_KSF if dtype == torch.float32 else cuda_pma.WG_KSB
    assert slabs.shape[:4] == (R, 2, L, HC // ks) and slabs.dtype == dtype
    Wd = W.to(dtype)
    for r in range(R):
        for c in range(2):
            for l in range(L):
                got = torch.cat([read_slab(slabs[r, c, l, s], N, ks) for s in range(HC // ks)])
                assert torch.equal(got, Wd[r, l, :, c * N:(c + 1) * N])
                if dtype == torch.float32:
                    hi, lo = cuda_pma.tf32_split(got)
                    want_hi, want_lo = cuda_pma.tf32_split(W[r, l, :, c * N:(c + 1) * N])
                    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
                    assert ((got - hi - lo).abs() <= got.abs() * 2.0**-22).all()


def cluster_fwd(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu):
    """A plain emulation of the cluster K2 on one run: out0 with den per
    head, the row statistics of LN0 and LN1 as block 0's half-row sums
    plus block 1's (each block sums its HC / 2 columns), the products as
    the kernel's (route_mm: exact bf16 products summed in f32, or
    3xTF32), TorchDense's rounding points."""
    cdt = agg.dtype
    HC = seed.shape[0]
    half = HC // 2
    a = agg.float()
    dinv = 1.0 / a[:, HC:HC + H].clamp_min(cuda_pma.DEN_FLOOR)
    out0 = a[:, :HC] * dinv.repeat_interleave(HC // H, dim=1) + seed

    def ln(x, g, b):
        s = x[:, :half].sum(1, keepdim=True) + x[:, half:].sum(1, keepdim=True)
        q = (x * x)[:, :half].sum(1, keepdim=True) + (x * x)[:, half:].sum(1, keepdim=True)
        mu = s / HC
        return (x - mu) * torch.rsqrt(q / HC - mu * mu + cuda_pma.EPS) * g + b

    zb = ln(out0, g0, b0).to(cdt)
    h = zb
    for l in range(Wrff.shape[0]):
        p = (route_mm(h, Wrff[l].to(cdt)).to(cdt).float() + brff[l]).to(cdt).float()
        h = p.clamp_min(0.0).to(cdt)
    y = ln(zb.float() + p.clamp_min(0.0), g1, b1).to(cdt)
    return y.clamp_min(0) if relu else y


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("heads", ["1", "8", "HC"])
@pytest.mark.parametrize("HC", [384, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cluster_forward_emulation_matches_jax_kernel(dtype, HC, heads, relu):
    """The cluster K2's emulation (cluster_fwd) at HC 384 and 512, heads 1,
    8 and HC, 2 layers, relu on and off, against the JAX kernel's forward
    in interpret mode on 70 rows (one tile and a part), at the forward's
    tolerances (f32 2e-5, bf16 5e-2)."""
    H = {"1": 1, "8": 8, "HC": HC}[heads]
    M, L = 70, 2
    WP = -(-(HC + H) // 8) * 8
    agg, params, _ = _inputs(L, seed=HC + H, H=H, HC=HC, M=M, WP=WP)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    y_ref = jax_epilogue(H, 64, True, relu, jnp.asarray(agg, jd),
                         *[jnp.asarray(p) for p in params])
    y = cluster_fwd(torch.tensor(agg).to(td), *[torch.tensor(p) for p in params], H, relu)
    assert y.dtype == td and y.shape == (M, HC)
    tol = 5e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("HC", [384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_runs_grid_equals_single_runs(HC, dtype, monkeypatch):
    """K2R's function at HC 384 and 512 with the route's products, R = 2
    runs folded into the width: each run's y equals K2's on the run's
    slice bit for bit (the kernel computes every (run, tile) item alike)."""
    monkeypatch.setattr(cuda_pma, "_mm", route_mm)
    R, H, L, M = 2, 8, 2, 70
    WP = HC + 8
    per = [_inputs(L, seed=r, H=H, HC=HC, M=M, WP=WP) for r in range(R)]
    agg = torch.cat([torch.tensor(a) for a, _, _ in per], 1).to(dtype)
    params = [torch.stack([torch.tensor(p[i]) for _, p, _ in per]) for i in range(7)]
    y = cuda_pma.epilogue_fwd_runs(agg, *params, H, True)
    assert y.shape == (M, R * HC) and y.dtype == dtype
    for r in range(R):
        one = cuda_pma.epilogue_fwd(agg[:, r * WP:(r + 1) * WP].contiguous(),
                                    *[t[r] for t in params], H, True)
        assert torch.equal(y[:, r * HC:(r + 1) * HC], one)
