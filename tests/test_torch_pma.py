"""K2/K3's plain versions (the CPU path of pma_epilogue and its backward)
against the JAX package's fused epilogue kernel in interpret mode, with
f32 products and with the kernels' 3xTF32 split emulated, at every width
the kernels take (HC 64 to 512); the shapes the kernels refuse against
the JAX package's composition; the shape predicate and the route on the
card against the JAX package's gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allset_tpu.ops.pallas_pma import _reference_fwd
from allset_tpu.ops.pallas_pma import pma_epilogue as jax_epilogue
from allset_tpu_torch.ops import _kernels, cuda_pma
from allset_tpu_torch.ops.cuda_pma import epilogue_fwd_cuda, pma_epilogue

H, HC, M, WP, BLK = 4, 128, 200, 136, 64  # M not a multiple of BLK
NAMES = ["dagg", "dseed", "dg0", "db0", "dW", "dbrff", "dg1", "db1"]


def _inputs(L, seed=0, H=H, HC=HC, M=M, WP=WP):
    rng = np.random.default_rng(seed)
    den = rng.uniform(0.3, 3.0, (M, H))
    den[::23] = 0.0  # empty segments: the 1e-16 floor
    vals = rng.normal(size=(M, HC))
    vals[::23] = 0.0
    agg = np.concatenate([vals, den, np.zeros((M, WP - HC - H))], 1).astype(np.float32)
    params = [0.1 * rng.normal(size=HC), 1 + 0.1 * rng.normal(size=HC),
              0.1 * rng.normal(size=HC), 0.05 * rng.normal(size=(L, HC, HC)),
              0.1 * rng.normal(size=(L, HC)), 1 + 0.1 * rng.normal(size=HC),
              0.1 * rng.normal(size=HC)]
    tgt = rng.normal(size=(M, HC)).astype(np.float32)
    return agg, [p.astype(np.float32) for p in params], tgt


def tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 explicit mantissa bits, ties away
    from zero (finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_mm(a, b):
    """The kernels' 3xTF32 product: a = ah + al, b = bh + bl (TF32 parts,
    al = tf32(a - ah)); al@bh + ah@bl + ah@bh, the TF32 products exact and
    summed in f64. Where a is exact in TF32 (bf16), al = 0: 2xTF32."""
    a, b = a.float(), b.float()
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    d = torch.float64
    return (al.to(d) @ bh.to(d) + ah.to(d) @ bl.to(d) + ah.to(d) @ bh.to(d)).float()


@pytest.mark.parametrize("K", [64, 256, 512])
def test_split_tf32_product_is_f32_accurate(K):
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.normal(size=(300, K)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(K, 200)).astype(np.float32))
    ref = (a.double() @ b.double()).float()
    f32 = a @ b
    scale = ref.abs().max().item()
    assert (split_mm(a, b) - f32).abs().max().item() / scale <= 1e-6
    assert (split_mm(a, b) - ref).abs().max().item() / scale <= 1e-6
    # each operand's parts: 11 significant bits each, the rest within 2^-22
    ah = tf32(a)
    assert ((ah.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((a - ah - tf32(a - ah)).abs() <= a.abs() * 2.0**-22).all()
    # plain TF32 (one product of the rounded operands) is not enough
    assert (tf32(a) @ tf32(b) - f32).abs().max().item() / scale > 1e-4


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_on_split_products_matches_jax_kernel(dtype, L, monkeypatch):
    """The plain epilogue with every rFF product taken as the kernels take
    it (3xTF32; a bf16 operand makes its low part 0) stays within the JAX
    kernel's tolerances."""
    monkeypatch.setattr(cuda_pma, "_mm", split_mm)
    test_epilogue_matches_jax_kernel(dtype, L, True)


@pytest.mark.parametrize("shape", [(8, 192, 100, 200), (32, 256, 70, 288)],
                         ids=["HC192-H8", "HC256-H32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_at_other_widths_on_split_products_matches_jax_kernel(dtype, shape,
                                                                       monkeypatch):
    """The other widths and head counts the kernels take (HC % 64 == 0,
    HC <= 256, any H dividing HC), with the kernels' split products."""
    monkeypatch.setattr(cuda_pma, "_mm", split_mm)
    _check_against_jax(dtype, 2, True, *shape)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_matches_jax_kernel(dtype, L, relu):
    _check_against_jax(dtype, L, relu, H, HC, M, WP)


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("H", [1, 8])
@pytest.mark.parametrize("HC", [384, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_at_hc_384_512_matches_jax_kernel(dtype, HC, H, L):
    """The widths the kernels take on 32-row tiles (HC 384 and 512, heads 1
    and 8, an rFF of 1 or 2 layers): values and gradients against the JAX
    kernel in interpret mode, on M = 45 rows (not a multiple of 32) in
    32-row blocks."""
    _check_against_jax(dtype, L, True, H, HC, 45, HC + 8, blk=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_at_hc_512_on_split_products_matches_jax_kernel(dtype, monkeypatch):
    """HC 512 with the kernels' 3xTF32 products (a bf16 operand's low part
    0), 8 heads, 2 layers."""
    monkeypatch.setattr(cuda_pma, "_mm", split_mm)
    _check_against_jax(dtype, 2, True, 8, 512, 45, 520, blk=32)


def _check_against_jax(dtype, L, relu, H, HC, M, WP, blk=BLK):
    agg, params, tgt = _inputs(L, H=H, HC=HC, M=M, WP=WP)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)

    def jloss(*a):
        y = jax_epilogue(H, blk, True, relu, *a)
        return jnp.mean((y.astype(jnp.float32) - tgt) ** 2), y

    jargs = [jnp.asarray(agg, jd)] + [jnp.asarray(p) for p in params]
    (_, y_ref), g_ref = jax.value_and_grad(jloss, argnums=tuple(range(8)),
                                           has_aux=True)(*jargs)

    targs = [torch.tensor(agg).to(td).requires_grad_()] + [
        torch.tensor(p, requires_grad=True) for p in params]
    y = pma_epilogue(*targs, H, relu)
    assert y.dtype == td and y.shape == (M, HC)
    ((y.float() - torch.from_numpy(tgt)) ** 2).mean().backward()

    ftol = 5e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(y_ref, np.float32),
                               atol=ftol, rtol=ftol)
    gtol = 6e-2 if dtype == "bfloat16" else 1e-4
    for name, t, j in zip(NAMES, targs, g_ref):
        a, b = t.grad.float().numpy(), np.asarray(j, np.float32)
        assert a.shape == b.shape, name
        # the bounded-fraction rule of the JAX kernel's own test: a sparse
        # tail of dW elements may differ by a few bf16 ulps
        tol = 2 * gtol if name == "dW" else gtol
        # dvals at the 1e-16 floor are ~1e16 times the rest: scale apart
        floor = np.abs(b) >= 1e6
        for sel in (~floor, floor):
            if sel.any():
                scale = max(np.abs(b[sel]).max(), 1e-3)
                bad = np.abs(a[sel] - b[sel]) / scale > tol
                assert bad.mean() < 1e-3, (name, bad.mean())


def test_cpu_epilogue_launches_nothing_and_the_kernel_refuses_cpu():
    agg, params, _ = _inputs(1)
    _kernels.reset_launches()
    targs = [torch.tensor(agg)] + [torch.tensor(p) for p in params]
    pma_epilogue(*targs, H, True)
    assert sum(_kernels.launches.values()) == 0
    with pytest.raises(ValueError):
        epilogue_fwd_cuda(*targs, H, True)
    with pytest.raises(ValueError):
        pma_epilogue(targs[0].to("meta"), *targs[1:], H, True)


@pytest.mark.parametrize("H,HC,L,WP", [(4, 128, 3, 136), (8, 512, 2, 520)],
                         ids=["L3", "HC512"])
def test_plain_route_shapes_match_jax_composition(H, HC, L, WP):
    """The plain epilogue agrees with the JAX package's own composition
    (``_reference_fwd``) on values and gradients, with the f32 tolerances
    above, where the kernels refuse the shape and at HC 512. An rFF of 3
    layers takes the plain version on the card too, as the JAX gate
    composes it; HC 512 takes it on the CPU only, and the kernels on the
    card."""
    agg, params, tgt = _inputs(L, H=H, HC=HC, M=M, WP=WP)
    if L == 3:
        assert not cuda_pma.epilogue_supported(HC, H, L, WP)
        assert cuda_pma.epilogue_route(HC, H, L, WP) == "plain"
    else:
        assert cuda_pma.epilogue_supported(HC, H, L, WP)
        assert cuda_pma.epilogue_route(HC, H, L, WP) == "kernel"

    def jloss(*a):
        y = _reference_fwd(*a, H=H, relu=True)
        return jnp.mean((y - tgt) ** 2), y

    jargs = [jnp.asarray(agg)] + [jnp.asarray(p) for p in params]
    (_, y_ref), g_ref = jax.value_and_grad(jloss, argnums=tuple(range(8)), has_aux=True)(*jargs)
    targs = [torch.tensor(agg).requires_grad_()] + [torch.tensor(p, requires_grad=True)
                                                    for p in params]
    y = pma_epilogue(*targs, H, True)
    ((y - torch.from_numpy(tgt)) ** 2).mean().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=2e-5, rtol=2e-5)
    for name, t, j in zip(NAMES, targs, g_ref):
        a, b = t.grad.numpy(), np.asarray(j)
        assert a.shape == b.shape, name
        floor = np.abs(b) >= 1e6  # dvals at the 1e-16 floor: scaled apart
        for sel in (~floor, floor):
            if sel.any():
                scale = max(np.abs(b[sel]).max(), 1e-3)
                assert np.abs(a[sel] - b[sel]).max() / scale <= 1e-4, name


def test_epilogue_supported_holds_the_kernels_limits():
    ok = cuda_pma.epilogue_supported
    assert ok(256, 8, 2, 264) and ok(64, 64, 1, 128) and ok(192, 8, 2, 200, R=20)
    assert ok(512, 8, 2, 520) and ok(384, 384, 1, 768) and ok(512, 1, 2, 520, R=20)
    assert ok(640, 8, 2, 648) and ok(1024, 16, 1, 1040, R=20)  # above 512: the wide pair
    assert ok(1536, 8, 2, 1544) and ok(2048, 8, 1, 2056)
    assert ok(2048, 8, 2, 2056)  # no TPU VMEM budget: the wide route takes every width
    assert not ok(2048 + 128, 8, 1, 2184)  # above the wide route's 2048
    assert not ok(640 + 64, 8, 2, 712)  # above 512, not a multiple of 128
    assert not ok(320, 8, 2, 328)  # HC between the kernels' widths
    assert not ok(96, 4, 2, 104)  # HC not a multiple of 64
    assert not ok(256, 8, 3, 264)  # L outside (1, 2)
    assert not ok(256, 8, 2, 260)  # WP not a multiple of 8
    assert not ok(256, 8, 2, 256)  # WP < HC + H
    assert not ok(256, 3, 2, 264)  # H not dividing HC
    assert not ok(256, 8, 2, 264, R=65536)


@pytest.mark.parametrize("HC,H,L,want", [
    (256, 8, 2, "kernel"), (64, 1, 1, "kernel"), (256, 8, 3, "plain"), (96, 4, 2, "plain"),
    (320, 8, 2, "plain"), (512, 8, 3, "plain"), (512, 8, 2, "kernel"), (384, 8, 1, "kernel"),
    (640, 8, 2, "kernel"), (1024, 16, 1, "kernel"), (2048, 8, 2, "kernel")])
def test_epilogue_route_follows_the_jax_gate(HC, H, L, want, monkeypatch):
    """On the card the epilogue takes its plain version only where the JAX
    package's gate (``epilogue_active``; interpret mode stands for the
    single TPU chip) composes it as well, and its kernels at every width a
    multiple of 128: the TPU kernel's scoped-VMEM cap (HC 2048 with 2
    layers in f32 needs more than its 110 MiB) binds no kernel of the
    card."""
    from allset_tpu.ops.pallas_pma import epilogue_active
    from allset_tpu_torch.nn.modules import packed_width

    monkeypatch.setenv("ALLSET_PMA_EPILOGUE", "interpret")
    jax_kernel = epilogue_active(HC, H, L, HC)
    WP = packed_width(HC, H)
    assert cuda_pma.epilogue_route(HC, H, L, WP) == want
    assert want == "kernel" or not jax_kernel
    if want == "kernel":
        assert cuda_pma.epilogue_supported(HC, H, L, WP)
    with pytest.raises(ValueError, match="H dividing HC"):
        cuda_pma.epilogue_route(256, 3, 2, 264)  # heads the kernels' layout refuses


def test_pma_takes_three_layer_rff_and_hc_512():
    """PMA builds with an rFF of 3 layers and with HC 512 and runs on the
    CPU (on the card HC 512 runs through K2/K3)."""
    from allset_tpu_torch.nn.modules import PMA
    from allset_tpu_torch.graph import add_self_loops, norm_construction
    from allset_tpu_torch.data.synthetic import synthetic_hypergraph

    hd = norm_construction(add_self_loops(synthetic_hypergraph(
        num_nodes=60, num_hyperedges=30, feature_dim=8, seed=0)), "all_one")
    d = hd.to_incidence(bucket=64).v2e()
    x = torch.randn(60, 8)
    for hid, L, heads in ((64, 3, 2), (512, 2, 8)):
        m = PMA(8, hid, hid, L, heads, torch.Generator().manual_seed(0))
        y = m(x, d)
        assert y.shape == (d.num_dst, hid) and torch.isfinite(y).all()
    with pytest.raises(NotImplementedError):
        PMA(8, 64, 32, 2, 2, torch.Generator().manual_seed(0))
