"""K2's warpgroup route (f32 at HC 256, beside K3a in
csrc/pma_epilogue_wg.cu) on its host side: the route by width and dtype
in ``fwd_kernel``, ``epilogue_route`` and ``_launch_fwd`` (the entry point
and the forward slabs it is handed), and the forward's plain version at HC
256 with the kernels' products against the JAX kernel in interpret
mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allset_tpu.ops.pallas_pma import pma_epilogue as jax_epilogue
from allset_tpu_torch.ops import _kernels, cuda_pma
from tests.test_torch_pma import _inputs, split_mm


def test_the_route_by_width_and_dtype():
    """K2 in f32 at HC 256 takes the warpgroup kernel; bf16 there, and both
    dtypes from 64 to 512 otherwise, the tiled K2; above 512 the wide
    pair; every one of them is the 'kernel' route of epilogue_route."""
    assert cuda_pma.WG_FWD_WIDTHS == (256,)
    for HC in (64, 128, 192, 256, 384, 512, 640, 1024):
        for dt in (torch.float32, torch.bfloat16):
            want = ("wide" if HC > 512 else "wg" if HC == 256 and dt == torch.float32
                    else "tiled")
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


@pytest.mark.parametrize("HC,R", [(256, None), (256, 3), (128, None), (512, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_fwd_calls_the_routed_entry(HC, R, dtype, monkeypatch):
    """_launch_fwd hands f32 at HC 256 to allset_pma_epilogue_fwd_wg with
    the forward slabs of wg_fwd_weights (K3a's, TF32 hi | lo) and bf16
    there and the other widths to allset_pma_epilogue_fwd; the shapes as
    the kernels read them."""
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
    made = []
    real = cuda_pma.wg_fwd_weights
    monkeypatch.setattr(cuda_pma, "wg_fwd_weights",
                        lambda *a: made.append(real(*a)) or made[-1])
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
    else:
        assert name == "allset_pma_epilogue_fwd" and not made
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
