"""K2/K3's plain versions (the CPU path of pma_epilogue and its backward)
against the JAX package's fused epilogue kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allset_tpu.ops.pallas_pma import pma_epilogue as jax_epilogue
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.ops.cuda_pma import epilogue_fwd_cuda, pma_epilogue

H, HC, M, WP, BLK = 4, 128, 200, 136, 64  # M not a multiple of BLK
NAMES = ["dagg", "dseed", "dg0", "db0", "dW", "dbrff", "dg1", "db1"]


def _inputs(L, seed=0):
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


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_matches_jax_kernel(dtype, L, relu):
    agg, params, tgt = _inputs(L)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)

    def jloss(*a):
        y = jax_epilogue(H, BLK, True, relu, *a)
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
