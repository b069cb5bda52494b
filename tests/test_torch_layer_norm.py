"""The LayerNorm kernels' plain versions (B12 forward, B13 backward; the
CPU path of ops/cuda_ln.py) against the JAX package: ``jax.vjp`` of
``allset_tpu.nn.modules.NormLayer('ln')`` (flax LayerNorm, fast variance)
and the fused Pallas experiment of ``benchmarks/exp_ln.py`` run in
interpret mode (two-pass variance; the tolerance covers the formula)."""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from allset_tpu.nn.modules import NormLayer as JNorm
from allset_tpu_torch.nn.modules import NormLayer
from allset_tpu_torch.ops import _kernels, cuda_ln
from allset_tpu_torch.ops.cuda_ln import layer_norm, ln_bwd_plain, ln_fwd_cuda, ln_fwd_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(rows, F, seed=0, R=None):
    rng = np.random.default_rng(seed)
    lead = (rows,) if R is None else (rows, R)
    x = (2.0 * rng.normal(size=lead + (F,)) + 1.0).astype(np.float32)
    pshape = (F,) if R is None else (R, F)
    gamma = (1.0 + 0.3 * rng.normal(size=pshape)).astype(np.float32)
    beta = (0.2 * rng.normal(size=pshape)).astype(np.float32)
    g = rng.normal(size=lead + (F,)).astype(np.float32)
    return x, gamma, beta, g


def _jax_ln(x, gamma, beta, g, dtype=None):
    """flax LayerNorm through the JAX NormLayer: y and the vjp (dx, dscale,
    dbias)."""
    m = JNorm("ln", dtype=dtype)
    params = {"LayerNorm_0": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}
    y, vjp = jax.vjp(lambda p, xx: m.apply({"params": p}, xx, False), params, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g).astype(y.dtype))
    return (np.asarray(y, np.float32), np.asarray(dx),
            np.asarray(dp["LayerNorm_0"]["scale"]), np.asarray(dp["LayerNorm_0"]["bias"]))


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, (what, err)


@pytest.mark.parametrize("F", [7, 64, 256, 300])
def test_plain_layer_norm_matches_flax_norm_layer(F):
    """f32: y, and B13's dx, dgamma, dbeta against jax.vjp, within 1e-5
    of each tensor's max |.|."""
    x, gamma, beta, g = _inputs(133, F)
    y_ref, dx_ref, dg_ref, db_ref = _jax_ln(x, gamma, beta, g)
    xt, gt = torch.from_numpy(x), torch.from_numpy(gamma)
    y = ln_fwd_plain(xt, gt, torch.from_numpy(beta), torch.float32)
    dx, dg, db = ln_bwd_plain(torch.from_numpy(g), xt, gt)
    for got, want, what in ((y, y_ref, "y"), (dx, dx_ref, "dx"), (dg, dg_ref, "dgamma"),
                            (db, db_ref, "dbeta")):
        _close(got.numpy(), want, 1e-5, what)


def test_plain_layer_norm_bf16_output_matches_flax():
    """dtype bf16 on an f32 input (the first input norm of a bf16 model):
    the output is bf16, the statistics f32."""
    x, gamma, beta, g = _inputs(64, 48, seed=3)
    y_ref, dx_ref, _, _ = _jax_ln(x, gamma, beta, g, dtype=jnp.bfloat16)
    xt = torch.from_numpy(x).requires_grad_()
    y = layer_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta), torch.bfloat16)
    assert y.dtype == torch.bfloat16 and xt.dtype == torch.float32
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    _close(y.detach().float().numpy(), y_ref, 8e-3, "y")  # a bf16 rounding step
    assert xt.grad.dtype == torch.float32
    _close(xt.grad.numpy(), dx_ref, 1e-5, "dx")


def _exp_ln(monkeypatch):
    """benchmarks/exp_ln.py with its module's ``pl`` reference replaced by
    one whose pallas_call runs in interpret mode (the file is not
    changed)."""
    spec = importlib.util.spec_from_file_location(
        "exp_ln_under_test", os.path.join(REPO, "benchmarks", "exp_ln.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(mod, "pl", ns)
    return mod


def test_plain_layer_norm_matches_exp_ln_pallas_kernels(monkeypatch):
    """B12 and B13 as exp_ln.py wrote them, in interpret mode, on rows of
    2x+1 with x ~ N(0, 1) (its own inputs' law): within 1e-5, which covers
    the fast variance against its two-pass one."""
    exp_ln = _exp_ln(monkeypatch)
    x, gamma, beta, g = _inputs(256, 128, seed=5)
    y_ref = exp_ln.pallas_ln_fwd(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), blk=64)
    dx_ref, dg_ref, db_ref = exp_ln.pallas_ln_bwd(jnp.asarray(g), jnp.asarray(x),
                                                  jnp.asarray(gamma), blk=64)
    xt, gt = torch.from_numpy(x), torch.from_numpy(gamma)
    y = ln_fwd_plain(xt, gt, torch.from_numpy(beta), torch.float32)
    dx, dg, db = ln_bwd_plain(torch.from_numpy(g), xt, gt)
    for got, want, what in ((y, y_ref, "y"), (dx, dx_ref, "dx"), (dg, dg_ref, "dgamma"),
                            (db, db_ref, "dbeta")):
        _close(got.numpy(), np.asarray(want), 1e-5, what)


@pytest.mark.parametrize("shared", [False, True])
def test_runs_folded_layer_norm_is_each_run_alone(shared):
    """x [rows, R, F] (or one [rows, F] shared by the runs) with [R, F]
    parameters: run r's y, dgamma and dbeta equal a single-run call on run
    r, bit for bit; a shared x's gradient is the runs' sum. Each run is
    also held to the JAX NormLayer."""
    R, rows, F = 3, 70, 40
    x, gamma, beta, g = _inputs(rows, F, seed=9, R=R)
    if shared:
        x = x[:, 0]
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    y = layer_norm(xt, gt, bt)
    assert y.shape == (rows, R, F)
    y.backward(torch.from_numpy(g))
    dx_sum = torch.zeros(rows, F)
    for r in range(R):
        xr = (xt if shared else xt[:, r]).detach().contiguous().requires_grad_()
        g1 = torch.from_numpy(gamma[r]).requires_grad_()
        b1 = torch.from_numpy(beta[r]).requires_grad_()
        y1 = layer_norm(xr, g1, b1)
        y1.backward(torch.from_numpy(g[:, r]).contiguous())
        assert torch.equal(y[:, r].detach(), y1.detach())
        assert torch.equal(gt.grad[r], g1.grad) and torch.equal(bt.grad[r], b1.grad)
        if shared:
            dx_sum += xr.grad
        else:
            assert torch.equal(xt.grad[:, r], xr.grad)
        y_ref, dx_ref, dg_ref, db_ref = _jax_ln(x if shared else x[:, r], gamma[r], beta[r],
                                                g[:, r])
        _close(y1.detach().numpy(), y_ref, 1e-5, "y")
        _close(g1.grad.numpy(), dg_ref, 1e-5, "dgamma")
    if shared:
        torch.testing.assert_close(xt.grad, dx_sum)


def test_norm_layer_takes_the_layer_norm_function_and_launches_nothing_on_cpu():
    """NormLayer('ln') is layer_norm with its parameters; on CPU tensors no
    kernel launches, and the kernel wrapper refuses them."""
    x, gamma, beta, _ = _inputs(20, 16)
    m = NormLayer("ln", 16)
    with torch.no_grad():
        m.LayerNorm_0.scale.copy_(torch.from_numpy(gamma))
        m.LayerNorm_0.bias.copy_(torch.from_numpy(beta))
    _kernels.reset_launches()
    y = m(torch.from_numpy(x))
    assert sum(_kernels.launches.values()) == 0
    assert torch.equal(y, ln_fwd_plain(torch.from_numpy(x), m.LayerNorm_0.scale,
                                       m.LayerNorm_0.bias, torch.float32))
    with pytest.raises(ValueError):
        ln_fwd_cuda(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                    torch.float32)
    with pytest.raises(ValueError):
        cuda_ln.ln_fwd(torch.from_numpy(x).to("meta"), torch.from_numpy(gamma),
                       torch.from_numpy(beta), torch.float32)
