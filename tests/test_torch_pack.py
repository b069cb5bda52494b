"""The PMA score+pack (K4/K5) plain version against the JAX package's
composition (``_pack_ref``) and its Pallas kernels in interpret mode; the
autograd Function's backward; the runs layout.

The JAX table is 128-lane padded (WP = 384 at HC = 256), the port's to a
multiple of 8 (WP = 264): the first HC + H columns are compared, and the
port's columns beyond them are zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allset_tpu.ops.pallas_pack import _pack_ref
from allset_tpu.ops.pallas_pack import packed_width as jax_packed_width
from allset_tpu.ops.pallas_pack import pma_pack as jax_pma_pack
from allset_tpu_torch.nn.modules import packed_width
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.ops.cuda_pack import (
    gmax_plain,
    pack_fwd,
    pack_plain,
    pack_runs_plain,
    pma_pack,
)

SLOPE = 0.2
TOL = {"float32": 1e-6, "bfloat16": 2 ** -7}  # tests/test_pallas_pack.py's


def _inputs(H, HC, M, seed=0):
    """Seeded numpy values and scores, the biases, and a fixed cotangent."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(M, HC)).astype(np.float32)
    scores = (2.0 * rng.normal(size=(M, H))).astype(np.float32)
    bV = (0.1 * rng.normal(size=HC)).astype(np.float32)
    ba = (0.1 * rng.normal(size=H)).astype(np.float32)
    return vals, scores, bV, ba


def _yf(vals, scores, WP):
    M = vals.shape[0]
    return np.concatenate([vals, scores, np.zeros((M, WP - vals.shape[1] - scores.shape[1]),
                                                  np.float32)], axis=1)


def _port(vals, scores, bV, ba, dtype):
    H, HC = scores.shape[1], vals.shape[1]
    yf = torch.from_numpy(_yf(vals, scores, packed_width(HC, H))).to(getattr(torch, dtype))
    return pack_plain(yf, torch.from_numpy(bV), torch.from_numpy(ba), H).float().numpy()


def _check(got, want, H, HC, dtype):
    np.testing.assert_allclose(got[:, : HC + H], np.asarray(want, np.float32)[:, : HC + H],
                               rtol=TOL[dtype], atol=1e-6)
    assert not got[:, HC + H :].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [1, 4, 8])
def test_pack_plain_matches_jax_ref_and_kernel(dtype, H):
    HC, M = 256, 520  # M not a multiple of the JAX kernel's block
    vals, scores, bV, ba = _inputs(H, HC, M)
    got = _port(vals, scores, bV, ba, dtype)
    assert got.shape == (M, packed_width(HC, H))
    WP = jax_packed_width(HC, H)
    jyf = jnp.asarray(_yf(vals, scores, WP)).astype(dtype)
    jbV, jba = jnp.asarray(bV), jnp.asarray(ba)
    _check(got, _pack_ref(jyf, jbV, jba, H=H, HC=HC, WP=WP, slope=SLOPE), H, HC, dtype)
    _check(got, jax_pma_pack(H, HC, WP, SLOPE, 256, True, jyf, jbV, jba), H, HC, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_plain_matches_jax_ref_at_the_cli_width(dtype):
    """HC=64, H=1 (the CLI defaults): HC + H = 65 is not a multiple of 8,
    so WP = 72. The JAX kernel needs HC % 128 == 0: _pack_ref only."""
    HC, H, M = 64, 1, 300
    vals, scores, bV, ba = _inputs(H, HC, M, seed=3)
    got = _port(vals, scores, bV, ba, dtype)
    assert got.shape == (M, 72)
    jyf = jnp.asarray(_yf(vals, scores, HC + H)).astype(dtype)
    want = _pack_ref(jyf, jnp.asarray(bV), jnp.asarray(ba), H=H, HC=HC, WP=HC + H, slope=SLOPE)
    _check(got, want, H, HC, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_backward_is_the_composition_autograd(dtype):
    """With the same fixed cotangent, the Function's backward (pack_vjp,
    the composition's vjp written out) equals autograd through pack_plain
    bit for bit (as tests/test_pallas_pack.py holds the custom_vjp)."""
    H, HC, M = 8, 256, 512
    vals, scores, bV, ba = _inputs(H, HC, M, seed=1)
    td = getattr(torch, dtype)
    WP = packed_width(HC, H)
    gw = torch.from_numpy(np.random.default_rng(9).normal(size=(M, WP)).astype(np.float32)).to(td)

    def grads(fn):
        ins = [torch.from_numpy(_yf(vals, scores, WP)).to(td), torch.from_numpy(bV),
               torch.from_numpy(ba)]
        ins = [t.requires_grad_() for t in ins]
        return fn(*ins, H), torch.autograd.grad(fn(*ins, H), ins, gw)

    (w_fn, g_fn), (w_ref, g_ref) = grads(pma_pack), grads(pack_plain)
    assert torch.equal(w_fn, w_ref)
    for a, b in zip(g_fn, g_ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_pack_runs_fold_equals_each_run():
    """R=3 folded: w [rows, R*WP] and the gradients of yf [rows, R, WP],
    bV [R, HC] and ba [R, H] equal each run alone, bit for bit."""
    H, HC, M, R = 4, 128, 200, 3
    WP = packed_width(HC, H)
    per = [_inputs(H, HC, M, seed=10 + r) for r in range(R)]
    yf = torch.stack([torch.from_numpy(_yf(v, s, WP)) for v, s, _, _ in per], dim=1)
    bV = torch.stack([torch.from_numpy(p[2]) for p in per])
    ba = torch.stack([torch.from_numpy(p[3]) for p in per])
    gw = torch.from_numpy(np.random.default_rng(4).normal(size=(M, R * WP)).astype(np.float32))
    ins = [t.clone().requires_grad_() for t in (yf, bV, ba)]
    w = pma_pack(*ins, H)
    assert w.shape == (M, R * WP) and torch.equal(w, pack_runs_plain(yf, bV, ba, H))
    g = torch.autograd.grad(w, ins, gw)
    for r in range(R):
        one = [t.clone().requires_grad_() for t in (yf[:, r].contiguous(), bV[r], ba[r])]
        w1 = pma_pack(*one, H)
        assert torch.equal(w[:, r * WP : (r + 1) * WP], w1)
        g1 = torch.autograd.grad(w1, one, gw[:, r * WP : (r + 1) * WP].contiguous())
        for a, b in zip((g[0][:, r], g[1][r], g[2][r]), g1):
            assert torch.equal(a, b)


def test_gmax_plain_propagates_nan_and_clamps_at_zero():
    H, HC, M = 4, 64, 50
    vals, scores, bV, ba = _inputs(H, HC, M, seed=2)
    scores[:, 1] = -np.abs(scores[:, 1]) - 1.0  # every score of head 1 < 0
    scores[17, 2] = np.nan
    yf = torch.from_numpy(_yf(vals, scores, packed_width(HC, H)))
    g = gmax_plain(yf, torch.zeros(H), H, HC)
    assert g[1] == 0.0 and torch.isnan(g[2]) and torch.isfinite(g[[0, 3]]).all()
    w = pack_plain(yf, torch.from_numpy(bV), torch.zeros(H), H)
    assert torch.isnan(w[:, HC + 2]).all()  # exp(alpha - NaN) in every row


def test_pack_takes_the_plain_version_on_the_cpu_only():
    H, HC, M = 2, 64, 40
    vals, scores, bV, ba = _inputs(H, HC, M, seed=5)
    yf = torch.from_numpy(_yf(vals, scores, packed_width(HC, H)))
    _kernels.reset_launches()
    w, gmax = pack_fwd(yf, torch.from_numpy(bV), torch.from_numpy(ba), H)
    assert torch.equal(gmax, gmax_plain(yf, torch.from_numpy(ba), H, HC))
    assert torch.equal(w, pack_plain(yf, torch.from_numpy(bV), torch.from_numpy(ba), H))
    assert sum(_kernels.launches.values()) == 0
    with pytest.raises(ValueError, match="unsupported device"):
        pack_fwd(yf.to("meta"), torch.zeros(HC, device="meta"), torch.zeros(H, device="meta"), H)
