"""PMA's parity options in the port against the JAX module
(``allset_tpu/nn/modules.py:241-247``): ``softmax_mode='segment'`` (the
reference's per-segment-max softmax) and ``return_attention`` (each
entry's softmax weight), with the JAX parameters carried across by
params_from_jax: the outputs, the attention weights and every gradient
within the f32 2e-4 of tests/test_parity_setgnn.py. Both options compose
the epilogue and leave the score+pack out (no K4/K5 route on the CPU
either: the launch counts stay 0). The segment mode agrees with the
global mode within test_parity_setgnn.py's rtol 1e-4, atol 1e-5; each
destination's attention sums to 1; R runs folded give each run's own
values, and the segment mode refuses a self-loop split Direction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allset_tpu.data.synthetic as jsyn
import allset_tpu.graph.transforms as jtr
import allset_tpu_torch.data.synthetic as tsyn
import allset_tpu_torch.graph.transforms as ttr
from allset_tpu.nn.modules import PMA as JPMA
from allset_tpu_torch.nn.modules import PMA
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.utils import params_from_jax

F, HID, HEADS, TOL = 12, 32, 4, 2e-4


def _incs(self_loops=False):
    def build(syn, tr):
        hd = syn.synthetic_hypergraph(num_nodes=70, num_hyperedges=30, feature_dim=F, seed=4)
        if self_loops:
            hd = tr.add_self_loops(hd)
        return hd.to_incidence(bucket=64)

    return build(tsyn, ttr), build(jsyn, jtr)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scaled_close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= tol, (what, err)


OPTIONS = {
    "segment": dict(softmax_mode="segment"),
    "return_attention": dict(return_attention=True),
    "segment_return_attention": dict(softmax_mode="segment", return_attention=True),
}


@pytest.mark.parametrize("direction", ["v2e", "e2v"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_pma_option_matches_jax(option, direction):
    tinc, jinc = _incs()
    td, jd = getattr(tinc, direction)(), getattr(jinc, direction)()
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(td.num_src, F)) * 2).astype(np.float32)
    kw = OPTIONS[option]
    jm = JPMA(hid_dim=HID, out_dim=HID, num_layers=2, heads=HEADS, fold_relu=True, **kw)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jd)["params"]
    tgt = rng.normal(size=(td.num_dst, HID)).astype(np.float32)
    attn_tgt = rng.normal(size=(td.src.shape[0], HEADS)).astype(np.float32)
    attn_tgt[td.nnz:] = 0.0  # padded entries: the modes' fill differs

    def loss(out):
        if kw.get("return_attention"):
            y, a = out
            return (y * tgt).sum() + (a * attn_tgt).sum(), out
        return (out * tgt).sum(), (out, None)

    (_, (y_ref, a_ref)), (gp, gx) = jax.value_and_grad(
        lambda p, xx: loss(jm.apply({"params": p}, xx, jd)), argnums=(0, 1),
        has_aux=True)(params, jnp.asarray(x))

    tm = PMA(F, HID, HID, 2, HEADS, torch.Generator().manual_seed(0), fold_relu=True, **kw)
    tm.load_state_dict(params_from_jax(_np(params)))
    xt = torch.from_numpy(x).requires_grad_()
    _kernels.reset_launches()
    out = tm(xt, td)
    assert sum(_kernels.launches.values()) == 0
    if kw.get("return_attention"):
        y, a = out
        assert a.shape == (td.src.shape[0], HEADS)
        _scaled_close(a[: td.nnz].detach().numpy(), np.asarray(a_ref)[: td.nnz], TOL, "attn")
        total = (y * torch.from_numpy(tgt)).sum() + (a * torch.from_numpy(attn_tgt)).sum()
    else:
        y = out
        total = (y * torch.from_numpy(tgt)).sum()
    total.backward()
    _scaled_close(y.detach().numpy(), y_ref, TOL, "out")
    _scaled_close(xt.grad.numpy(), gx, TOL, "dx")
    want = params_from_jax(_np(gp))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, g in want.items():
        _scaled_close(got[k].grad.numpy(), g.numpy(), TOL, k)


def test_segment_mode_agrees_with_global_mode():
    tinc, _ = _incs()
    d = tinc.v2e()
    x = torch.from_numpy((np.random.default_rng(7).normal(size=(d.num_src, F)) * 3)
                         .astype(np.float32))
    outs = {}
    for mode in ("segment", "global"):
        m = PMA(F, HID, HID, 2, HEADS, torch.Generator().manual_seed(7), softmax_mode=mode)
        with torch.no_grad():
            outs[mode] = m(x, d).numpy()
    np.testing.assert_allclose(outs["segment"], outs["global"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["global", "segment"])
def test_attention_sums_to_one_per_destination(mode):
    tinc, _ = _incs()
    d = tinc.v2e()
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(d.num_src, F))
                         .astype(np.float32))
    m = PMA(F, HID, HID, 2, HEADS, torch.Generator().manual_seed(8), softmax_mode=mode,
            return_attention=True)
    with torch.no_grad():
        out, attn = m(x, d)
    assert out.shape == (d.num_dst, HID)
    sums = torch.zeros(d.num_dst, HEADS).index_add_(0, d.dst[: d.nnz], attn[: d.nnz])
    present = torch.unique(d.dst[: d.nnz])
    np.testing.assert_allclose(sums[present].numpy(), 1.0, rtol=1e-5)


def test_split_direction_global_attention_and_segment_refusal():
    """On the self-loop split Direction the global mode's attention covers
    the real edges (the self-loop weights are 1 and not listed), as the
    JAX module's; the segment mode refuses the split, as the JAX module
    asserts."""
    tinc, _ = _incs(self_loops=True)
    d = tinc.v2e_split()
    x = torch.randn(d.num_src, F, generator=torch.Generator().manual_seed(9))
    m = PMA(F, HID, HID, 2, HEADS, torch.Generator().manual_seed(9), return_attention=True)
    out, attn = m(x, d)
    assert out.shape == (d.num_dst_total, HID) and attn.shape == (d.src.shape[0], HEADS)
    assert torch.isfinite(attn[: d.nnz]).all()
    with pytest.raises(ValueError, match="unsplit"):
        PMA(F, HID, HID, 2, HEADS, torch.Generator().manual_seed(9),
            softmax_mode="segment")(x, d)


@pytest.mark.parametrize("option", ["segment", "return_attention"])
def test_runs_are_each_run_alone(option):
    """R runs folded (a list of generators) give run r the output and the
    attention of a one-run module with run r's parameters."""
    R = 3
    tinc, _ = _incs()
    d = tinc.v2e()
    x = torch.randn(d.num_src, F, generator=torch.Generator().manual_seed(10))
    kw = dict(OPTIONS[option], return_attention=True)
    folded = PMA(F, HID, HID, 2, HEADS, [torch.Generator().manual_seed(r) for r in range(R)],
                 **kw)
    with torch.no_grad():
        out, attn = folded(x, d)
        assert out.shape == (d.num_dst, R, HID) and attn.shape == (d.src.shape[0], R, HEADS)
        for r in range(R):
            one = PMA(F, HID, HID, 2, HEADS, torch.Generator().manual_seed(r), **kw)
            one.load_state_dict({k: v[r] for k, v in folded.state_dict().items()})
            o, a = one(x, d)
            assert torch.equal(out[:, r], o) and torch.equal(attn[:, r], a)
