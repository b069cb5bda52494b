"""dir_spmm (gather -> K1, backward gather -> K1) against the JAX
package's fused exchange on the same incidence: values and vjp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allset_tpu.data.synthetic as jsyn
import allset_tpu.graph.transforms as jtr
import allset_tpu_torch.data.synthetic as tsyn
import allset_tpu_torch.graph.transforms as ttr
from allset_tpu.ops.exchange import dir_spmm as jax_spmm
from allset_tpu_torch.ops.exchange import dir_spmm

F = 8
DIRS = ["v2e", "e2v", "v2e_split", "e2v_split"]


def _incs():
    def build(syn, tr):
        hd = syn.scale_free_hypergraph(num_nodes=300, num_hyperedges=150,
                                       avg_edge_size=5, feature_dim=4, seed=5)
        return tr.norm_construction(tr.add_self_loops(hd), "all_one").to_incidence(bucket=64)

    return build(tsyn, ttr), build(jsyn, jtr)


@pytest.mark.parametrize("direction", DIRS)
def test_dir_spmm_matches_jax(direction):
    tinc, jinc = _incs()
    td, jd = getattr(tinc, direction)(), getattr(jinc, direction)()
    rows = td.num_src + (tinc.num_nodes if direction == "e2v_split" else 0)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(rows, F)).astype(np.float32)
    out_ref, vjp = jax.vjp(lambda x: jax_spmm(x, jd), jnp.asarray(w))
    g = rng.normal(size=out_ref.shape).astype(np.float32)
    (dw_ref,) = vjp(jnp.asarray(g))

    wt = torch.from_numpy(w).requires_grad_()
    out = dir_spmm(wt, td)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_ref), rtol=1e-5, atol=1e-5)


def _weighted_incs(self_loops):
    """deg_half_sym norms (a non-trivial d.norm); without self-loops some
    nodes hold no entry, so E->V has empty segments."""
    def build(syn, tr):
        hd = syn.scale_free_hypergraph(num_nodes=300, num_hyperedges=150,
                                       avg_edge_size=5, feature_dim=4, seed=5)
        if self_loops:
            hd = tr.add_self_loops(hd)
        return tr.norm_construction(hd, "deg_half_sym").to_incidence(bucket=64)

    return build(tsyn, ttr), build(jsyn, jtr)


CASES = [(d, True) for d in DIRS] + [(d, False) for d in ("v2e", "e2v")]


@pytest.mark.parametrize("reduce", ["add", "mean", "max"])
@pytest.mark.parametrize("direction,self_loops", CASES)
def test_weighted_dir_spmm_matches_jax(direction, self_loops, reduce):
    """norm = the Direction's own entry norm, for each reduce; the values
    are small integers, so 'max' meets ties (each package splits a tie's
    gradient evenly) and, without self-loops, empty segments (0)."""
    tinc, jinc = _weighted_incs(self_loops)
    td, jd = getattr(tinc, direction)(), getattr(jinc, direction)()
    np.testing.assert_array_equal(td.norm.numpy(), np.asarray(jd.norm))
    rows = td.num_src + (tinc.num_nodes if direction == "e2v_split" else 0)
    rng = np.random.default_rng(1)
    w = rng.integers(-3, 4, size=(rows, F)).astype(np.float32)
    out_ref, vjp = jax.vjp(lambda x: jax_spmm(x, jd, norm=jd.norm, reduce=reduce),
                           jnp.asarray(w))
    g = rng.normal(size=out_ref.shape).astype(np.float32)
    (dw_ref,) = vjp(jnp.asarray(g))

    wt = torch.from_numpy(w).requires_grad_()
    out = dir_spmm(wt, td, norm=td.norm, reduce=reduce)
    out.backward(torch.from_numpy(g))
    if reduce == "max" and not self_loops and direction == "e2v":
        empty = tinc.node_count == 0
        assert empty.any() and not out[empty].any()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("runs", [None, 2])
@pytest.mark.parametrize("direction", ["v2e", "e2v"])
def test_dnorm_matches_jax(direction, runs):
    """LearnMask's weighted reduce: a traced norm (not the Direction's)
    with its gradient, the SDDMM dnorm, zero at the padded entries; with
    a runs axis [R, nnz_pad] on a table of R runs folded into the width,
    against the JAX reduce run by run."""
    tinc, jinc = _incs()
    td, jd = getattr(tinc, direction)(), getattr(jinc, direction)()
    R = runs or 1
    rng = np.random.default_rng(2)
    canon = rng.uniform(0.5, 1.5, size=(R, tinc.nnz_padded)).astype(np.float32)
    canon[:, tinc.nnz:] = 0.0
    perm = tinc.node_perm.numpy()
    n = canon if direction == "v2e" else canon[:, perm]  # execution order
    w = rng.normal(size=(td.num_src, R * F)).astype(np.float32)
    g = rng.normal(size=(td.num_dst, R * F)).astype(np.float32)
    want_out, want_dw, want_dn = [], [], []
    for r in range(R):
        out_r, vjp = jax.vjp(lambda x, nn: jax_spmm(x, jd, norm=nn, norm_grad=True),
                             jnp.asarray(w[:, r * F:(r + 1) * F]), jnp.asarray(n[r]))
        dw_r, dn_r = vjp(jnp.asarray(g[:, r * F:(r + 1) * F]))
        want_out.append(np.asarray(out_r))
        want_dw.append(np.asarray(dw_r))
        want_dn.append(np.asarray(dn_r))

    wt = torch.from_numpy(w).requires_grad_()
    nt = torch.from_numpy(n if runs else n[0]).requires_grad_()
    out = dir_spmm(wt, td, norm=nt, norm_grad=True)
    out.backward(torch.from_numpy(g))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.concatenate(want_out, 1), **tol)
    np.testing.assert_allclose(wt.grad.numpy(), np.concatenate(want_dw, 1), **tol)
    dn = nt.grad.numpy().reshape(R, -1)
    np.testing.assert_allclose(dn, np.stack(want_dn), **tol)
    assert not dn[:, tinc.nnz:].any()


def test_constant_norm_has_no_gradient():
    """Without norm_grad the weights are a constant, as the JAX
    package's stop_gradient makes them."""
    tinc, _ = _incs()
    d = tinc.v2e()
    n = d.norm.clone().requires_grad_()
    w = torch.randn(d.num_src, F, requires_grad=True)
    dir_spmm(w, d, norm=n).sum().backward()
    assert n.grad is None and w.grad is not None
