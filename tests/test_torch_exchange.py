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


def test_dir_spmm_refuses_weighted_and_mean():
    tinc, _ = _incs()
    d = tinc.v2e()
    w = torch.zeros(d.num_src, F)
    for kw in (dict(norm=d.norm), dict(reduce="mean")):
        with pytest.raises(NotImplementedError):
            dir_spmm(w, d, **kw)
