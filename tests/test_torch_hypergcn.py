"""The ported HyperGCN (models/hypergcn.py) against the JAX package's:
the fast path (the Laplacian built once from the features, mediators on
and off, the citeseer widths, 3 layers) and the reapprox path (the
Laplacian rebuilt on the host from each layer's activations in every
forward), both prepared by their own ``train.factory.prepare`` from the
same tiny hypergraph of tests/conftest.py, the JAX parameters carried
across by ``params_from_jax``: logits and every parameter's gradient of
the masked NLL in evaluation mode, f32, within 2e-4.

Also: the host code (the hyperedge dict, the Laplacian's COO, the nnz
bound) and the Laplacian's Incidence equal the JAX package's exactly;
the reapprox path's structures follow default_rng(seed + layer) on the
current activations; R=3 runs folded equal each run alone, bit for bit,
dropout included; the CLI on ``--device cpu`` for both paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allset_tpu.graph.transforms as jtr
import allset_tpu.models.hypergcn as jhg
import allset_tpu.train.factory as jfactory
import allset_tpu_torch.graph.transforms as ttr
import allset_tpu_torch.models.hypergcn as thg
import allset_tpu_torch.train.factory as tfactory
from allset_tpu.train.trainer import masked_nll as jax_nll
from allset_tpu_torch.models import build_model
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.train import TrainConfig, Trainer, masked_nll
from allset_tpu_torch.utils import params_from_jax

from conftest import make_random_hyperdata

N, TOL = 40, 2e-4
MASK = np.arange(N) % 2 == 0

CASES = {
    "fast": dict(),
    "fast-no-mediators": dict(hypergcn_mediators=False),
    "fast-citeseer": dict(dname="citeseer"),
    "fast-3layers": dict(all_num_layers=3),
    "reapprox": dict(hypergcn_fast=False),
    "reapprox-no-mediators": dict(hypergcn_fast=False, hypergcn_mediators=False),
}


def _data():
    jd = make_random_hyperdata(np.random.default_rng(7), num_nodes=N, num_hyperedges=16,
                               avg_size=4, num_features=12, num_classes=3)
    td = ttr.HyperData(x=jd.x, y=jd.y, node=jd.node, edge=jd.edge, num_nodes=jd.num_nodes,
                       num_hyperedges=jd.num_hyperedges)
    return jd, td


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(over, **kw):
    return dict(dict(method="HyperGCN", dropout=0.0, bucket=64, seed=3, **over), **kw)


def _scaled_close(got, want, tol, what):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= tol, (what, err)


@pytest.fixture(scope="module", params=list(CASES))
def jax_ref(request):
    name = request.param
    jd, _ = _data()
    model, jb, _ = jfactory.prepare(jfactory.ExperimentConfig(**_cfg(CASES[name])), jd)
    params = model.init({"params": jax.random.PRNGKey(0)}, jb, False)["params"]
    logits = model.apply({"params": params}, jb, False)
    loss, grads = jax.value_and_grad(
        lambda p: jax_nll(model.apply({"params": p}, jb, False), jb.y, jnp.asarray(MASK)))(params)
    return dict(name=name, params=_np(params), logits=np.asarray(logits), loss=float(loss),
                grads=_np(grads), inc=jb.inc)


def _port(ref, runs=None, **kw):
    _, td = _data()
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(**_cfg(CASES[ref["name"]], **kw)), td,
                                "cpu")
    gen = (torch.Generator().manual_seed(0) if runs is None
           else [torch.Generator().manual_seed(r) for r in range(runs)])
    tm = build_model(mcfg, gen)
    state = params_from_jax(ref["params"])
    if runs is not None:
        state = {k: torch.stack([v] * runs) for k, v in state.items()}
    tm.load_state_dict(state)
    return tm, tb


def test_hypergcn_laplacian_incidence_is_the_jax_one(jax_ref):
    """The fast path's Laplacian Incidence (entries sorted by column, rows
    in the dict's order within a column) equals the JAX package's array
    for array; the reapprox path carries none."""
    _, tb = _port(jax_ref)
    j, t = jax_ref["inc"], tb.inc
    if jax_ref["name"].startswith("reapprox"):
        assert j is None and t is None
        return
    assert (t.num_nodes, t.num_edges, t.nnz) == (j.num_nodes, j.num_edges, j.nnz)
    for f in ("node", "edge", "mask", "node_perm", "inv_node_perm", "node_sorted",
              "edge_by_node", "node_count", "edge_count"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    np.testing.assert_array_equal(t.norm.numpy().view(np.uint32),
                                  np.asarray(j.norm).view(np.uint32))


def test_hypergcn_logits_match_jax(jax_ref):
    tm, tb = _port(jax_ref)
    _kernels.reset_launches()
    with torch.no_grad():
        got = tm(tb, False)
    assert sum(_kernels.launches.values()) == 0  # CPU tensors: plain versions
    assert got.dtype == torch.float32 and got.shape == jax_ref["logits"].shape
    np.testing.assert_allclose(got.numpy(), jax_ref["logits"], atol=TOL, rtol=TOL)


def test_hypergcn_gradients_match_jax(jax_ref):
    """Every parameter's gradient of the masked NLL (evaluation mode)
    within 2e-4 of its tensor's max |.|."""
    tm, tb = _port(jax_ref)
    want = params_from_jax(jax_ref["grads"])
    tl = masked_nll(tm(tb, False), tb.y, torch.from_numpy(MASK))
    tl.backward()
    np.testing.assert_allclose(tl.item(), jax_ref["loss"], rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, g in want.items():
        _scaled_close(got[k].grad.numpy(), g.numpy(), TOL, k)


def test_hypergcn_folded_runs_are_single_runs(jax_ref):
    """R=3 runs (different parameters per run), in training mode with
    dropout: each run's logits and gradients equal the single-run model's
    with its parameters and its generator, bit for bit (the fast path
    folds the runs into the width; the reapprox path runs them one after
    another, each on its own structures)."""
    one, tb = _port(jax_ref, dropout=0.3)
    three, _ = _port(jax_ref, runs=3, dropout=0.3)
    with torch.no_grad():
        for k, p in three.named_parameters():
            p.mul_(torch.tensor([1.0, 0.5, -0.75]).view((3,) + (1,) * (p.dim() - 1)))
    mask = torch.from_numpy(MASK)
    y3 = three(tb, True, [torch.Generator().manual_seed(10 + r) for r in range(3)])
    masked_nll(y3, tb.y, mask[:, None].expand(N, 3)).sum().backward()
    for r in range(3):
        with torch.no_grad():
            for k, p in one.named_parameters():
                p.copy_(dict(three.named_parameters())[k][r])
        one.zero_grad()
        y1 = one(tb, True, torch.Generator().manual_seed(10 + r))
        masked_nll(y1, tb.y, mask).backward()
        assert torch.equal(y3[:, r], y1), r
        for k, p in three.named_parameters():
            assert torch.equal(p.grad[r], dict(one.named_parameters())[k].grad), (r, k)


@pytest.mark.parametrize("mediators", [True, False])
def test_hypergcn_host_code_is_the_jax_one(mediators):
    """The hyperedge dict, the Laplacian's COO (rows, columns, values in
    the dict's insertion order) and the nnz bound equal the JAX package's
    exactly, from the same generator state."""
    jd, td = _data()
    je, te = jtr.hypergcn_edge_dict(jd), ttr.hypergcn_edge_dict(td)
    assert je == te and list(je) == list(te)
    X = np.random.default_rng(1).normal(size=(N, 6)).astype(np.float32)
    want = jhg._laplacian_coo(N, je, X, mediators, np.random.default_rng(5))
    got = thg._laplacian_coo(N, te, X, mediators, np.random.default_rng(5))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (thg.laplacian_nnz_bound(te, N, mediators)
            == jhg.laplacian_nnz_bound(je, N, mediators) >= got[0].shape[0])


def test_reapprox_rebuilds_each_layer_from_its_activations():
    """Each forward builds one Laplacian per layer from that layer's x W
    with default_rng(seed + layer): the structures equal the fast build
    from the same activations and seed."""
    _, td = _data()
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(**_cfg(dict(hypergcn_fast=False))), td,
                                "cpu")
    model = build_model(mcfg, torch.Generator().manual_seed(0))
    seen, orig = [], model.structure

    def record(hw, layer):
        inc = orig(hw, layer)
        seen.append((hw.detach().clone(), layer, inc))
        return inc

    model.structure = record
    with torch.no_grad():
        model(tb, False)
    assert [s[1] for s in seen] == [0, 1]
    for hw, layer, inc in seen:
        ref = thg.build_hypergcn_laplacian(N, mcfg.edge_dict, hw.numpy(), mcfg.mediators,
                                           seed=mcfg.seed + layer)
        for f in ("node", "edge", "norm"):
            np.testing.assert_array_equal(getattr(inc, f).numpy()[: inc.nnz],
                                          getattr(ref, f).numpy()[: ref.nnz])
    assert model.host_seconds > 0


@pytest.mark.parametrize("fast", ["true", "false"])
def test_hypergcn_cli_runs_on_cpu(fast, tmp_path):
    """A 2-run x 2-epoch CLI run on --device cpu: finite metrics, the JAX
    model's parameter count, the accuracies of the runs one by one."""
    from allset_tpu_torch import cli

    flags = ["--device", "cpu", "--dname", "synthetic", "--epochs", "2", "--runs", "2",
             "--res_root", str(tmp_path), "--method", "HyperGCN", "--HyperGCN_fast", fast]
    res = cli.run(flags)
    assert res.metrics.shape == (2, 2, 6) and np.isfinite(res.metrics).all()
    seq = cli.run(flags + ["--no_vmap_runs"])
    assert res.groups == [2] and seq.groups == [1, 1]
    np.testing.assert_array_equal(res.metrics[..., :3], seq.metrics[..., :3])
    np.testing.assert_allclose(res.metrics[..., 3:], seq.metrics[..., 3:], rtol=1e-6)
    jd, td = _data()
    over = _cfg(dict(hypergcn_fast=fast == "true"))
    model, jb, _ = jfactory.prepare(jfactory.ExperimentConfig(**over), jd)
    shapes = jax.eval_shape(lambda k: model.init({"params": k}, jb, False),
                            jax.random.PRNGKey(0))["params"]
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(**over), td, "cpu")
    assert sum(p.numel() for p in build_model(mcfg, torch.Generator()).parameters()) == want
    assert Trainer(mcfg, tb, TrainConfig())._bytes_per_run() > 0


def test_hypergcn_widths_are_the_jax_ones():
    for dname in ("", "citeseer"):
        for layers in (1, 2, 3):
            kw = dict(num_features=12, num_classes=3, all_num_layers=layers, dname=dname)
            assert thg.HyperGCNConfig(**kw).widths() == jhg.HyperGCNConfig(**kw).widths()
