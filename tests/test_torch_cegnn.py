"""The ported clique-expansion models (models/cegnn.py: CEGCN, CEGAT)
against the JAX package's: both prepared by their own
``train.factory.prepare`` from the same tiny hypergraph of
tests/conftest.py, the JAX parameters carried across by
``params_from_jax``, then the logits and every parameter's gradient of
the masked NLL, in f32, within 2e-4 (the zoo's tolerance). CEGAT at 1 and
4 heads, with 1 and 2 output heads.

Also: the port's V2V graph (construct_v2v, gcn_norm, the self-loops, the
Incidence) equals the JAX package's array for array; R=3 runs folded
equal each run alone, bit for bit, dropout included; the CLI on
``--device cpu``; ``--normalization bn`` builds a BatchNorm between convs;
GATConv's dropout defaults to 0.6; the trainer's per-run estimate grows
with the heads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allset_tpu.graph.transforms as jtr
import allset_tpu.train.factory as jfactory
import allset_tpu_torch.graph.transforms as ttr
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
    "CEGCN": dict(method="CEGCN"),
    "CEGAT": dict(method="CEGAT"),
    "CEGAT-h4": dict(method="CEGAT", heads=4),
    "CEGAT-h4-o2": dict(method="CEGAT", heads=4, output_heads=2),
    "CEGAT-h1-o2": dict(method="CEGAT", output_heads=2),
    "CEGCN-3layers": dict(method="CEGCN", all_num_layers=3),
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
    return dict(dict(mlp_hidden=8, dropout=0.0, bucket=64, **over), **kw)


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


def _port(ref, runs=None):
    _, td = _data()
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(**_cfg(CASES[ref["name"]])), td, "cpu")
    gen = (torch.Generator().manual_seed(0) if runs is None
           else [torch.Generator().manual_seed(r) for r in range(runs)])
    tm = build_model(mcfg, gen)
    state = params_from_jax(ref["params"])
    if runs is not None:
        state = {k: torch.stack([v] * runs) for k, v in state.items()}
    tm.load_state_dict(state)
    return tm, tb


def test_ce_v2v_incidence_is_the_jax_one(jax_ref):
    """Every index array, the norm, the mask and the sizes of the V2V
    Incidence equal the JAX package's exactly."""
    _, tb = _port(jax_ref)
    j, t = jax_ref["inc"], tb.inc
    assert (t.num_nodes, t.num_edges, t.nnz) == (j.num_nodes, j.num_edges, j.nnz)
    for f in ("node", "edge", "mask", "node_perm", "inv_node_perm", "node_sorted",
              "edge_by_node", "node_count", "edge_count"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    np.testing.assert_array_equal(t.norm.numpy().view(np.uint32),
                                  np.asarray(j.norm).view(np.uint32))


def test_ce_logits_match_jax(jax_ref):
    tm, tb = _port(jax_ref)
    _kernels.reset_launches()
    with torch.no_grad():
        got = tm(tb, False)
    assert sum(_kernels.launches.values()) == 0  # CPU tensors: plain versions
    assert got.dtype == torch.float32 and got.shape == jax_ref["logits"].shape
    np.testing.assert_allclose(got.numpy(), jax_ref["logits"], atol=TOL, rtol=TOL)


def test_ce_gradients_match_jax(jax_ref):
    """Every parameter's gradient of the masked NLL within 2e-4 of its
    tensor's max |.|."""
    tm, tb = _port(jax_ref)
    want = params_from_jax(jax_ref["grads"])
    tl = masked_nll(tm(tb, False), tb.y, torch.from_numpy(MASK))
    tl.backward()
    np.testing.assert_allclose(tl.item(), jax_ref["loss"], rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, g in want.items():
        _scaled_close(got[k].grad.numpy(), g.numpy(), TOL, k)


def test_ce_folded_runs_are_single_runs(jax_ref):
    """R=3 runs folded (different parameters per run), in training mode
    with dropout and attention dropout: each run's logits and gradients
    equal the single-run model's with its parameters and its generator,
    bit for bit."""
    one, tb = _port(jax_ref)
    three, _ = _port(jax_ref, runs=3)
    with torch.no_grad():
        for k, p in three.named_parameters():
            p.mul_(torch.tensor([1.0, 0.5, -0.75]).view((3,) + (1,) * (p.dim() - 1)))
    over = dict(dropout=0.3)
    three.cfg = one.cfg = type(one.cfg)(**{**one.cfg.__dict__, **over})
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


def test_v2v_transforms_match_jax():
    """construct_v2v (the native expansion's order), gcn_norm with and
    without self-loops, bit for bit; the python expansion, where the
    library is absent, gives the same pairs and weights in its own
    order."""
    from allset_tpu_torch.graph import native

    jd, td = _data()
    jp, jw = jtr.construct_v2v(jd)
    tp, tw = ttr.construct_v2v(td)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tw, jw)
    assert (tp[0] < tp[1]).all()  # each pair once, i<j: not symmetrised
    for loops in (True, False):
        (je, jn), (te, tn) = (jtr.gcn_norm(jp, jw, N, add_self_loops=loops),
                              ttr.gcn_norm(tp, tw, N, add_self_loops=loops))
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tn.view(np.uint32), jn.view(np.uint32))
    lib, tried = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        pp, pw = ttr.construct_v2v(td)
    finally:
        native._lib, native._tried = lib, tried
    got = sorted(zip(pp[0].tolist(), pp[1].tolist(), pw.tolist()))
    assert got == sorted(zip(tp[0].tolist(), tp[1].tolist(), tw.tolist()))


@pytest.mark.parametrize("method", ["CEGCN", "CEGAT"])
def test_ce_cli_runs_on_cpu(method, tmp_path):
    """A 2-run x 2-epoch CLI run on --device cpu: finite metrics and the
    JAX model's parameter count; folded runs give the accuracies of the
    runs one by one."""
    from allset_tpu_torch import cli

    flags = ["--device", "cpu", "--dname", "synthetic", "--epochs", "2", "--runs", "2",
             "--MLP_hidden", "8", "--res_root", str(tmp_path), "--method", method]
    if method == "CEGAT":
        flags += ["--heads", "2", "--output_heads", "2"]
    res = cli.run(flags)
    assert res.metrics.shape == (2, 2, 6) and np.isfinite(res.metrics).all()
    seq = cli.run(flags + ["--no_vmap_runs"])
    assert res.groups == [2] and seq.groups == [1, 1]
    # the accuracies bit for bit; the losses are means over [N, R] against
    # [N]: the same terms, summed in another shape
    np.testing.assert_array_equal(res.metrics[..., :3], seq.metrics[..., :3])
    np.testing.assert_allclose(res.metrics[..., 3:], seq.metrics[..., 3:], rtol=1e-6)
    jd, td = _data()
    over = _cfg(dict(method=method, heads=2, output_heads=2))
    model, jb, _ = jfactory.prepare(jfactory.ExperimentConfig(**over), jd)
    shapes = jax.eval_shape(lambda k: model.init({"params": k}, jb, False),
                            jax.random.PRNGKey(0))["params"]
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    mcfg, _ = tfactory.prepare(tfactory.ExperimentConfig(**over), td, "cpu")
    assert sum(p.numel() for p in build_model(mcfg, torch.Generator()).parameters()) == want


@pytest.mark.parametrize("method", ["CEGCN", "CEGAT"])
def test_ce_batchnorm_names_its_roadmap_item(method):
    """The batch norm that raised naming its ROADMAP item (Queue 1 item 13)
    is ported: --normalization bn gives the JAX model's bn{i} between
    convs, flax names (tests/test_torch_batchnorm.py holds the values)."""
    _, td = _data()
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(method=method, normalization="bn"),
                                td, "cpu")
    state = build_model(mcfg, torch.Generator()).state_dict()
    assert {k for k in state if k.startswith("bn")} == {"bn0.scale", "bn0.bias", "bn0.mean",
                                                       "bn0.var"}


def test_gat_attention_dropout_is_its_own():
    """GATConv drops attention at 0.6 whatever the model's dropout, as the
    JAX GATConv: with the model's dropout at 0 a training forward still
    differs from the evaluation forward, and the JAX module's default is
    the same."""
    from allset_tpu.models.cegnn import GATConv as JGAT
    from allset_tpu_torch.models import GATConv

    assert JGAT(out_channels=2).dropout == 0.6
    conv = GATConv(12, 4, torch.Generator().manual_seed(0), heads=2)
    assert conv.p == 0.6
    _, td = _data()
    _, tb = tfactory.prepare(tfactory.ExperimentConfig(method="CEGAT", dropout=0.0), td, "cpu")
    with torch.no_grad():
        ev = conv(tb.x, tb, False)
        tr = conv(tb.x, tb, True, torch.Generator().manual_seed(1))
    assert not torch.equal(ev, tr)


def test_trainer_estimate_covers_the_ce_models():
    """The per-run estimate is positive for CEGCN and CEGAT and grows with
    CEGAT's heads (its [nnz, heads * hidden] tables)."""
    _, td = _data()
    est = {}
    for name, over in (("gcn", dict(method="CEGCN")), ("gat1", dict(method="CEGAT")),
                       ("gat4", dict(method="CEGAT", heads=4))):
        mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(**_cfg(over)), td, "cpu")
        est[name] = Trainer(mcfg, tb, TrainConfig())._bytes_per_run()
    assert 0 < est["gcn"] < est["gat1"] < est["gat4"]
