"""The ported conv zoo (HCHA, HGNN, HNHN, UniGNN with each of its five
convs, UniGCNII, MLP; models/hcha.py, hnhn.py, unignn.py, legacy_hgnn.py)
against the JAX package's models: both prepared by their own
``train.factory.prepare`` from the same tiny hypergraph of
tests/conftest.py, the JAX parameters carried across by
``params_from_jax``, then the logits and every parameter's gradient of
the masked NLL, in f32, within 2e-4 (the SetGNN parity tolerance).

Also: R=3 runs folded into the width equal each run alone, bit for bit;
HypergraphConv's attention path, UniGNN with a PReLU and the legacy
dense-G HGNN against the JAX modules; ``prepare`` and the CLI on ``--device cpu`` for every
ported method; CEGCN, CEGAT and HyperGCN, which raised before their
port, prepare (their parity: tests/test_torch_cegnn.py and
test_torch_hypergcn.py), and CE's batch norm names its ROADMAP item."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allset_tpu.graph.transforms as jtr
import allset_tpu.train.factory as jfactory
import allset_tpu_torch.graph.transforms as ttr
import allset_tpu_torch.train.factory as tfactory
from allset_tpu.graph.batch import Batch as JBatch
from allset_tpu.train.trainer import masked_nll as jax_nll
from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.models import build_model
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.train import masked_nll
from allset_tpu_torch.utils import params_from_jax

from conftest import make_random_hyperdata

N, TOL = 40, 2e-4
MASK = np.arange(N) % 2 == 0

# method -> ExperimentConfig overrides (both packages take the same names)
METHODS = {
    "HCHA": dict(method="HCHA"),
    "HGNN": dict(method="HGNN"),
    "HNHN": dict(method="HNHN"),
    "UniGCNII": dict(method="UniGCNII"),
    "MLP": dict(method="MLP"),
    "UniGAT": dict(method="UniGNN", unignn_model_name="UniGAT", heads=2),
    "UniGCN": dict(method="UniGNN", unignn_model_name="UniGCN"),
    "UniGCN2": dict(method="UniGNN", unignn_model_name="UniGCN2"),
    "UniGIN": dict(method="UniGNN", unignn_model_name="UniGIN"),
    "UniSAGE": dict(method="UniGNN", unignn_model_name="UniSAGE"),
}


def _data():
    """The tiny graph, as the JAX and the port's HyperData."""
    jd = make_random_hyperdata(np.random.default_rng(7), num_nodes=N, num_hyperedges=16,
                               avg_size=4, num_features=12, num_classes=3)
    td = ttr.HyperData(x=jd.x, y=jd.y, node=jd.node, edge=jd.edge, num_nodes=jd.num_nodes,
                       num_hyperedges=jd.num_hyperedges)
    return jd, td


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(over, **kw):
    return dict(dict(mlp_hidden=16, dropout=0.0, bucket=64, **over), **kw)


@pytest.fixture(scope="module", params=list(METHODS))
def jax_ref(request):
    """The JAX model's parameters, logits, loss and gradients."""
    name = request.param
    jd, _ = _data()
    model, jb, _ = jfactory.prepare(jfactory.ExperimentConfig(**_cfg(METHODS[name])), jd)
    params = model.init({"params": jax.random.PRNGKey(0)}, jb, False)["params"]
    logits = model.apply({"params": params}, jb, False)
    loss, grads = jax.value_and_grad(
        lambda p: jax_nll(model.apply({"params": p}, jb, False), jb.y, jnp.asarray(MASK)))(params)
    return dict(name=name, params=_np(params), logits=np.asarray(logits), loss=float(loss),
                grads=_np(grads))


def _port(ref, runs=None):
    _, td = _data()
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(**_cfg(METHODS[ref["name"]])), td,
                                "cpu")
    gen = (torch.Generator().manual_seed(0) if runs is None
           else [torch.Generator().manual_seed(r) for r in range(runs)])
    tm = build_model(mcfg, gen)
    state = params_from_jax(ref["params"])
    if runs is not None:
        state = {k: torch.stack([v] * runs) for k, v in state.items()}
    tm.load_state_dict(state)
    return tm, tb


def _scaled_close(got, want, tol, what):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= tol, (what, err)


def test_zoo_logits_match_jax(jax_ref):
    tm, tb = _port(jax_ref)
    _kernels.reset_launches()
    with torch.no_grad():
        got = tm(tb, False)
    assert sum(_kernels.launches.values()) == 0  # CPU tensors: plain versions
    assert got.dtype == torch.float32 and got.shape == jax_ref["logits"].shape
    np.testing.assert_allclose(got.numpy(), jax_ref["logits"], atol=TOL, rtol=TOL)


def test_zoo_gradients_match_jax(jax_ref):
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


def test_zoo_folded_runs_are_single_runs(jax_ref):
    """R=3 runs folded (different parameters per run): each run's logits
    and gradients equal the single-run model's with its parameters, bit for
    bit."""
    one, tb = _port(jax_ref)
    three, _ = _port(jax_ref, runs=3)
    with torch.no_grad():
        for k, p in three.named_parameters():
            p.mul_(torch.tensor([1.0, 0.5, -0.75]).view((3,) + (1,) * (p.dim() - 1)))
    mask = torch.from_numpy(MASK)
    y3 = three(tb, False)
    masked_nll(y3, tb.y, mask[:, None].expand(N, 3)).sum().backward()
    assert y3.shape == (N, 3, jax_ref["logits"].shape[1])
    for r in range(3):
        with torch.no_grad():
            for k, p in one.named_parameters():
                p.copy_(dict(three.named_parameters())[k][r])
        one.zero_grad()
        y1 = one(tb, False)
        masked_nll(y1, tb.y, mask).backward()
        assert torch.equal(y3[:, r], y1), r
        for k, p in three.named_parameters():
            assert torch.equal(p.grad[r], dict(one.named_parameters())[k].grad), (r, k)


def test_hypergraph_conv_attention_matches_jax():
    """HypergraphConv's attention path (the JAX module has it, the CLI does
    not reach it): 2 heads, concatenated, on the self-loop graph; output
    and gradients within 2e-4."""
    from allset_tpu.models.hcha import HypergraphConv as JConv
    from allset_tpu_torch.models.hcha import HypergraphConv

    jd, td = _data()
    jb = JBatch.from_hyperdata(jtr.add_self_loops(jd), bucket=64)
    tb = Batch.from_hyperdata(ttr.add_self_loops(td), device="cpu", bucket=64)
    conv = JConv(out_channels=5, use_attention=True, heads=2, dropout=0.0)
    params = conv.init({"params": jax.random.PRNGKey(2)}, jb.x, jb)["params"]
    tgt = np.random.default_rng(3).normal(size=(N, 10)).astype(np.float32)

    def loss(p):
        return ((conv.apply({"params": p}, jb.x, jb) - tgt) ** 2).mean()

    y_ref = conv.apply({"params": params}, jb.x, jb)
    g_ref = params_from_jax(_np(jax.grad(loss)(params)))
    tc = HypergraphConv(12, 5, torch.Generator().manual_seed(0), use_attention=True, heads=2)
    tc.load_state_dict(params_from_jax(_np(params)))
    y = tc(tb.x, tb)
    ((y - torch.from_numpy(tgt)) ** 2).mean().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=TOL, rtol=TOL)
    for k, p in tc.named_parameters():
        _scaled_close(p.grad.numpy(), g_ref[k].numpy(), TOL, k)


def test_legacy_hgnn_matches_jax():
    """The dense-G HGNN with G from generate_g_from_h: logits within 2e-4."""
    from allset_tpu.models.legacy_hgnn import LegacyHGNN as JHGNN
    from allset_tpu.models.legacy_hgnn import LegacyHGNNConfig as JCfg
    from allset_tpu_torch.models import LegacyHGNN, LegacyHGNNConfig

    jd, td = _data()
    jd.extras["G"] = jtr.generate_g_from_h(jtr.construct_h_dense(jd))
    td.extras["G"] = ttr.generate_g_from_h(ttr.construct_h_dense(td))
    np.testing.assert_array_equal(td.extras["G"], jd.extras["G"])
    jb = JBatch.from_hyperdata(jd, bucket=64)
    tb = Batch.from_hyperdata(td, device="cpu", bucket=64)
    jm = JHGNN(JCfg(num_features=12, num_classes=3, mlp_hidden=16))
    params = jm.init({"params": jax.random.PRNGKey(4)}, jb, False)["params"]
    tm = LegacyHGNN(LegacyHGNNConfig(num_features=12, num_classes=3, mlp_hidden=16),
                    torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(_np(params)))
    with torch.no_grad():
        got = tm(tb, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": params}, jb, False)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(METHODS))
def test_prepare_and_cli_run_every_zoo_method_on_cpu(name, tmp_path):
    """prepare on the CPU and a 2-run x 2-epoch CLI run: finite metrics and
    the JAX model's parameter count."""
    from allset_tpu_torch import cli

    over = METHODS[name]
    flags = ["--method", over["method"]]
    if "unignn_model_name" in over:
        flags += ["--UniGNN_model_name", over["unignn_model_name"]]
    if "heads" in over:
        flags += ["--heads", str(over["heads"])]
    jd, td = _data()
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(**_cfg(over)), td, "cpu")
    assert tb.x.device.type == "cpu" and (tb.inc is None) == (name == "MLP")
    res = cli.run(["--device", "cpu", "--dname", "synthetic", "--epochs", "2", "--runs", "2",
                   "--MLP_hidden", "16", "--res_root", str(tmp_path), *flags])
    assert res.metrics.shape == (2, 2, 6) and np.isfinite(res.metrics).all()
    model, jb, _ = jfactory.prepare(jfactory.ExperimentConfig(**_cfg(over)), jd)
    shapes = jax.eval_shape(lambda k: model.init({"params": k}, jb, False),
                            jax.random.PRNGKey(0))["params"]
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    got = sum(p.numel() for p in build_model(mcfg, torch.Generator()).parameters())
    assert got == want


@pytest.mark.parametrize("method", ["CEGCN", "CEGAT", "HyperGCN"])
def test_unported_methods_name_their_roadmap_item(method):
    """The three methods that raised until the CE and HyperGCN models were
    ported now prepare and build; CEGCN's and CEGAT's batch norm, which
    raised naming its ROADMAP item, builds too."""
    _, td = _data()
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(method=method), td, "cpu")
    assert tb.x.device.type == "cpu" and tb.inc is not None
    assert sum(p.numel() for p in build_model(mcfg, torch.Generator()).parameters()) > 0
    if method == "HyperGCN":
        return
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(method=method, normalization="bn"),
                                td, "cpu")
    model = build_model(mcfg, torch.Generator())
    assert "bn0.mean" in model.state_dict()
    assert torch.isfinite(model(tb, True, torch.Generator())).all()


def test_unigcnii_optimizer_has_the_reference_groups():
    """UniGCNII's two Adam groups: convs weight decay 0.01, lin_in/lin_out
    5e-4, both at lr 0.01; coupled L2, as the JAX unigcnii_optimizer."""
    _, td = _data()
    mcfg, _ = tfactory.prepare(tfactory.ExperimentConfig(method="UniGCNII", mlp_hidden=16), td,
                               "cpu")
    model = build_model(mcfg, torch.Generator().manual_seed(0))
    opt = tfactory.make_optimizer(model, 1e-3, 0.0)
    names = {id(p): n for n, p in model.named_parameters()}
    groups = [(g["weight_decay"], g["lr"], sorted(names[id(p)].split(".")[0] for p in g["params"]))
              for g in opt.param_groups]
    assert groups[0][:2] == (0.01, 0.01) and set(groups[0][2]) == {"conv0", "conv1"}
    assert groups[1][:2] == (5e-4, 0.01) and set(groups[1][2]) == {"lin_in", "lin_out"}
    assert dataclasses.is_dataclass(mcfg)


def test_unignn_prelu_activation_matches_jax():
    """UniGNN with a PReLU between convs (flax ``PReLU_0``, one learned
    slope, 0.01 at init; the CLI does not reach it): logits and gradients
    within 2e-4, the slope's gradient included."""
    from allset_tpu.models.unignn import UniGNN as JUniGNN
    from allset_tpu.models.unignn import UniGNNConfig as JCfg
    from allset_tpu_torch.models import UniGNN, UniGNNConfig

    jd, td = _data()
    over = dict(num_features=12, num_classes=3, model_name="UniGCN", mlp_hidden=16, heads=1,
                dropout=0.0, activation="prelu")
    _, jb, _ = jfactory.prepare(jfactory.ExperimentConfig(method="UniGNN", **_cfg({})), jd)
    _, tb = tfactory.prepare(tfactory.ExperimentConfig(method="UniGNN", **_cfg({})), td, "cpu")
    jm = JUniGNN(JCfg(**over))
    params = jm.init({"params": jax.random.PRNGKey(5)}, jb, False)["params"]
    loss, grads = jax.value_and_grad(
        lambda p: jax_nll(jm.apply({"params": p}, jb, False), jb.y, jnp.asarray(MASK)))(params)
    tm = UniGNN(UniGNNConfig(**over), torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(_np(params)))
    tl = masked_nll(tm(tb, False), tb.y, torch.from_numpy(MASK))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-5)
    want = params_from_jax(_np(grads))
    assert "PReLU_0.negative_slope" in want
    for k, p in tm.named_parameters():
        _scaled_close(p.grad.numpy(), want[k].numpy(), TOL, k)


@pytest.mark.parametrize("conv", ["UniGIN", "UniSAGE"])
def test_unignn_without_norm_trains_as_the_jax_model_on_a_hub(conv):
    """UniGIN and UniSAGE without --UniGNN_use_norm on a scale-free graph
    whose hub (node 0) lies in nearly every hyperedge, as the bench graph's
    does: the hub's sum puts the logits in the hundreds, and over 8 Adam
    steps at lr 1e-3 the loss (tens of times ln 8) swings up by a quarter
    of its start or more. The JAX model, from the same parameters and with
    the JAX trainer's Adam, reads the same losses step by step (f32, within
    2e-4 of their scale), so the trajectory is the model's, not the
    port's."""
    from allset_tpu.train.trainer import torch_adam
    from allset_tpu_torch.data import scale_free_hypergraph
    from allset_tpu_torch.train import train_steps

    td = scale_free_hypergraph(num_nodes=1024, num_hyperedges=512, avg_edge_size=12,
                               feature_dim=256, num_classes=8, seed=0)
    jd = jtr.HyperData(x=td.x, y=td.y, node=td.node, edge=td.edge, num_nodes=td.num_nodes,
                       num_hyperedges=td.num_hyperedges)
    over = _cfg(dict(method="UniGNN", unignn_model_name=conv), mlp_hidden=256)
    model, jb, _ = jfactory.prepare(jfactory.ExperimentConfig(**over), jd)
    params = model.init({"params": jax.random.PRNGKey(0)}, jb, False)["params"]
    start = params_from_jax(_np(params))
    mask = np.arange(td.num_nodes) % 2 == 0
    tx = torch_adam(1e-3, 0.0)
    state = tx.init(params)
    step = jax.jit(jax.value_and_grad(
        lambda p: jax_nll(model.apply({"params": p}, jb, False), jb.y, jnp.asarray(mask))))
    want = []
    for _ in range(8):
        loss, grads = step(params)
        updates, state = tx.update(grads, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        want.append(float(loss))
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(**over), td, "cpu")
    tm = build_model(mcfg, torch.Generator().manual_seed(0))
    tm.load_state_dict(start)
    got = train_steps(tm, tb, torch.from_numpy(mask), 8).numpy()
    _scaled_close(got, np.asarray(want), TOL, "losses")
    assert want[0] > 10 * np.log(8) and np.diff(want).max() > 0.25 * want[0]
