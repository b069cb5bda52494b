"""Batch norm with batch statistics ('bn') in the port against the JAX
package's flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5).

NormLayer('bn') alone, in training (batch statistics, the running ones
updated) and evaluation (the running ones), in f32 and bf16, one run and R
runs folded, with an input per run and one shared by the runs: outputs,
the updated running statistics and the gradients within 1e-5 of flax's.

The models with 'bn', prepared by each package's ``train.factory.prepare``
from the same tiny hypergraph, the JAX parameters and ``batch_stats``
carried across by ``params_from_jax``: AllSetTransformer and AllDeepSets
(SetGNN, which takes the unsplit exchange under 'bn'), CEGCN and CEGAT.
Logits, gradients and the updated running statistics within 2e-4 (f32),
in training and evaluation. The graph has hyperedges with no member and
nodes in no hyperedge but their self-loop, and its incidence is padded,
so empty segments and padded entries meet the statistics in both
packages. SetGNN's training forward is taken with GPR, whose path has no
fixed input dropout; CEGAT's attention dropout is switched off on both
sides (its masks come from different generators)."""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allset_tpu.train.factory as jfactory
import allset_tpu_torch.graph.transforms as ttr
import allset_tpu_torch.train.factory as tfactory
from allset_tpu.nn.modules import NormLayer as JNorm
from allset_tpu.train.trainer import masked_nll as jax_nll
from allset_tpu_torch.models import build_model
from allset_tpu_torch.nn.modules import NormLayer
from allset_tpu_torch.train import masked_nll
from allset_tpu_torch.utils import params_from_jax

from conftest import make_random_hyperdata

ROWS, F, R = 37, 16, 3
BN_TOL = 1e-5
MODEL_TOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol, (what, err)


def _scaled_close(got, want, tol, what):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()
    assert err / max(np.abs(np.asarray(want, np.float32)).max(), 1e-6) <= tol, (what, err)


# --- NormLayer('bn') alone ---------------------------------------------------


def _jax_bn(x, dtype, runs, shared, train):
    """flax through the JAX NormLayer: (y, updated batch_stats, dparams,
    dx) of sum(y * g), vmapped over R runs' parameters and statistics
    (x's axis 1, or x shared) as the JAX trainer vmaps the runs."""
    jm = JNorm("bn", dtype=dtype)
    xj = jnp.asarray(x)
    x0 = xj if (runs is None or shared) else xj[:, 0]
    v = jm.init(jax.random.PRNGKey(0), x0, False)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=((runs,) if runs else ()) + a.shape)
                              .astype(np.float32)) + a, v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, size=((runs,) if runs else ()) + a.shape)
                              .astype(np.float32)), v["batch_stats"])

    def one(p, s, xx):
        if train:
            y, upd = jm.apply({"params": p, "batch_stats": s}, xx, True,
                              mutable=["batch_stats"])
            return y, upd["batch_stats"]
        return jm.apply({"params": p, "batch_stats": s}, xx, False), s

    if runs is not None:
        fn = jax.vmap(one, in_axes=(0, 0, None if shared else 1), out_axes=(1, 0))
    else:
        fn = one
    y, new_stats = fn(params, stats, xj)
    g = rng.normal(size=y.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, xx: fn(p, stats, xx)[0].astype(jnp.float32), params, xj)
    dp, dx = vjp(jnp.asarray(g))
    return dict(params=_np(params), stats=_np(stats), y=np.asarray(y, np.float32),
                y_dtype=y.dtype, new_stats=_np(new_stats), g=g, dp=_np(dp),
                dx=np.asarray(dx))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("runs,shared", [(None, False), (R, False), (R, True)],
                         ids=["one_run", "runs", "shared_input"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_layer_bn_matches_flax(dtype, runs, shared, train):
    rng = np.random.default_rng(1)
    shape = (ROWS, F) if runs is None or shared else (ROWS, runs, F)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    ref = _jax_bn(x, jdt, runs, shared, train)

    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    tm = NormLayer("bn", F, () if runs is None else (runs,), dtype=tdt)
    tm.load_state_dict(params_from_jax(ref["params"], batch_stats=ref["stats"]))
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt, train)
    (y.float() * torch.from_numpy(ref["g"])).sum().backward()
    assert y.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert str(ref["y_dtype"]) == dtype
    _close(y.detach().float().numpy(), ref["y"], BN_TOL, "y")
    bn = tm.BatchNorm_0
    _close(bn.mean.numpy(), ref["new_stats"]["BatchNorm_0"]["mean"], BN_TOL, "mean")
    _close(bn.var.numpy(), ref["new_stats"]["BatchNorm_0"]["var"], BN_TOL, "var")
    _close(xt.grad.numpy(), ref["dx"], BN_TOL, "dx")
    _close(bn.scale.grad.numpy(), ref["dp"]["BatchNorm_0"]["scale"], BN_TOL, "dscale")
    _close(bn.bias.grad.numpy(), ref["dp"]["BatchNorm_0"]["bias"], BN_TOL, "dbias")
    if not train:  # evaluation leaves the running statistics alone
        _close(bn.mean.numpy(), ref["stats"]["BatchNorm_0"]["mean"], 0.0, "eval mean")


def test_bn_runs_fold_is_each_run_alone():
    """Run r of R folded runs gives, bit for bit, the output, gradients and
    running statistics of a one-run layer with run r's parameters."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(ROWS, R, F)).astype(np.float32))
    folded = NormLayer("bn", F, (R,))
    with torch.no_grad():
        for t in folded.parameters():
            t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)))
    g = torch.from_numpy(rng.normal(size=(ROWS, R, F)).astype(np.float32))
    (folded(x, True) * g).sum().backward()
    y = folded(x, True).detach()
    for r in range(R):
        one = NormLayer("bn", F)
        with torch.no_grad():
            one.BatchNorm_0.scale.copy_(folded.BatchNorm_0.scale[r])
            one.BatchNorm_0.bias.copy_(folded.BatchNorm_0.bias[r])
        xr = x[:, r].contiguous()
        (one(xr, True) * g[:, r]).sum().backward()
        yr = one(xr, True).detach()
        assert torch.equal(y[:, r], yr)
        assert torch.equal(folded.BatchNorm_0.scale.grad[r], one.BatchNorm_0.scale.grad)
        assert torch.equal(folded.BatchNorm_0.mean[r], one.BatchNorm_0.mean)
        assert torch.equal(folded.BatchNorm_0.var[r], one.BatchNorm_0.var)


def test_unknown_normalization_raises():
    with pytest.raises(ValueError):
        NormLayer("gn", F)


# --- the models with 'bn' -----------------------------------------------------

N = 48


def _data():
    """The tiny hypergraph of tests/conftest.py with 3 hyperedges that have
    no member and nodes 0-2 taken out of every hyperedge (only their
    self-loop reaches them)."""
    jd = make_random_hyperdata(np.random.default_rng(11), num_nodes=N, num_hyperedges=18,
                               avg_size=5, num_features=12, num_classes=3)
    keep = jd.node >= 3
    jd.node, jd.edge = jd.node[keep], jd.edge[keep]
    jd.num_hyperedges += 3
    td = ttr.HyperData(x=jd.x, y=jd.y, node=jd.node, edge=jd.edge, num_nodes=jd.num_nodes,
                       num_hyperedges=jd.num_hyperedges)
    return jd, td


MASK = np.arange(N) % 2 == 0
MODELS = {
    "AllSetTransformer": dict(method="AllSetTransformer", heads=2, classifier_num_layers=2),
    "AllDeepSets": dict(method="AllDeepSets", classifier_num_layers=2),
    "CEGCN": dict(method="CEGCN", all_num_layers=3),
    "CEGAT": dict(method="CEGAT", heads=2, all_num_layers=2),
}


def _cfg(over, train):
    cfg = dict(dict(normalization="bn", mlp_hidden=16, classifier_hidden=16, all_num_layers=1,
                    dropout=0.0, bucket=64), **over)
    if train and over["method"] in ("AllSetTransformer", "AllDeepSets"):
        cfg["gpr"] = True  # no fixed input dropout on the GPR path
    return cfg


def _no_flax_dropout(self, inputs, deterministic=None, rng=None):
    return inputs


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(MODELS))
def test_bn_models_match_jax(name, train, monkeypatch):
    jd, td = _data()
    cfg = _cfg(MODELS[name], train)
    model, jb, _ = jfactory.prepare(jfactory.ExperimentConfig(**cfg), jd)
    variables = model.init({"params": jax.random.PRNGKey(0)}, jb, False)
    params, stats = variables["params"], variables["batch_stats"]
    assert stats, "no BatchNorm in the JAX model"
    # start from running statistics other than the init's zeros and ones
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)), stats)
    monkeypatch.setattr(flax.linen.Dropout, "__call__", _no_flax_dropout)

    def jloss(p):
        if train:
            out, upd = model.apply({"params": p, "batch_stats": stats}, jb, True,
                                   mutable=["batch_stats"])
        else:
            out, upd = model.apply({"params": p, "batch_stats": stats}, jb, False), {}
        return jax_nll(out, jb.y, jnp.asarray(MASK)), (out, upd)

    (loss, (logits, upd)), grads = jax.value_and_grad(jloss, has_aux=True)(params)

    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(**cfg), td, "cpu")
    tm = build_model(mcfg, torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(_np(params), batch_stats=_np(stats)))
    if name == "CEGAT":
        for m in tm.modules():
            if hasattr(m, "att_l"):
                m.p = 0.0  # attention dropout off, as patched on the JAX side
    out = tm(tb, train, torch.Generator().manual_seed(0))
    tl = masked_nll(out, tb.y, torch.from_numpy(MASK))
    tl.backward()
    _scaled_close(out.detach().numpy(), logits, MODEL_TOL, "logits")
    np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-5)
    want = params_from_jax(_np(grads))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    # a gradient that is zero in exact arithmetic (the output GAT conv's
    # att_r: a constant per destination inside its softmax) is rounding
    # noise on both sides: it is held against the model's largest gradient
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    for k, g in want.items():
        err = (got[k].grad - g).abs().max().item()
        assert err <= MODEL_TOL * max(g.abs().max().item(), floor), (k, err)
    stats_now = {k: v for k, v in tm.state_dict().items() if k.endswith((".mean", ".var"))}
    want_stats = params_from_jax(_np(upd["batch_stats"] if train else stats))
    assert set(stats_now) == set(want_stats)
    for k, v in want_stats.items():
        _scaled_close(stats_now[k].numpy(), v.numpy(), MODEL_TOL, k)


def test_bn_setgnn_takes_the_unsplit_exchange(monkeypatch):
    """Under 'bn' SetGNN's exchange covers every hyperedge row (the
    self-loops inside the sparse reduce), as the JAX gate: the split's
    N-slot hole rows never reach the statistics."""
    from allset_tpu_torch.models import setgnn

    _, td = _data()
    seen = []
    orig = setgnn.HalfNLHconv.forward

    def spy(self, x, d, *a, **k):
        seen.append((d.sl_mode, d.num_dst))
        return orig(self, x, d, *a, **k)

    monkeypatch.setattr(setgnn.HalfNLHconv, "forward", spy)
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(**_cfg(MODELS["AllDeepSets"], False)),
                                td, "cpu")
    build_model(mcfg, torch.Generator().manual_seed(0))(tb, True, torch.Generator())
    assert seen == [("none", tb.inc.num_edges), ("none", N)]
