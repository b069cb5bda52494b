"""Models over the port's edge-partitioned exchange against the JAX models
over the JAX one, on the same partition of the same graph (the JAX side on
tests/conftest.py's 8-device CPU mesh, jitted; the port's D shard bodies in
this process), with the JAX parameters carried across:

  * AllSetTransformer through the fused sharded epilogue (split with
    balanced cuts, unsplit; f32 and bf16) at tests/test_sharded_epilogue.py's
    tolerances; its collectives per step against sharded_comm_stats;
  * AllDeepSets with LearnMask (the unsplit build's traced norm, the
    importance gradient) and AllSetTransformer with LearnMask (PMA reads
    no norm);
  * HCHA on the split build and UniGCNII on the unsplit one, through the
    sharded dir_spmm;
  * the Trainer's folded runs over a sharded batch against its runs one
    by one, and against the single-device batch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allset_tpu.train.factory as jfactory
import allset_tpu_torch.train.factory as tfactory
from allset_tpu.graph.batch import Batch as JBatch
from allset_tpu.models import SetGNN as JSetGNN
from allset_tpu.models import SetGNNConfig as JConfig
from allset_tpu.parallel.mesh import make_mesh
from allset_tpu.parallel.sharded import ShardedExchange as JSX
from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.models import SetGNN, SetGNNConfig, build_model
from allset_tpu_torch.nn.modules import packed_width
from allset_tpu_torch.parallel import distributed
from allset_tpu_torch.parallel.sharded import (ShardedExchange, sharded_comm_stats,
                                               sharded_epilogue_active)
from allset_tpu_torch.train import TrainConfig, Trainer
from allset_tpu_torch.utils import params_from_jax
from test_torch_sharded_build import skewed_pair

SETGNN = dict(num_features=16, num_classes=4, all_num_layers=1, mlp_hidden=128,
              classifier_hidden=32, classifier_num_layers=1, heads=4, dropout=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(D, split, threshold=1.25):
    """(JAX batch with its shex, port batch with its placed shex)."""
    jh, th = skewed_pair()
    jb = JBatch.from_hyperdata(jh, bucket=128)
    tb = Batch.from_hyperdata(th, device="cpu", bucket=128)
    jsh = JSX.build(jb.inc, make_mesh(D), split=split, balance_threshold=threshold).shard()
    tsh = ShardedExchange.build(tb.inc, D, split=split, balance_threshold=threshold)
    return (dataclasses.replace(jb, shex=jsh),
            dataclasses.replace(tb, shex=tsh.shard(distributed.local_comm(D, "cpu"))))


def _jax_loss_grads(model, params, jb):
    f = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(model.apply({"params": p}, jb, False).astype(jnp.float32) ** 2)))
    loss, grads = f(params)
    return float(loss), params_from_jax(_np(grads))


def _port_loss_grads(tm, tb):
    tm.zero_grad()
    loss = (tm(tb, False).float() ** 2).sum()
    loss.backward()
    return loss.item(), {k: p.grad for k, p in tm.named_parameters()}


def _compare(got, want, rtol, atol, frac=0.0):
    """tests/test_sharded_epilogue.py's _compare on {name: gradient}: per
    leaf at most ``frac`` of the elements outside atol + rtol|want| (at
    most 4 on a small leaf), and the largest error under max(10 atol,
    1e-3)."""
    assert set(got) == set(want)
    for k, b in want.items():
        a, b = got[k].float().numpy(), b.numpy()
        bad = np.abs(a - b) > (atol + rtol * np.abs(b))
        assert bad.sum() <= max(frac * bad.size, 4 * (frac > 0)), (k, bad.mean())
        assert np.abs(a - b).max() < max(10 * atol, 1e-3), (k, np.abs(a - b).max())


@pytest.mark.parametrize("D,split,dtype", [(2, None, "float32"), (4, False, "float32"),
                                           (2, None, "bfloat16")])
def test_allset_transformer_fused_sharded_epilogue_matches_jax(D, split, dtype, monkeypatch):
    """The loss and gradients through the fused sharded epilogue against
    the JAX model on its sharded exchange (f32) and against the port's
    replicated composition on the same exchange (sharded dir_spmm, then
    the epilogue; tests/test_sharded_epilogue.py's comparison and
    tolerances, f32 and bf16). In bf16 the port and the JAX package round
    at different points, as on one device: there the loss is held to JAX
    at the port's bf16 tolerance (tests/test_torch_setgnn.py)."""
    import allset_tpu_torch.nn.modules as modules

    jb, tb = _batches(D, split, threshold=1.05)
    if split is None:
        assert tb.shex.v2e.sl_mode == "append" and tb.shex.e2v.reasm is not None
    jm = JSetGNN(JConfig(**SETGNN, dtype=dtype))
    params = jax.jit(lambda k: jm.init({"params": k}, jb, False))(jax.random.PRNGKey(0))["params"]
    jl, jg = _jax_loss_grads(jm, params, jb)
    tm = SetGNN(SetGNNConfig(**SETGNN, dtype=dtype), torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(_np(params)))
    assert sharded_epilogue_active(tb.shex.v2e, 128, 4, 2, 128)
    distributed.reset_collectives()
    tl, tg = _port_loss_grads(tm, tb)
    counts, nbytes = dict(distributed.collectives), dict(distributed.collective_bytes)
    tg = {k: v.clone() for k, v in tg.items()}
    monkeypatch.setattr(modules, "sharded_epilogue_active", lambda *a: False)
    cl, cg = _port_loss_grads(tm, tb)
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        _compare(tg, jg, 1e-4, 1e-5)
        np.testing.assert_allclose(tl, cl, rtol=1e-4)
        _compare(tg, cg, 1e-4, 1e-5)
    else:
        np.testing.assert_allclose(tl, jl, rtol=5e-2)
        np.testing.assert_allclose(tl, cl, rtol=5e-2)
        _compare(tg, cg, 5e-2, 3e-2, frac=5e-3)
    # the fused path's collectives: the narrow all-gathers, the parameter
    # gradients' all-reduce, the d_sl all-gather in 'add' mode
    st = sharded_comm_stats(tb.shex, packed_width(128, 4), 2 if dtype == "bfloat16" else 4,
                            epilogue_hc=128)
    assert counts == {"all_gather": st["reassembly_fwd"] + st["allgathers_bwd"],
                      "all_reduce": st["psums_bwd"]}
    assert nbytes == {"all_gather": st["fwd_bytes"] + st["bwd_ag_bytes"],
                      "all_reduce": st["bwd_bytes"]}


def test_all_deep_sets_learnmask_matches_jax():
    """The unsplit build's traced norm: loss and every gradient, the
    importance's (the sharded SDDMM) included."""
    jb, tb = _batches(4, False)
    kw = dict(SETGNN, mlp_hidden=32, learn_mask=True)
    del kw["heads"]
    jm = JSetGNN(JConfig.all_deep_sets(**kw))
    params = jax.jit(lambda k: jm.init({"params": k}, jb, False))(jax.random.PRNGKey(0))["params"]
    jl, jg = _jax_loss_grads(jm, params, jb)
    tm = SetGNN(SetGNNConfig.all_deep_sets(**kw, nnz_padded=tb.inc.nnz_padded),
                torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(_np(params)))
    distributed.reset_collectives()
    tl, tg = _port_loss_grads(tm, tb)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert np.abs(jg["importance"].numpy()).max() > 0
    _compare(tg, jg, 1e-3, 1e-5)
    # per direction one all-gather, the dw and dnorm all-reduces
    assert dict(distributed.collectives) == {"all_gather": 2, "all_reduce": 4}


def test_allset_transformer_learnmask_keeps_pma_unweighted():
    jb, tb = _batches(2, False)
    jm = JSetGNN(JConfig(**SETGNN, learn_mask=True))
    params = dict(jax.jit(lambda k: jm.init({"params": k}, jb, False))(
        jax.random.PRNGKey(0))["params"])
    rng = np.random.default_rng(1)
    params["importance"] = jnp.asarray(1.0 + 0.5 * rng.normal(size=params["importance"].shape),
                                       jnp.float32)
    want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, jb, False))(params))
    tm = SetGNN(SetGNNConfig(**SETGNN, learn_mask=True, nnz_padded=tb.inc.nnz_padded),
                torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(_np(params)))
    with torch.no_grad():
        got = tm(tb, False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method,D,split", [("HCHA", 2, None), ("UniGCNII", 4, False)])
def test_zoo_over_the_sharded_exchange_matches_jax(method, D, split):
    """Logits and gradients of the masked NLL against the JAX model on
    its sharded exchange, within 2e-4 of each tensor's max |.|."""
    from allset_tpu.data.synthetic import synthetic_hypergraph as jsyn
    from allset_tpu_torch.data.synthetic import synthetic_hypergraph as tsyn
    from allset_tpu_torch.train import masked_nll
    from allset_tpu.train.trainer import masked_nll as jax_nll

    kw = dict(method=method, mlp_hidden=32, dropout=0.0, bucket=128)
    jm, jb, _ = jfactory.prepare(jfactory.ExperimentConfig(**kw),
                                 jsyn(num_nodes=48, num_hyperedges=20, seed=3))
    mcfg, tb = tfactory.prepare(tfactory.ExperimentConfig(**kw),
                                tsyn(num_nodes=48, num_hyperedges=20, seed=3), "cpu")
    jsh = JSX.build(jb.inc, make_mesh(D), split=split).shard()
    jb = dataclasses.replace(jb, shex=jsh)
    tsh = ShardedExchange.build(tb.inc, D, split=split)
    tb = dataclasses.replace(tb, shex=tsh.shard(distributed.local_comm(D, "cpu")))
    assert tb.shex.v2e.sl_mode == ("append" if split is None else "none")
    mask = np.arange(tb.num_nodes) % 2 == 0
    params = jax.jit(lambda k: jm.init({"params": k}, jb, False))(jax.random.PRNGKey(0))["params"]
    logits, (loss, grads) = jax.jit(lambda p: (
        jm.apply({"params": p}, jb, False),
        jax.value_and_grad(lambda q: jax_nll(jm.apply({"params": q}, jb, False), jb.y,
                                             jnp.asarray(mask)))(p)))(params)
    tm = build_model(mcfg, torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(_np(params)))
    distributed.reset_collectives()
    out = tm(tb, False)
    tl = masked_nll(out, tb.y, torch.from_numpy(mask))
    tl.backward()
    convs = 2  # both models' depth here: one V2E and one E2V pass each
    assert dict(distributed.collectives) == {"all_gather": 2 * convs, "all_reduce": 2 * convs}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-5)
    want = params_from_jax(_np(grads))
    for k, p in tm.named_parameters():
        g = want[k].numpy()
        err = np.abs(p.grad.numpy() - g).max() / max(np.abs(g).max(), 1e-6)
        assert err <= 2e-4, (k, err)


def test_trainer_folded_runs_over_the_sharded_exchange():
    """Three runs folded into each launch over a D=2 sharded batch against
    the same runs one by one (dropout on: every run's generator is seeded
    as the Trainer seeds it), and against the single-device batch."""
    _, tb = _batches(2, None)
    mcfg = SetGNNConfig(**dict(SETGNN, mlp_hidden=64, dropout=0.5))
    kw = dict(epochs=4, runs=3, lr=1e-2, seed=0, display_step=0)
    folded = Trainer(mcfg, tb, TrainConfig(vmap_runs=True, **kw)).fit()
    one_by_one = Trainer(mcfg, tb, TrainConfig(vmap_runs=False, **kw)).fit()
    single = Trainer(mcfg, dataclasses.replace(tb, shex=None),
                     TrainConfig(vmap_runs=True, **kw)).fit()
    assert folded.groups == [3] and one_by_one.groups == [1, 1, 1]
    np.testing.assert_allclose(folded.metrics, one_by_one.metrics, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(folded.metrics, single.metrics, rtol=1e-3, atol=1e-4)
    assert np.isfinite(folded.metrics).all()


@pytest.mark.parametrize("mode", [dict(normalization="bn"), dict(learn_mask=True)],
                         ids=["bn", "learn_mask_on_a_split_build"])
def test_setgnn_keeps_the_single_device_exchange_where_the_jax_gate_does(mode):
    """'bn', and LearnMask on a split build, ignore the shex as the JAX
    model does (allset_tpu/models/setgnn.py:137-143): no collective, the
    logits of the batch without it."""
    _, tb = _batches(2, None)
    tm = SetGNN(SetGNNConfig(**SETGNN, **mode, nnz_padded=tb.inc.nnz_padded),
                torch.Generator().manual_seed(0))
    distributed.reset_collectives()
    with torch.no_grad():
        got = tm(tb, False)
        want = tm(dataclasses.replace(tb, shex=None), False)
    assert sum(distributed.collectives.values()) == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)
