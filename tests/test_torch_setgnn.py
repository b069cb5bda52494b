"""The ported AllSetTransformer (SetGNN, pma=True) against the JAX package's,
with the JAX parameters carried across by params_from_jax: logits,
step-0 gradients and three Adam steps.

The JAX model runs its fused epilogue in Pallas interpret mode
(ALLSET_PMA_EPILOGUE=interpret). Under tests/conftest.py's 8-device CPU
mesh it takes the unsplit ``Direction.plain`` exchange (allset_tpu
models/setgnn.py requires a single device for the self-loop split),
while the port always runs the split N-slot layout. The math is the same:
the split only moves the self-loop entries out of the sparse reduce, and
the global softmax shift cancels in the ratio. So the logits agree to
rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import allset_tpu.data.synthetic as jsyn
import allset_tpu.graph.transforms as jtr
import allset_tpu_torch.data.synthetic as tsyn
import allset_tpu_torch.graph.transforms as ttr
from allset_tpu.graph.batch import Batch as JBatch
from allset_tpu.models.setgnn import SetGNN as JSetGNN
from allset_tpu.models.setgnn import SetGNNConfig as JConfig
from allset_tpu.train.trainer import masked_nll as jax_nll
from allset_tpu.train.trainer import torch_adam
from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.models import SetGNN, SetGNNConfig
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.train import masked_nll, train_steps
from allset_tpu_torch.utils import params_from_jax

CFG = dict(num_features=16, num_classes=4, all_num_layers=1, mlp_hidden=128,
           mlp_num_layers=2, classifier_num_layers=1, heads=4, dropout=0.0)
N = 260


MASK = np.arange(N) % 2 == 0


def _hd(syn, tr):
    g = syn.synthetic_hypergraph(num_nodes=N, num_hyperedges=150, feature_dim=16, seed=1)
    return tr.norm_construction(tr.add_self_loops(g), "all_one")


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX model's parameters and, per dtype, its logits; in f32 also
    the step-0 loss and gradients and the losses of three torch_adam
    steps (one compiled value_and_grad serves both)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALLSET_PMA_EPILOGUE", "interpret")
        jb = JBatch.from_hyperdata(_hd(jsyn, jtr), bucket=64)
        for dtype in ("bfloat16", "float32"):
            jm = JSetGNN(JConfig(**CFG, dtype=dtype))
            params = jax.jit(lambda k: jm.init({"params": k}, jb, False))(
                jax.random.PRNGKey(0))["params"]
            logits = jax.jit(lambda p: jm.apply({"params": p}, jb, False))(params)
            out[dtype] = dict(params=params, logits=np.asarray(logits))
        # jm is the float32 model from here on
        vg = jax.jit(jax.value_and_grad(
            lambda p: jax_nll(jm.apply({"params": p}, jb, False), jb.y, jnp.asarray(MASK))))
        p = out["float32"]["params"]
        l0, g0 = vg(p)
        tx = torch_adam(1e-3, 0.0)
        state, losses = tx.init(p), []
        for _ in range(3):
            loss, g = vg(p)
            u, state = tx.update(g, state, p)
            p = optax.apply_updates(p, u)
            losses.append(float(loss))
        out["float32"].update(loss0=float(l0), grads0=g0, adam_losses=losses)
    return out


def _port(ref, dtype):
    tb = Batch.from_hyperdata(_hd(tsyn, ttr), device="cpu", bucket=64)
    tm = SetGNN(SetGNNConfig(**CFG, dtype=dtype), torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, ref["params"])))
    return tm, tb


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_logits_match_jax(jax_ref, dtype, tol):
    tm, tb = _port(jax_ref[dtype], dtype)
    _kernels.reset_launches()
    with torch.no_grad():
        got = tm(tb, False)
    assert sum(_kernels.launches.values()) == 0  # CPU tensors: plain versions
    assert got.dtype == torch.float32 and got.shape == (N, 4)
    np.testing.assert_allclose(got.numpy(), jax_ref[dtype]["logits"], atol=tol, rtol=tol)


def test_step0_gradients_match_jax(jax_ref):
    ref = jax_ref["float32"]
    tm, tb = _port(ref, "float32")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, ref["grads0"]))
    tl = masked_nll(tm(tb, False), tb.y, torch.from_numpy(MASK))
    tl.backward()
    np.testing.assert_allclose(tl.item(), ref["loss0"], rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, g in want.items():
        scale = max(g.abs().max().item(), 1e-6)
        err = (got[k].grad - g).abs().max().item() / scale
        assert err <= 1e-3, (k, err)


def test_three_adam_steps_match_jax_torch_adam(jax_ref):
    ref = jax_ref["float32"]
    tm, tb = _port(ref, "float32")
    got = train_steps(tm, tb, torch.from_numpy(MASK), 3, lr=1e-3)
    np.testing.assert_allclose(got.numpy(), ref["adam_losses"], rtol=1e-4, atol=1e-4)
    assert got[-1] < got[0]


def test_train_mode_dropout_follows_its_generator(jax_ref):
    """train=True drops with p=0.2 at the input and cfg.dropout between
    stages, drawn from the caller's generator; train=False is the identity."""
    tm, tb = _port(jax_ref["float32"], "float32")
    tm.cfg = SetGNNConfig(**{**CFG, "dropout": 0.5})
    with torch.no_grad():
        a = tm(tb, True, torch.Generator().manual_seed(1))
        b = tm(tb, True, torch.Generator().manual_seed(1))
        c = tm(tb, True, torch.Generator().manual_seed(2))
        d = tm(tb, False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c) and not torch.allclose(a, d)
    np.testing.assert_allclose(d.numpy(), jax_ref["float32"]["logits"], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("override", [dict(normalization="bn")])
def test_other_modes_raise(override):
    with pytest.raises(NotImplementedError):
        SetGNN(SetGNNConfig(**{**CFG, **override}), torch.Generator().manual_seed(0))


# --- the other AllSetTransformer modes ------------------------------------
#
# Each mode: (model overrides, host preprocessing). The JAX model takes the
# unsplit Direction.plain exchange here (8-device CPU mesh); the port takes
# the unsplit Directions under learn_mask and without self-loops, and the
# split ones otherwise (gpr, exclude_self: the expansion keeps the
# self-loops as the last edges).
MODE_CFG = {**CFG, "classifier_num_layers": 2, "classifier_hidden": 32}
MODES = {
    "gpr": (dict(gpr=True), ("self_loops",)),
    "learn_mask": (dict(learn_mask=True), ("self_loops",)),
    "no_self_loop": ({}, ()),
    "all_num_layers_0": (dict(all_num_layers=0), ("self_loops",)),
    "exclude_self": ({}, ("self_loops", "exclude_self")),
}
WD = {"learn_mask": 5e-4}  # Adam's weight decay moves importance, whose gradient is 0


def _mode_hd(syn, tr, steps):
    g = syn.synthetic_hypergraph(num_nodes=N, num_hyperedges=150, feature_dim=16, seed=1)
    if "self_loops" in steps:
        g = tr.add_self_loops(g)
    if "exclude_self" in steps:
        g = tr.expand_edge_index(g)
    return tr.norm_construction(g, "all_one")


@pytest.fixture(scope="module", params=list(MODES))
def jax_mode(request):
    """Per mode, as jax_ref: parameters and logits per dtype; in f32 the
    step-0 loss and gradients, and three torch_adam steps (the losses and
    the final parameters)."""
    mode = request.param
    over, steps = MODES[mode]
    out = dict(mode=mode)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALLSET_PMA_EPILOGUE", "interpret")
        jb = JBatch.from_hyperdata(_mode_hd(jsyn, jtr, steps), bucket=64)
        for dtype in ("bfloat16", "float32"):
            jm = JSetGNN(JConfig(**{**MODE_CFG, **over}, dtype=dtype))
            params = jax.jit(lambda k: jm.init({"params": k}, jb, False))(
                jax.random.PRNGKey(0))["params"]
            apply = jax.jit(lambda p: jm.apply({"params": p}, jb, False))
            out[dtype] = dict(params=params, logits=np.asarray(apply(params)))
        vg = jax.jit(jax.value_and_grad(
            lambda p: jax_nll(jm.apply({"params": p}, jb, False), jb.y, jnp.asarray(MASK))))
        p = out["float32"]["params"]
        l0, g0 = vg(p)
        tx = torch_adam(1e-3, WD.get(mode, 0.0))
        state, losses = tx.init(p), []
        for _ in range(3):
            loss, g = vg(p)
            u, state = tx.update(g, state, p)
            p = optax.apply_updates(p, u)
            losses.append(float(loss))
        out["float32"].update(loss0=float(l0), grads0=g0, adam_losses=losses, adam_params=p)
        if mode == "learn_mask":
            imp = 1 + 0.5 * np.random.default_rng(7).normal(size=jb.inc.nnz_padded)
            pert = dict(out["float32"]["params"], importance=jnp.asarray(imp, jnp.float32))
            out["perturbed"] = dict(params=pert, logits=np.asarray(apply(pert)))
    return out


def _port_mode(ref, mode, dtype, params=None):
    over, steps = MODES[mode]
    tb = Batch.from_hyperdata(_mode_hd(tsyn, ttr, steps), device="cpu", bucket=64)
    cfg = SetGNNConfig(**{**MODE_CFG, **over}, dtype=dtype, nnz_padded=tb.inc.nnz_padded)
    tm = SetGNN(cfg, torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, ref["params"] if params is None else params)))
    return tm, tb


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_mode_logits_match_jax(jax_mode, dtype, tol):
    mode = jax_mode["mode"]
    tm, tb = _port_mode(jax_mode[dtype], mode, dtype)
    unsplit = mode in ("learn_mask", "no_self_loop")
    assert (tb.inc.real is None) == (mode == "no_self_loop")
    assert not unsplit or tm.cfg.learn_mask or tb.inc.real is None
    with torch.no_grad():
        got = tm(tb, False)
    assert got.dtype == torch.float32 and got.shape == (N, 4)
    np.testing.assert_allclose(got.numpy(), jax_mode[dtype]["logits"], atol=tol, rtol=tol)


def test_mode_step0_gradients_match_jax(jax_mode):
    ref = jax_mode["float32"]
    tm, tb = _port_mode(ref, jax_mode["mode"], "float32")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, ref["grads0"]))
    tl = masked_nll(tm(tb, False), tb.y, torch.from_numpy(MASK))
    tl.backward()
    np.testing.assert_allclose(tl.item(), ref["loss0"], rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, g in want.items():
        scale = max(g.abs().max().item(), 1e-6)
        err = (got[k].grad - g).abs().max().item() / scale
        assert err <= 1e-3, (k, err)


def test_mode_three_adam_steps_match_jax_torch_adam(jax_mode):
    """The losses; under learn_mask (wd 5e-4) every parameter too,
    importance included: its zero gradient plus weight decay."""
    mode, ref = jax_mode["mode"], jax_mode["float32"]
    tm, tb = _port_mode(ref, mode, "float32")
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3, weight_decay=WD.get(mode, 0.0))
    got = train_steps(tm, tb, torch.from_numpy(MASK), 3, optimizer=opt)
    np.testing.assert_allclose(got.numpy(), ref["adam_losses"], rtol=1e-4, atol=1e-4)
    assert got[-1] < got[0]
    if mode == "learn_mask":
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, ref["adam_params"]))
        for k, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=k)
        assert not torch.equal(tm.importance.detach(), torch.ones_like(tm.importance))


@pytest.mark.parametrize("jax_mode", ["learn_mask"], indirect=True)
def test_learn_mask_importance_changes_no_logit(jax_mode):
    """PMA never reads the entry norm: an importance of 1 + 0.5 N(0, 1)
    leaves the logits as they were, in both packages."""
    pert = jax_mode["perturbed"]
    np.testing.assert_array_equal(pert["logits"], jax_mode["float32"]["logits"])
    tm, tb = _port_mode(jax_mode["float32"], "learn_mask", "float32")
    tp, _ = _port_mode(jax_mode["float32"], "learn_mask", "float32", params=pert["params"])
    assert not torch.equal(tp.importance, tm.importance)
    with torch.no_grad():
        assert torch.equal(tp(tb, False), tm(tb, False))
        np.testing.assert_allclose(tp(tb, False).numpy(), pert["logits"], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("seed,sizes", [(1, None), (4, (1, 1, 3, 5, 2))])
def test_expand_edge_index_matches_jax(seed, sizes):
    """On a synthetic graph with self-loops, and on a hand-made one with
    singleton and empty hyperedges."""
    if sizes is None:
        jg = jtr.add_self_loops(jsyn.synthetic_hypergraph(
            num_nodes=N, num_hyperedges=150, feature_dim=16, seed=seed))
        tg = ttr.add_self_loops(tsyn.synthetic_hypergraph(
            num_nodes=N, num_hyperedges=150, feature_dim=16, seed=seed))
    else:
        rng = np.random.default_rng(seed)
        edge = np.repeat(np.arange(len(sizes) + 1), list(sizes) + [0])
        node = np.concatenate([rng.choice(9, k, replace=False) for k in sizes])
        x, y = np.zeros((9, 2), np.float32), np.zeros(9, np.int64)
        jg = jtr.HyperData(x=x, y=y, node=node, edge=edge, num_nodes=9,
                           num_hyperedges=len(sizes) + 1)
        tg = ttr.HyperData(x=x, y=y, node=node, edge=edge, num_nodes=9,
                           num_hyperedges=len(sizes) + 1)
    want, got = jtr.expand_edge_index(jg), ttr.expand_edge_index(tg)
    np.testing.assert_array_equal(got.node, want.node)
    np.testing.assert_array_equal(got.edge, want.edge)
    assert (got.num_hyperedges, got.num_sl_edges, got.norm) == (
        want.num_hyperedges, want.num_sl_edges, None)
