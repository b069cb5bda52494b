"""The ported AllDeepSets (SetGNN, pma=False) against the JAX package's,
with the JAX parameters carried across by params_from_jax: HalfNLHconv's
Deep Sets branch for each reduce, and the whole model's logits and
step-0 gradients in each exchange mode.

Under tests/conftest.py's 8-device CPU mesh the JAX model takes the
unsplit ``Direction.plain`` exchange, while the port takes the self-loop
split (N-slot layout) wherever the incidence has one and LearnMask is off.
The math is the same: the split moves the self-loop entries out of the
sparse reduce and weights their rows by the self-loop norm. So values
agree to rounding (2e-4, the tolerance of tests/test_parity_setgnn.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allset_tpu.data.synthetic as jsyn
import allset_tpu.graph.transforms as jtr
import allset_tpu_torch.data.synthetic as tsyn
import allset_tpu_torch.graph.transforms as ttr
from allset_tpu.graph.batch import Batch as JBatch
from allset_tpu.models.setgnn import SetGNN as JSetGNN
from allset_tpu.models.setgnn import SetGNNConfig as JConfig
from allset_tpu.nn.modules import HalfNLHconv as JHalf
from allset_tpu.train.trainer import masked_nll as jax_nll
from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.models import SetGNN, SetGNNConfig
from allset_tpu_torch.nn.modules import HalfNLHconv
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.train import masked_nll
from allset_tpu_torch.utils import params_from_jax

N, HID = 260, 32
CFG = dict(num_features=16, num_classes=4, all_num_layers=1, mlp_hidden=HID,
           mlp_num_layers=2, classifier_num_layers=2, classifier_hidden=16, dropout=0.0)
MASK = np.arange(N) % 2 == 0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scaled_close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(np.asarray(got, np.float32) - want).max() / scale
    assert err <= tol, (what, err)


# --- HalfNLHconv's Deep Sets branch -----------------------------------------


def _incs():
    def build(syn, tr):
        hd = syn.scale_free_hypergraph(num_nodes=120, num_hyperedges=60, avg_edge_size=5,
                                       feature_dim=12, seed=2)
        return tr.norm_construction(tr.add_self_loops(hd), "deg_half_sym").to_incidence(
            bucket=64)

    return build(tsyn, ttr), build(jsyn, jtr)


@pytest.mark.parametrize("direction", ["v2e", "e2v"])
@pytest.mark.parametrize("num_layers", [0, 2])
@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
def test_half_layer_deep_sets_branch_matches_jax(aggr, num_layers, direction):
    tinc, jinc = _incs()
    td, jd = getattr(tinc, direction)(), getattr(jinc, direction)()
    width = 12 if direction == "v2e" else HID
    rng = np.random.default_rng(1)
    x = rng.normal(size=(td.num_src, width)).astype(np.float32)
    jm = JHalf(hid_dim=HID, out_dim=HID, num_layers=num_layers, dropout=0.0,
               normalization="ln", input_norm=True, attention=False)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jd, aggr)["params"] \
        if num_layers else {}
    out_dim = HID if num_layers else width
    tgt = rng.normal(size=(td.num_dst, out_dim)).astype(np.float32)

    def jloss(p, xx):
        y = jm.apply({"params": p}, xx, jd, aggr)
        return jnp.sum(y * tgt), y

    (_, y_ref), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    tm = HalfNLHconv(width, HID, HID, num_layers, 1, torch.Generator().manual_seed(0),
                     attention=False, dropout=0.0, normalization="ln", input_norm=True)
    tm.load_state_dict(params_from_jax(_np(params)))
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt, td, td.norm, aggr)
    (y * torch.from_numpy(tgt)).sum().backward()
    assert y.shape == tuple(y_ref.shape)
    _scaled_close(y.detach().numpy(), y_ref, 2e-4, "y")
    _scaled_close(xt.grad.numpy(), gx, 2e-4, "dx")
    want = params_from_jax(_np(gp))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, g in want.items():
        _scaled_close(got[k].grad.numpy(), g.numpy(), 2e-4, k)


# --- the AllDeepSets model ---------------------------------------------------
#
# Each mode: (model overrides, host preprocessing: self-loops, normtype).
MODES = {
    "split": ({}, (True, "all_one")),
    "no_self_loop": ({}, (False, "all_one")),
    "learn_mask": (dict(learn_mask=True), (True, "all_one")),
    "deg_half_sym": ({}, (True, "deg_half_sym")),
}


def _hd(syn, tr, steps):
    self_loops, normtype = steps
    g = syn.synthetic_hypergraph(num_nodes=N, num_hyperedges=150, feature_dim=16, seed=1)
    if self_loops:
        g = tr.add_self_loops(g)
    return tr.norm_construction(g, normtype)


@pytest.fixture(scope="module", params=list(MODES))
def jax_mode(request):
    """Per mode: the JAX AllDeepSets model's parameters (LearnMask: with a
    perturbed importance, so the weighted reduce is not trivially the
    unweighted one), its f32 logits, the step-0 loss and gradients, and
    its bf16 logits."""
    mode = request.param
    over, steps = MODES[mode]
    jb = JBatch.from_hyperdata(_hd(jsyn, jtr, steps), bucket=64)
    out = dict(mode=mode)
    for dtype in ("bfloat16", "float32"):
        jm = JSetGNN(JConfig.all_deep_sets(**CFG, **over, dtype=dtype))
        params = jax.jit(lambda k: jm.init({"params": k}, jb, False))(
            jax.random.PRNGKey(0))["params"]
        if "importance" in params:
            imp = 1 + 0.5 * np.random.default_rng(7).normal(size=jb.inc.nnz_padded)
            params = dict(params, importance=jnp.asarray(imp, jnp.float32))
        logits = jax.jit(lambda p: jm.apply({"params": p}, jb, False))(params)
        out[dtype] = dict(params=params, logits=np.asarray(logits))
    vg = jax.jit(jax.value_and_grad(
        lambda p: jax_nll(jm.apply({"params": p}, jb, False), jb.y, jnp.asarray(MASK))))
    l0, g0 = vg(out["float32"]["params"])
    out["float32"].update(loss0=float(l0), grads0=g0)
    return out


def _port(ref, mode, dtype, runs=None):
    over, steps = MODES[mode]
    tb = Batch.from_hyperdata(_hd(tsyn, ttr, steps), device="cpu", bucket=64)
    cfg = SetGNNConfig.all_deep_sets(**CFG, **over, dtype=dtype,
                                     nnz_padded=tb.inc.nnz_padded)
    gen = torch.Generator().manual_seed(0) if runs is None else [
        torch.Generator().manual_seed(r) for r in range(runs)]
    tm = SetGNN(cfg, gen)
    state = params_from_jax(_np(ref["params"]))
    if runs is not None:
        state = {k: torch.stack([v] * runs) for k, v in state.items()}
    tm.load_state_dict(state)
    return tm, tb


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_all_deep_sets_logits_match_jax(jax_mode, dtype, tol):
    mode = jax_mode["mode"]
    tm, tb = _port(jax_mode[dtype], mode, dtype)
    assert (tb.inc.real is None) == (mode == "no_self_loop")
    _kernels.reset_launches()
    with torch.no_grad():
        got = tm(tb, False)
    assert sum(_kernels.launches.values()) == 0  # CPU tensors: plain versions
    assert got.dtype == torch.float32 and got.shape == (N, 4)
    np.testing.assert_allclose(got.numpy(), jax_mode[dtype]["logits"], atol=tol, rtol=tol)


def test_all_deep_sets_step0_gradients_match_jax(jax_mode):
    """Every parameter's gradient, LearnMask's importance included (the
    SDDMM of the weighted reduce), within 2e-4 of its tensor's max |.|."""
    ref = jax_mode["float32"]
    tm, tb = _port(ref, jax_mode["mode"], "float32")
    want = params_from_jax(_np(ref["grads0"]))
    tl = masked_nll(tm(tb, False), tb.y, torch.from_numpy(MASK))
    tl.backward()
    np.testing.assert_allclose(tl.item(), ref["loss0"], rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, g in want.items():
        _scaled_close(got[k].grad.numpy(), g.numpy(), 2e-4, k)
    if jax_mode["mode"] == "learn_mask":
        assert tm.importance.grad.abs().max() > 0


@pytest.mark.parametrize("jax_mode", ["split", "learn_mask"], indirect=True)
def test_all_deep_sets_folded_runs_are_single_runs(jax_mode):
    """R=2 folded: each run's logits and gradients equal a single run's
    from the same parameters, bit for bit."""
    mode, ref = jax_mode["mode"], jax_mode["float32"]
    one, tb = _port(ref, mode, "float32")
    two, _ = _port(ref, mode, "float32", runs=2)
    mask = torch.from_numpy(MASK)
    y1 = one(tb, False)
    y2 = two(tb, False)
    masked_nll(y1, tb.y, mask).backward()
    masked_nll(y2, tb.y, mask[:, None].expand(N, 2)).sum().backward()
    g1 = dict(one.named_parameters())
    for r in range(2):
        assert torch.equal(y2[:, r], y1)
        for k, p in two.named_parameters():
            assert torch.equal(p.grad[r], g1[k].grad), k
