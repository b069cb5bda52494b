"""The ported HAN vertical against the JAX package's.

On small synthetic hypergraphs made from a numpy seed, with the JAX
parameters carried across by ``params_from_jax``:

  * the metapath graphs (VEV, EVE), features and labels equal the JAX
    package's array for array;
  * DGLGATConv's packed path against the JAX packed path and against the
    port's reference composition (an Incidence without its node-sorted
    order), on values (rtol/atol 1e-5) and on every parameter's gradient
    (rtol 1e-4, atol 1e-5), the tolerances of tests/test_han.py;
  * the whole HAN's logits and gradients against the JAX model's (also
    through the flat legacy extras, on the reference composition);
  * the sampler's blocks and batches bit-equal to the JAX sampler's, and
    SampledHAN and BlockGATConv against the JAX modules on the same blocks;
  * metapath_reachable's arrays and HeteroHAN against the JAX HeteroHAN on
    a small typed graph (gradients against its reference composition),
    with the graph cache;
  * f1_scores against sklearn's f1_score (micro, macro), with a class that
    is only predicted and one that is never predicted;
  * three steps of train_han's step (Adam with coupled weight decay,
    dropout 0) against the same steps composed from the JAX package, and
    the runs' splits equal to the JAX package's;
  * short train_han and train_han_minibatch runs end finite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import allset_tpu.data.sampler as jsampler
import allset_tpu.graph.hetero as jhetero
import allset_tpu.models.han as jhan
import allset_tpu_torch.data.sampler as tsampler
import allset_tpu_torch.graph.hetero as thetero
import allset_tpu_torch.models.han as than
import allset_tpu_torch.train.han_trainer as ttrainer
from allset_tpu.data.synthetic import synthetic_hypergraph as jax_synthetic
from allset_tpu.graph.batch import Batch as JBatch
from allset_tpu.graph.batch import split_masks as jax_split_masks
from allset_tpu.graph.metapath import build_metapath_graphs as jax_build
from allset_tpu.graph.transforms import rand_train_test_idx as jax_split
from allset_tpu.train.trainer import masked_acc as jax_acc
from allset_tpu.train.trainer import masked_nll as jax_nll
from allset_tpu.train.trainer import torch_adam
from allset_tpu_torch.data.synthetic import synthetic_hypergraph
from allset_tpu_torch.graph import Batch, rand_train_test_idx, split_masks
from allset_tpu_torch.graph.metapath import build_metapath_graphs
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.train import masked_nll
from allset_tpu_torch.utils import params_from_jax

RTOL, ATOL = 1e-5, 1e-5  # values
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # gradients
INC_FIELDS = ("node", "edge", "mask", "node_perm", "inv_node_perm", "node_sorted",
              "edge_by_node", "node_count", "edge_count")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_grads(model, jgrads, what=""):
    want = params_from_jax(_np(jgrads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{what} {k}")


def _init(module, key, *args):
    """The JAX module's variables, initialised under jit: traced eagerly,
    the JAX package's custom VJPs take seconds a call on the CPU."""
    return jax.jit(lambda k: module.init({"params": k}, *args))(jax.random.PRNGKey(key))


def _grad(f, v):
    return jax.jit(jax.grad(f))(v)


def _load(model, jparams):
    model.load_state_dict(params_from_jax(_np(jparams)))
    return model


@pytest.fixture(scope="module")
def graphs():
    """The same small hypergraph in both packages and its metapath graphs
    (bucket 64): (JAX data, port data, JAX build, port build)."""
    kw = dict(num_nodes=60, num_hyperedges=25, num_classes=3, seed=2)
    jd, td = jax_synthetic(**kw), synthetic_hypergraph(**kw)
    return jd, td, jax_build(jd, bucket=64), build_metapath_graphs(td, bucket=64)


def _jax_batch(jb):
    feats, labels, vev, eve = jb
    return JBatch(x=jnp.asarray(feats), y=jnp.asarray(labels, jnp.int32), inc=None,
                  extras=jhan.han_extras(vev, eve))


def _port_batch(tb):
    feats, labels, vev, eve = tb
    return Batch(x=torch.as_tensor(feats), y=torch.as_tensor(labels), inc=None,
                 extras=than.han_extras(vev, eve)).to("cpu")


# --- metapath graphs ----------------------------------------------------------


def test_metapath_graphs_equal_jax(graphs):
    _, _, jb, tb = graphs
    np.testing.assert_array_equal(tb[0], np.asarray(jb[0]))
    np.testing.assert_array_equal(tb[1], np.asarray(jb[1]))
    for j, t in zip(jb[2:], tb[2:]):
        assert (t.num_nodes, t.num_edges, t.nnz, t.nnz_padded) == (
            j.num_nodes, j.num_edges, j.nnz, j.node.shape[0])
        for f in INC_FIELDS:
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
        np.testing.assert_array_equal(t.norm.numpy(), np.asarray(j.norm))


# --- DGLGATConv ---------------------------------------------------------------


@pytest.mark.parametrize("feats", ["metapath", "dense"])
@pytest.mark.parametrize("which", ["vev", "eve"])
@pytest.mark.parametrize("heads,C", [(4, 8), (8, 8)])
def test_gatconv_packed_matches_jax_and_reference(graphs, feats, which, heads, C):
    """The port's packed path against the JAX packed path and against the
    port's reference composition: values and the gradient of every
    parameter of sum(out^2). With build_metapath_graphs' features (zero rows for
    the hyperedges, the last row among them) against the JAX packed path;
    with dense features against the JAX reference composition, since there
    the JAX packed path's gradient is wrong: its dir_reduce gives the
    padded entries the last row's cotangent, which jnp.take(er, dst)'s
    transpose adds to er's last row. The port gives the padded entries a
    zero cotangent."""
    _, _, jb, tb = graphs
    gi = ("vev", "eve").index(which)
    jg, tg = jb[2 + gi], tb[2 + gi]
    x = np.asarray(jb[0], np.float32)
    if feats == "dense":
        x = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    conv = jhan.DGLGATConv(out_channels=C, heads=heads)
    jv = _init(conv, 3, jg, jnp.asarray(x), False)
    jy = conv.apply(jv, jg, jnp.asarray(x), False)
    jref = jg if feats == "metapath" else dataclasses.replace(jg, node_perm=None)
    jgrad = _grad(lambda v: jnp.sum(conv.apply(v, jref, jnp.asarray(x), False) ** 2), jv)

    port = _load(than.DGLGATConv(x.shape[1], C, heads, torch.Generator().manual_seed(0)),
                 jv["params"])
    outs = {}
    for path, g in (("packed", tg), ("reference", dataclasses.replace(tg, node_perm=None))):
        port.zero_grad()
        _kernels.reset_launches()
        y = port(g, torch.as_tensor(x))
        (y ** 2).sum().backward()
        assert sum(_kernels.launches.values()) == 0  # CPU tensors: plain versions
        outs[path] = y.detach().numpy()
        _close_grads(port, jgrad["params"], path)
    np.testing.assert_allclose(outs["packed"], np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs["packed"], outs["reference"], rtol=RTOL, atol=ATOL)


# --- HAN ------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [(4,), (2, 3)])
def test_han_matches_jax(graphs, heads):
    """HAN's logits and every gradient of the masked NLL against the JAX
    model's; the flat legacy extras (the reference composition) give the
    same logits."""
    jd, td, jb, tb = graphs
    T = td.num_nodes + td.num_hyperedges
    mask = np.arange(T) < td.num_nodes
    cfg = dict(num_features=td.num_features, num_classes=3, hidden_units=8, num_heads=heads,
               dropout=0.0)
    jmodel, jbatch = jhan.HAN(jhan.HANConfig(**cfg)), _jax_batch(jb)
    params = _init(jmodel, 1, jbatch, False)["params"]
    y = jnp.maximum(jbatch.y, 0)

    def jloss(p):
        return jax_nll(jmodel.apply({"params": p}, jbatch, False), y, jnp.asarray(mask))

    jlogits = jmodel.apply({"params": params}, jbatch, False)
    jgrads = _grad(jloss, params)

    model = _load(than.HAN(than.HANConfig(**cfg), torch.Generator().manual_seed(0)), params)
    batch = _port_batch(tb)
    logits = model(batch, False)
    masked_nll(logits, batch.y.clamp_min(0), torch.as_tensor(mask)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    _close_grads(model, jgrads)

    flat = {}
    for name, inc in batch.extras.items():
        flat.update({f"{name}_{f}": getattr(inc, f) for f in ("node", "edge", "norm", "mask")})
    with torch.no_grad():
        got = model(dataclasses.replace(batch, extras=flat), False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)


def test_batch_to_moves_incidence_extras(graphs):
    batch = _port_batch(graphs[3])
    moved = batch.to("cpu")
    assert isinstance(moved.extras["vev"], type(graphs[3][2]))
    assert torch.equal(moved.extras["eve"].node, graphs[3][3].node)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batch.to("cuda")


# --- the sampler and SampledHAN -------------------------------------------------


def test_sampler_blocks_equal_jax(graphs):
    """Blocks and batches from the same seed are bit-equal, call after call
    (the generator's stream stays in step)."""
    jd, td, _, _ = graphs
    js = jsampler.HANNeighborSampler(jd, num_neighbors=8, seed=1)
    ts = tsampler.HANNeighborSampler(td, num_neighbors=8, seed=1)
    for k in (None, 16):
        seeds = np.arange(0, 60, 3)
        jbl, tbl = js.sample(seeds, num_neighbors=k), ts.sample(seeds, num_neighbors=k)
        for name in ("vev", "eve"):
            np.testing.assert_array_equal(tbl[name].src, jbl[name].src)
            np.testing.assert_array_equal(tbl[name].mask, jbl[name].mask)
    for (sj, vj), (st, vt) in zip(js.batches(np.arange(60), 7), ts.batches(np.arange(60), 7)):
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(vt, vj)


def test_sampled_han_matches_jax(graphs):
    """SampledHAN's logits and gradients on the same blocks (B10's plain
    version gathers the rows)."""
    jd, td, _, _ = graphs
    blocks = jsampler.HANNeighborSampler(jd, num_neighbors=6, seed=4).sample(np.arange(20))
    seeds = np.arange(20)
    jblocks = {f"{n}_{f}": jnp.asarray(getattr(b, f)) for n, b in blocks.items()
               for f in ("src", "mask")}
    x = np.asarray(jd.x, np.float32)
    cfg = dict(num_features=td.num_features, num_classes=3, hidden_units=4, num_heads=(3,),
               dropout=0.0)
    jmodel = jhan.SampledHAN(jhan.HANConfig(**cfg))
    v = _init(jmodel, 2, jnp.asarray(x), jnp.asarray(seeds), jblocks, False)

    def jloss(v):
        return jnp.sum(jmodel.apply(v, jnp.asarray(x), jnp.asarray(seeds), jblocks, False) ** 2)

    jout = jmodel.apply(v, jnp.asarray(x), jnp.asarray(seeds), jblocks, False)
    jgrad = _grad(jloss, v)
    model = _load(than.SampledHAN(than.HANConfig(**cfg), torch.Generator().manual_seed(0)),
                  v["params"])
    tblocks = ttrainer.block_tensors(blocks, "cpu")
    out = model(torch.as_tensor(x), torch.as_tensor(seeds), tblocks, False)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    _close_grads(model, jgrad["params"])


def test_block_gatconv_matches_jax():
    """BlockGATConv alone on random rows and a random mask (every seed keeps
    its self-loop column)."""
    rng = np.random.default_rng(5)
    B, K1, F, H, C = 6, 5, 7, 2, 3
    h_src = rng.normal(size=(B, K1, F)).astype(np.float32)
    h_dst = rng.normal(size=(B, F)).astype(np.float32)
    mask = rng.random((B, K1)) < 0.6
    mask[:, -1] = True
    conv = jhan.BlockGATConv(out_channels=C, heads=H)
    args = (jnp.asarray(h_src), jnp.asarray(h_dst), jnp.asarray(mask), False)
    v = _init(conv, 0, *args)
    jout = conv.apply(v, *args)
    jgrad = _grad(lambda v: jnp.sum(jnp.sin(conv.apply(v, *args))), v)
    port = _load(than.BlockGATConv(F, C, H, torch.Generator().manual_seed(0)), v["params"])
    out = port(torch.as_tensor(h_src), torch.as_tensor(h_dst), torch.as_tensor(mask), False)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    _close_grads(port, jgrad["params"])


# --- the hetero surface -----------------------------------------------------------


def _acm_like(rng, n_p=40, n_a=12, n_s=5):
    """Tiny ACM-shaped typed graph (paper-author, paper-subject), as
    tests/test_hetero.py builds it; (JAX graph, port graph)."""
    pa_p, pa_a = rng.integers(0, n_p, 80), rng.integers(0, n_a, 80)
    ps_p, ps_s = np.arange(n_p), rng.integers(0, n_s, n_p)
    kw = dict(
        num_nodes={"paper": n_p, "author": n_a, "subject": n_s},
        edges={("paper", "pa", "author"): (pa_p, pa_a), ("author", "ap", "paper"): (pa_a, pa_p),
               ("paper", "ps", "subject"): (ps_p, ps_s), ("subject", "sp", "paper"): (ps_s, ps_p)})
    return jhetero.HeteroGraph(**kw), thetero.HeteroGraph(**kw)


def test_metapath_reachable_and_hetero_han_match_jax():
    jg, tg = _acm_like(np.random.default_rng(2))
    paths = [["pa", "ap"], ["ps", "sp"]]
    for mp in paths:
        j, t = jhetero.metapath_reachable(jg, mp), thetero.metapath_reachable(tg, mp)
        assert (t.num_nodes, t.num_edges, t.nnz) == (j.num_nodes, j.num_edges, j.nnz)
        for f in INC_FIELDS:
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    with pytest.raises(ValueError):
        thetero.metapath_reachable(tg, ["pa", "sp"])  # author != subject
    with pytest.raises(ValueError):
        thetero.metapath_reachable(tg, ["pa"])  # ends on another type

    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 16)).astype(np.float32)
    y = rng.integers(0, 3, 40)
    cfg = dict(num_features=16, num_classes=3, hidden_units=8, num_heads=(2,), dropout=0.0)
    jmodel = jhetero.HeteroHAN(jhetero.HeteroHANConfig(**cfg), meta_paths=paths)
    jmodel.coalesced(jg)  # the cache built outside the trace
    v = _init(jmodel, 0, jg, jnp.asarray(x), False)

    # the gradients against the JAX model's reference composition: on these
    # graphs the JAX packed path's are wrong (its dir_reduce gives the padded
    # entries the last row's cotangent, which jnp.take(er, dst)'s transpose
    # adds to er's last row; ROADMAP.md, faults of the reference)
    ref_graphs = [dataclasses.replace(g, node_perm=None) for g in jmodel.coalesced(jg)]

    def jloss(v):
        logits = jmodel.module.apply(v, ref_graphs, jnp.asarray(x), False)
        return jax_nll(logits, jnp.asarray(y), jnp.ones(40, bool))

    jout = jmodel.apply(v, jg, jnp.asarray(x), False)
    np.testing.assert_allclose(np.asarray(jmodel.module.apply(v, ref_graphs, jnp.asarray(x))),
                               np.asarray(jout), rtol=RTOL, atol=ATOL)
    jgrad = _grad(jloss, v)
    model = _load(thetero.HeteroHAN(thetero.HeteroHANConfig(**cfg), paths,
                                    torch.Generator().manual_seed(0)), v["params"])
    out = model(tg, torch.as_tensor(x))
    masked_nll(out, torch.as_tensor(y), torch.ones(40, dtype=torch.bool)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    _close_grads(model, jgrad["params"])
    first = model.coalesced(tg)
    assert all(a is b for a, b in zip(model.coalesced(tg), first))  # cached on identity
    _, tg2 = _acm_like(np.random.default_rng(2))
    assert all(a is not b for a, b in zip(model.coalesced(tg2), first))


# --- metrics, the step, the splits, the trainers ------------------------------------


@pytest.mark.parametrize("case", ["random", "only_predicted", "never_predicted", "one_class"])
def test_f1_scores_match_sklearn(case):
    from sklearn.metrics import f1_score

    rng = np.random.default_rng(0)
    yt, yp = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    if case == "only_predicted":  # class 5 has no true member
        yp[:3] = 5
    elif case == "never_predicted":  # class 3 is never predicted
        yp[yp == 3] = 0
    elif case == "one_class":
        yt, yp = np.full(9, 2), np.full(9, 2)
    got = ttrainer.f1_scores(yt, yp)
    want = (f1_score(yt, yp, average="micro"), f1_score(yt, yp, average="macro"))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_splits_equal_jax(graphs):
    """Each run's split (one draw after another from default_rng(seed)) and
    its masks equal the JAX package's."""
    _, _, jb, tb = graphs
    labels = np.asarray(jb[1])
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        js, ts = jax_split(labels, 0.5, 0.25, rng=jr), rand_train_test_idx(tb[1], 0.5, 0.25,
                                                                           rng=tr)
        jm, tm = jax_split_masks(js, labels.shape[0]), split_masks(ts, labels.shape[0])
        for k in ("train", "valid", "test"):
            np.testing.assert_array_equal(ts[k], np.asarray(js[k]))
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))


def test_han_step_matches_jax_adam(graphs):
    """Three han_step calls (dropout 0) from the JAX parameters against the
    same three steps composed from the JAX package: torch_adam, the masked
    NLL over max(y, 0), the post-update validation loss and accuracy."""
    _, td, jb, tb = graphs
    labels = np.asarray(jb[1])
    split = jax_split(labels, 0.5, 0.25, rng=np.random.default_rng(0))
    jm = jax_split_masks(split, labels.shape[0])
    cfg = dict(num_features=td.num_features, num_classes=3, hidden_units=8, num_heads=(4,),
               dropout=0.0)
    jmodel, jbatch = jhan.HAN(jhan.HANConfig(**cfg)), _jax_batch(jb)
    params = _init(jmodel, 4, jbatch, False)["params"]
    tx = torch_adam(0.005, 0.001)
    opt_state = tx.init(params)
    y = jnp.maximum(jbatch.y, 0)
    model = _load(than.HAN(than.HANConfig(**cfg), torch.Generator().manual_seed(0)), params)
    opt = ttrainer.make_optimizer(model, 0.005, 0.001)
    batch = _port_batch(tb)
    masks = {k: m for k, m in split_masks(split, labels.shape[0]).items()}
    value_and_grad = jax.jit(jax.value_and_grad(lambda p: jax_nll(
        jmodel.apply({"params": p}, jbatch, True), y, jm["train"])))
    for step in range(3):
        loss, grads = value_and_grad(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        logits = jmodel.apply({"params": params}, jbatch, False)
        want = (float(loss), float(jax_nll(logits, y, jm["valid"])),
                float(jax_acc(logits, y, jm["valid"])))
        got = [float(t) for t in ttrainer.han_step(model, opt, batch, masks, None)]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=f"step {step}")


def test_train_han_short_runs_end_finite(graphs):
    _, td, _, tb = graphs
    cfg = than.HANConfig(num_features=td.num_features, num_classes=3, hidden_units=4,
                         num_heads=(2,), dropout=0.3)
    res = ttrainer.train_han(cfg, _port_batch(tb),
                             ttrainer.HANTrainConfig(num_epochs=4, runs=2, patience=2))
    assert set(res) == {"test_acc_mean", "test_acc_std", "micro_f1_mean", "micro_f1_std",
                        "macro_f1_mean", "macro_f1_std", "time_per_run"}
    assert all(np.isfinite(v) for v in res.values()), res
    assert 0 <= res["macro_f1_mean"] <= 100


def test_train_han_minibatch_short_runs_end_finite(graphs):
    _, td, _, _ = graphs
    sampler = tsampler.HANNeighborSampler(td, num_neighbors=4, seed=0)
    cfg = than.HANConfig(num_features=td.num_features, num_classes=3, hidden_units=4,
                         num_heads=(2,), dropout=0.2)
    res = ttrainer.train_han_minibatch(
        cfg, torch.as_tensor(td.x), torch.as_tensor(td.y), sampler,
        ttrainer.HANSampleConfig(batch_size=8, num_neighbors=4, num_epochs=3, runs=2,
                                 patience=2))
    assert all(np.isfinite(v) for v in res.values()), res
    assert 0 <= res["test_acc_mean"] <= 100
