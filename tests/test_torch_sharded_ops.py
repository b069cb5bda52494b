"""The sharded spmm of allset_tpu_torch/parallel/sharded.py against the JAX
package's sharded path (shard_map on the 8-device CPU mesh of
tests/conftest.py) on the same partition, D 2 and 4: values and gradients
of dir_spmm on a ShardedDirection for 'add', 'mean' and 'max', weighted
and unweighted, on the self-loop split with balanced cuts; the traced
canonical-order norm (LearnMask) and its SDDMM gradient on the unsplit
build, for one run and a [R, nnz_pad] runs norm; and the collectives of
each against the JAX census accounting. tests/test_parallel.py's
tolerance, rtol 1e-4 and atol 1e-5 in f32. The port runs its D shard
bodies in this process (distributed.local_comm); the JAX side is jitted,
all cases of a D in one program."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allset_tpu.ops.exchange import dir_spmm as jax_spmm
from allset_tpu.parallel.mesh import make_mesh
from allset_tpu.parallel.sharded import ShardedExchange as JSX
from allset_tpu.parallel.sharded import sharded_comm_stats as jax_stats
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.ops.exchange import dir_spmm
from allset_tpu_torch.parallel import distributed
from allset_tpu_torch.parallel.sharded import ShardedExchange, sharded_comm_stats
from test_torch_sharded_build import skewed_pair

RTOL, ATOL, F, R = 1e-4, 1e-5, 8, 3
REDUCES = [("add", True), ("add", False), ("mean", True), ("max", True), ("max", False)]


def _cases(jshex, tshex, inc_nodes, rng):
    """(JAX direction, port direction, reduce, weighted, w, cotangent) per
    direction and reduce."""
    out = []
    for name in ("v2e", "e2v"):
        jd, td = getattr(jshex, name), getattr(tshex, name)
        rows = td.num_src + (inc_nodes if td.sl_mode == "add" else 0)
        out_rows = td.num_dst_total if td.sl_mode != "none" else td.num_dst
        for reduce, weighted in REDUCES:
            out.append((name, jd, td, reduce, weighted,
                        rng.normal(size=(rows, F)).astype(np.float32),
                        rng.normal(size=(out_rows, F)).astype(np.float32)))
    return out


def _norm_cases(jshex, tshex, npad, rng):
    """LearnMask cases: (name, JAX dir, port dir, w, canonical norm, g)."""
    out = []
    base = np.asarray(jshex.v2e.norm).max()  # nonzero norms exist
    assert base > 0
    for name in ("v2e", "e2v"):
        jd, td = getattr(jshex, name), getattr(tshex, name)
        for runs in (None, R):
            lead = () if runs is None else (runs,)
            width = F * (runs or 1)
            nc = rng.uniform(0.5, 1.5, size=lead + (npad,)).astype(np.float32)
            out.append((name, jd, td, rng.normal(size=(td.num_src, width)).astype(np.float32),
                        nc, rng.normal(size=(td.num_dst, width)).astype(np.float32), runs))
    return out


@pytest.fixture(scope="module", params=[2, 4])
def ref(request):
    """The port's placed exchanges (split with balanced cuts; unsplit) and
    the JAX values and gradients of every case at D."""
    D = request.param
    jh, th = skewed_pair(norm="deg_half_sym")
    jinc, tinc = jh.to_incidence(bucket=128), th.to_incidence(bucket=128)
    mesh = make_mesh(D)
    comm = distributed.local_comm(D, "cpu")
    jsplit, jfull = JSX.build(jinc, mesh).shard(), JSX.build(jinc, mesh, split=False).shard()
    tsplit = ShardedExchange.build(tinc, D)
    tfull = ShardedExchange.build(tinc, D, split=False)
    assert tsplit.e2v.reasm is not None  # balanced cuts at the default threshold
    rng = np.random.default_rng(D)
    cases = _cases(jsplit, tsplit.shard(comm), tinc.num_nodes, rng)
    ncases = _norm_cases(jfull, tfull.shard(comm), tinc.nnz_padded, rng)
    # every canonical padding entry carries norm 0 upstream (importance * norm)
    for c in ncases:
        c[4][..., tinc.nnz:] = 0.0

    def f(ws, ns):
        outs = [jax_spmm(w, jd, norm=jd.norm if wt else None, reduce=red)
                for (_, jd, _, red, wt, _, _), w in zip(cases, ws)]
        for (_, jd, _, _, _, _, runs), w, n in zip(ncases, ws[len(cases):], ns):
            if runs is None:
                outs.append(jax_spmm(w, dataclasses.replace(jd, norm_canon=n), norm=n,
                                     norm_grad=True))
            else:  # run by run (the JAX package vmaps them)
                outs.append(jnp.concatenate([
                    jax_spmm(w[:, r * F:(r + 1) * F], dataclasses.replace(jd, norm_canon=n[r]),
                             norm=n[r], norm_grad=True) for r in range(runs)], axis=1))
        return outs

    @jax.jit
    def vjp(ws, ns, gs):
        outs, back = jax.vjp(f, ws, ns)
        return outs, back(gs)

    ws = [jnp.asarray(c[5]) for c in cases] + [jnp.asarray(c[3]) for c in ncases]
    ns = [jnp.asarray(c[4]) for c in ncases]
    gs = [jnp.asarray(c[6]) for c in cases] + [jnp.asarray(c[5]) for c in ncases]
    outs, (dws, dns) = jax.tree_util.tree_map(np.asarray, vjp(ws, ns, gs))
    k = len(cases)
    return dict(D=D, cases=cases, ncases=ncases, outs=outs[:k], dws=dws[:k],
                nouts=outs[k:], ndws=dws[k:], dns=dns, jsplit=jsplit, jfull=jfull,
                tsplit=tsplit.shard(comm), tfull=tfull.shard(comm))


@pytest.mark.parametrize("reduce,weighted", REDUCES)
def test_sharded_spmm_matches_jax(ref, reduce, weighted):
    """dir_spmm on the port's ShardedDirections against the JAX sharded
    dir_spmm, both directions; one all-gather forward and one all-reduce
    backward per call ('max' too), and no kernel launch on the CPU."""
    done = 0
    for i, (name, _, td, red, wt, w, g) in enumerate(ref["cases"]):
        if (red, wt) != (reduce, weighted):
            continue
        wt_ = torch.from_numpy(w).requires_grad_()
        distributed.reset_collectives()
        _kernels.reset_launches()
        out = dir_spmm(wt_, td, norm=td.norm if wt else None, reduce=red)
        out.backward(torch.from_numpy(g))
        np.testing.assert_allclose(out.detach().numpy(), ref["outs"][i], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} values")
        np.testing.assert_allclose(wt_.grad.numpy(), ref["dws"][i], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} grads")
        assert dict(distributed.collectives) == {"all_gather": 1, "all_reduce": 1}
        assert sum(_kernels.launches.values()) == 0
        done += 1
    assert done == 2


@pytest.mark.parametrize("runs", [None, R], ids=["one_run", "runs"])
def test_sharded_learnmask_norm_and_sddmm_match_jax(ref, runs):
    """The traced canonical-order norm (split=False) through dir_spmm with
    norm_grad: values, dw and dnorm against JAX's (one run; R runs folded
    into the width against JAX run by run); dnorm adds one all-reduce."""
    done = 0
    for i, (name, _, td, w, nc, g, r) in enumerate(ref["ncases"]):
        if r != runs:
            continue
        wt = torch.from_numpy(w).requires_grad_()
        nt = torch.from_numpy(nc).requires_grad_()
        distributed.reset_collectives()
        out = dir_spmm(wt, dataclasses.replace(td, norm_canon=nt), norm=nt, norm_grad=True)
        out.backward(torch.from_numpy(g))
        for got, want, what in ((out.detach(), ref["nouts"][i], "values"),
                                (wt.grad, ref["ndws"][i], "dw"), (nt.grad, ref["dns"][i], "dnorm")):
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {what}")
        assert np.abs(ref["dns"][i]).max() > 0
        assert dict(distributed.collectives) == {"all_gather": 1, "all_reduce": 2}
        done += 1
    assert done == 2


def test_norm_gradient_without_a_traced_norm_raises(ref):
    td = ref["tfull"].v2e
    w = torch.zeros(td.num_src, F)
    with pytest.raises(NotImplementedError):
        dir_spmm(w, td, norm=torch.ones(3), norm_grad=True)


@pytest.mark.parametrize("learn_mask", [False, True])
def test_comm_stats_equal_the_jax_census_accounting(ref, learn_mask):
    """sharded_comm_stats counts JAX's collectives and, in f32, its bytes;
    with the fused epilogue too (JAX counts the d_sl all-gather's bytes,
    the port also the all-gather itself)."""
    W = 36
    for t, j in ((ref["tsplit"], ref["jsplit"]), (ref["tfull"], ref["jfull"])):
        got, want = sharded_comm_stats(t, W, learn_mask=learn_mask), jax_stats(j, W,
                                                                              learn_mask=learn_mask)
        assert got.pop("allgathers_bwd") == 0
        assert got == want
        got = sharded_comm_stats(t, W, epilogue_hc=32, epilogue_layers=2)
        want = jax_stats(j, W, epilogue_hc=32, epilogue_layers=2)
        assert got.pop("allgathers_bwd") == int(t.e2v.sl_mode == "add")
        assert got == want
