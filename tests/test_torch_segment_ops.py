"""The port's segment primitives (allset_tpu_torch/ops/segment.py) and the
composable exchange (dir_gather, dir_reduce, dir_propagate) against the
JAX package's on the oracles of tests/test_segment.py, f32 on the CPU
(the plain versions): sums through K1's plain version where the ids' sort
is given (after a gather into it where the ids are unsorted), a
scatter-add where not; torch_scatter semantics (padding dropped, mean over
counts clamped at 1, max 0 on an empty segment)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allset_tpu.ops as jops
import allset_tpu.ops.exchange as jex
from allset_tpu.graph.incidence import Incidence as JIncidence
from allset_tpu_torch.graph.incidence import Incidence, SegOrder, chunk_plan
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.ops import exchange as tex
from allset_tpu_torch.ops import segment as tops

from test_segment import dense_oracle


def _order(seg, m):
    """The ids' sort: a stable argsort (None where the ids are sorted and
    the padding comes last), indptr over the in-range ids and its plan."""
    perm = np.argsort(seg, kind="stable")
    valid = np.sort(seg[seg < m])
    indptr = torch.from_numpy(np.searchsorted(valid, np.arange(m + 1)).astype(np.int32))
    p = None if np.array_equal(perm, np.arange(len(seg))) else torch.from_numpy(perm)
    return SegOrder(p, indptr, chunk_plan(indptr.numpy()))


def _seg_data(rng, sorted_ids, nnz=200, m=17, f=8):
    seg = rng.integers(0, m, size=nnz)
    if sorted_ids:
        seg = np.sort(seg)
    seg = np.concatenate([seg, np.full(16, m)])  # out-of-range padding: dropped
    data = rng.normal(size=(len(seg), f)).astype(np.float32)
    return seg, data, m


@pytest.mark.parametrize("reduce", ["add", "mean", "max"])
@pytest.mark.parametrize("route", ["sorted_order", "unsorted_order", "sorted", "unsorted"])
def test_segment_reduce_matches_oracle_and_jax(rng, reduce, route):
    """With the ids' sort (K1's plain version, after a gather into the sort
    where the ids are unsorted) and without (a scatter-add)."""
    seg, data, m = _seg_data(rng, route.startswith("sorted"))
    order = _order(seg, m) if route.endswith("order") else None
    got = tops.segment_reduce(torch.from_numpy(data), torch.from_numpy(seg), m, reduce,
                              order=order)
    want = jops.segment_reduce(jnp.asarray(data), jnp.asarray(seg), m, reduce,
                               indices_are_sorted=route.startswith("sorted"))
    np.testing.assert_allclose(got.numpy(), dense_oracle(data, seg, m, reduce), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduce", ["add", "mean", "max"])
@pytest.mark.parametrize("route", ["sorted_order", "unsorted_order", "unsorted"])
def test_segment_reduce_gradient_matches_jax(rng, reduce, route):
    seg, data, m = _seg_data(rng, route == "sorted_order")
    data[5] = data[4]  # a tie for max
    seg[5] = seg[4]
    g = rng.normal(size=(m, data.shape[1])).astype(np.float32)
    x = torch.from_numpy(data).requires_grad_()
    out = tops.segment_reduce(x, torch.from_numpy(seg), m, reduce,
                              order=_order(seg, m) if route.endswith("order") else None)
    (out * torch.from_numpy(g)).sum().backward()
    want = jax.grad(lambda d: (jops.segment_reduce(d, jnp.asarray(seg), m, reduce,
                                                   route == "sorted_order") * g).sum())(
        jnp.asarray(data))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_segment_sum_empty_segments():
    seg = torch.tensor([0, 0, 5])
    got = tops.segment_sum(torch.ones(3, 2), seg, 7).numpy()
    assert got[0].sum() == 4.0 and got[5].sum() == 2.0
    assert got[[1, 2, 3, 4, 6]].sum() == 0.0


@pytest.mark.parametrize("with_order", [False, True])
def test_segment_softmax_matches_oracle_and_jax(rng, with_order):
    nnz, m, h = 120, 11, 4
    seg = np.sort(rng.integers(0, m, size=nnz))
    scores = rng.normal(size=(nnz, h)).astype(np.float32) * 5
    got = tops.segment_softmax(torch.from_numpy(scores), torch.from_numpy(seg), m, None,
                               order=_order(seg, m) if with_order else None).numpy()
    for s in range(m):
        rows = np.where(seg == s)[0]
        for head in range(h):
            if len(rows):
                e = np.exp(scores[rows, head] - scores[rows, head].max())
                np.testing.assert_allclose(got[rows, head], e / e.sum(), rtol=1e-5)
    want = jops.segment_softmax(jnp.asarray(scores), jnp.asarray(seg), m,
                                indices_are_sorted=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_order", [False, True])
def test_segment_softmax_mask_and_gradient_match_jax(rng, with_order):
    """Unsorted ids: padded entries (mask False, id m) get exactly 0; a
    segment whose entries are all masked stays finite; the gradient of a
    weighted sum matches jax.grad, with the ids' sort (K1 for the
    denominators and the gathers' transposes) and without."""
    nnz, m = 40, 6
    seg = np.concatenate([rng.integers(0, m - 1, size=nnz), np.full(8, m)])
    seg[-10:-8] = m - 1  # segment m-1: two entries, both masked
    mask = np.arange(len(seg)) < nnz - 2
    scores = rng.normal(size=(len(seg), 3)).astype(np.float32)
    w = rng.normal(size=(len(seg), 3)).astype(np.float32)
    s = torch.from_numpy(scores).requires_grad_()
    got = tops.segment_softmax(s, torch.from_numpy(seg), m, torch.from_numpy(mask),
                               order=_order(seg, m) if with_order else None)
    (got * torch.from_numpy(w)).sum().backward()
    assert (got[nnz - 2:] == 0).all() and torch.isfinite(got).all()
    fn = lambda x: jops.segment_softmax(x, jnp.asarray(seg), m, mask=jnp.asarray(mask))  # noqa
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(fn(jnp.asarray(scores))),
                               rtol=1e-6, atol=1e-7)
    want = jax.grad(lambda x: (fn(x) * w).sum())(jnp.asarray(scores))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_propagate_matches_dense_spmm_and_drops_padding(rng):
    n, m, f, nnz = 30, 12, 16, 150
    src = np.concatenate([rng.integers(0, n, size=nnz), [n]])  # padding: clamped gather
    dst = np.concatenate([rng.integers(0, m, size=nnz), [m]])  # padding: dropped
    norm = np.concatenate([rng.normal(size=nnz), [0.0]]).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    got = tops.propagate(torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(dst),
                         torch.from_numpy(norm), m, "add").numpy()
    A = np.zeros((m, n))
    for s, d, w in zip(src[:nnz], dst[:nnz], norm[:nnz]):
        A[d, s] += w
    np.testing.assert_allclose(got, A @ x, rtol=1e-4, atol=1e-4)
    want = jops.propagate(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(norm), m, "add")
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def _incs(rng, n=60, m=24, nnz=260):
    node = rng.integers(0, n, size=nnz)
    edge = rng.integers(0, m, size=nnz)
    kw = dict(num_nodes=n, num_edges=m, bucket=128)
    return JIncidence.from_arrays(node, edge, **kw), Incidence.from_arrays(node, edge, **kw)


@pytest.mark.parametrize("direction", ["v2e", "e2v"])
@pytest.mark.parametrize("reduce", ["add", "mean", "max"])
def test_dir_propagate_and_its_gradient_match_jax(rng, direction, reduce):
    """dir_gather (B10's plain version; backward: the permuted cotangent
    summed by K1's plain version over src_indptr) and dir_reduce (K1, or a
    scatter max) against the JAX composable exchange, forward and
    gradient."""
    jinc, tinc = _incs(rng)
    jd, td = getattr(jinc, direction)(), getattr(tinc, direction)()
    x = rng.normal(size=(td.num_src, 8)).astype(np.float32)
    g = rng.normal(size=(td.num_dst, 8)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    _kernels.reset_launches()
    out = tex.dir_propagate(xt, td, reduce=reduce)
    (out * torch.from_numpy(g)).sum().backward()
    assert sum(_kernels.launches.values()) == 0  # CPU tensors: plain versions
    fn = lambda v: jex.dir_propagate(v, jd, reduce=reduce)  # noqa: E731
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(fn(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    want = jax.grad(lambda v: (fn(v) * g).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_dir_gather_reads_every_padded_entry_clamped(rng):
    _, tinc = _incs(rng)
    d = tinc.v2e()
    x = torch.from_numpy(rng.normal(size=(d.num_src, 4)).astype(np.float32))
    got = tex.dir_gather(x, d)
    assert got.shape == (tinc.nnz_padded, 4)
    assert torch.equal(got, x[d.src.clamp_max(d.num_src - 1)])
