"""The gather inside K1 (ops/cuda_segment.py::gather_segment_sum, which the
exchange's _Spmm runs; the counterpart of benchmarks/exp_fused_gather.py's
B11, ``take_gather``) through its plain version on the CPU: against the JAX
package's dir_spmm on the tiny graph of tests/conftest.py (forward with and
without a norm, and jax.vjp for _Spmm's backward, f32 at 2e-4, the
tests/test_parity_setgnn.py tolerance); a runs-axis norm run by run; the
identity CSR against take_gather in Pallas interpret mode, bit for bit; and
the routing (a CPU tensor takes the plain version, no launch counted)."""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import allset_tpu.graph.transforms as jtr
import allset_tpu_torch.graph.transforms as ttr
from allset_tpu.ops.exchange import dir_spmm as jax_spmm
from allset_tpu_torch.graph.incidence import chunk_plan
from allset_tpu_torch.ops import _kernels, cuda_segment as cs
from allset_tpu_torch.ops.exchange import dir_spmm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
F = 8
DIRS = ["v2e", "e2v", "v2e_split", "e2v_split"]


def _incs(hd, norm):
    """(torch, JAX) incidences of the conftest graph with its self-loops."""
    t = ttr.HyperData(x=hd.x, y=hd.y, node=hd.node, edge=hd.edge, num_nodes=hd.num_nodes,
                      num_hyperedges=hd.num_hyperedges)

    def build(tr, h):
        return tr.norm_construction(tr.add_self_loops(h), norm).to_incidence(bucket=64)

    return build(ttr, t), build(jtr, hd)


def _rows(inc, direction, d):
    return d.num_src + (inc.num_nodes if direction == "e2v_split" else 0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("direction", ["v2e", "e2v"])
def test_plain_is_jax_dir_spmm(hyperdata, direction, weighted):
    """gather_segment_sum_plain over the Direction's valid entries is JAX
    dir_spmm on an unsplit Direction, with the entry norm or without."""
    tinc, jinc = _incs(hyperdata, "deg_half_sym" if weighted else "all_one")
    td, jd = getattr(tinc, direction)(), getattr(jinc, direction)()
    w = np.random.default_rng(0).normal(size=(td.num_src, F)).astype(np.float32)
    want = jax_spmm(jnp.asarray(w), jd, norm=jd.norm if weighted else None)
    k = td.nnz
    got = cs.gather_segment_sum_plain(torch.from_numpy(w), td.src[:k], td.indptr, td.num_dst,
                                      td.norm[:k] if weighted else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("direction", DIRS)
def test_spmm_matches_jax_values_and_vjp(hyperdata, direction, weighted):
    """_Spmm (through dir_spmm) forward and backward against jax.vjp of
    the JAX dir_spmm, split Directions included."""
    tinc, jinc = _incs(hyperdata, "deg_half_sym" if weighted else "all_one")
    td, jd = getattr(tinc, direction)(), getattr(jinc, direction)()
    rng = np.random.default_rng(1)
    w = rng.normal(size=(_rows(tinc, direction, td), F)).astype(np.float32)
    out_ref, vjp = jax.vjp(lambda x: jax_spmm(x, jd, norm=jd.norm if weighted else None),
                           jnp.asarray(w))
    g = rng.normal(size=out_ref.shape).astype(np.float32)
    (dw_ref,) = vjp(jnp.asarray(g))
    wt = torch.from_numpy(w).requires_grad_()
    out = dir_spmm(wt, td, norm=td.norm if weighted else None)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_runs_norm_is_each_run_alone(dtype):
    """A [R, k] norm on a table of R runs folded into the width: each
    run's columns equal the run alone with its own [k] norm, bit for bit,
    in the plain version and in the one in the kernel's order."""
    gen = torch.Generator().manual_seed(3)
    counts = torch.randint(0, 6, (120,), generator=gen)
    counts[7] = 200  # a hub cut across chunks
    indptr = torch.zeros(121, dtype=torch.int32)
    indptr[1:] = torch.cumsum(counts, 0)
    k, R = int(indptr[-1]), 3
    plan = chunk_plan(indptr.numpy())
    w = torch.randn(40, R * F, generator=gen).to(dtype)
    ids = torch.randint(0, 40, (k,), generator=gen)
    norm = torch.rand(R, k, generator=gen)
    for fn in (lambda *a: cs.gather_segment_sum_plain(*a[:4], a[5]),
               cs.gather_segment_sum_planned):
        got = fn(w, ids, indptr, 120, plan, norm)
        for r in range(R):
            one = fn(w[:, r * F:(r + 1) * F].contiguous(), ids, indptr, 120, plan, norm[r])
            assert torch.equal(got[:, r * F:(r + 1) * F], one)
    # the kernel's order of additions and the plain one agree to rounding
    np.testing.assert_allclose(
        cs.gather_segment_sum_planned(w, ids, indptr, 120, plan, norm).float().numpy(),
        cs.gather_segment_sum_plain(w, ids, indptr, 120, norm).float().numpy(),
        rtol=1e-2 if dtype == torch.bfloat16 else 1e-5, atol=1e-2 if dtype == torch.bfloat16
        else 1e-5)


@pytest.fixture(scope="module")
def exp_gather():
    """benchmarks/exp_fused_gather.py with its ``pl`` in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "exp_fused_gather_fused_test", os.path.join(REPO, "benchmarks", "exp_fused_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = ns
    return mod


def _torch(a):
    """numpy (bf16 included) -> torch, bits unchanged."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_identity_csr_is_b11_take_gather(exp_gather, dtype):
    """With indptr = arange(n + 1) every segment is one entry, so the
    gather inside K1 computes B11's take(table, ids): bit for bit against
    take_gather in interpret mode ([300, 128] table, 1,024 ids)."""
    rng = np.random.default_rng(0)
    table = np.asarray(jnp.asarray(rng.normal(size=(300, 128)).astype(np.float32), dtype))
    ids = rng.integers(0, 300, size=1024).astype(np.int32)
    want = np.asarray(exp_gather.take_gather(jnp.asarray(table), jnp.asarray(ids), chunk=128))
    n = ids.shape[0]
    indptr = torch.arange(n + 1, dtype=torch.int32)
    got = cs.gather_segment_sum(_torch(table), torch.from_numpy(ids), indptr, n,
                                chunk_plan(indptr.numpy()))
    assert got.dtype == _torch(table).dtype
    np.testing.assert_array_equal(_torch(want).view(torch.int16 if dtype == jnp.bfloat16
                                                    else torch.int32).numpy(),
                                  got.view(torch.int16 if dtype == jnp.bfloat16
                                           else torch.int32).numpy())


def test_cpu_takes_the_plain_version_and_counts_no_launch(hyperdata):
    """On CPU tensors gather_segment_sum is its plain version and dir_spmm
    (forward and backward) launches nothing; the CUDA wrapper refuses CPU
    tensors before any launch."""
    tinc, _ = _incs(hyperdata, "deg_half_sym")
    d = tinc.v2e()
    k = d.nnz
    w = torch.randn(d.num_src, 13)  # a width the kernel pads on the card
    _kernels.reset_launches()
    got = cs.gather_segment_sum(w, d.src[:k], d.indptr, d.num_dst, d.plan, d.norm[:k])
    assert torch.equal(got, cs.gather_segment_sum_plain(w, d.src[:k], d.indptr, d.num_dst,
                                                        d.norm[:k]))
    wt = w.clone().requires_grad_()
    dir_spmm(wt, d, norm=d.norm).sum().backward()
    assert all(v == 0 for v in _kernels.launches.values())
    with pytest.raises(ValueError):
        cs.gather_segment_sum_cuda(w, d.src[:k], d.indptr, d.num_dst, d.plan)
    assert _kernels.launches["segment_sum_gather"] == 0


@pytest.mark.cuda
def test_kernel_is_the_pair_bit_for_bit():
    """On the card: the gather inside K1 equals B10 + scale + K1 and the
    plain version in its order of additions bit for bit (f32 and bf16,
    widths 8 and 264 and 3 x 264 with a runs-axis norm), one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    from allset_tpu_torch.ops import cuda_gather as cg

    gen = torch.Generator().manual_seed(0)
    counts = torch.randint(0, 7, (3000,), generator=gen)
    counts[1234] = 20_000
    indptr = torch.zeros(3001, dtype=torch.int32)
    indptr[1:] = torch.cumsum(counts, 0)
    k = int(indptr[-1])
    plan = chunk_plan(indptr.numpy()).to("cuda")
    ids = torch.randint(-2, 1002, (k,), generator=gen).cuda()
    ip = indptr.cuda()
    for dtype in (torch.float32, torch.bfloat16):
        for W, R in ((8, 1), (264, 1), (3 * 264, 3)):
            w = torch.randn(1000, W, generator=gen).to(dtype).cuda()
            norm = torch.rand(R, k, generator=gen).cuda()
            n = norm[0] if R == 1 else norm
            _kernels.reset_launches()
            got = cs.gather_segment_sum_cuda(w, ids, ip, 3000, plan, n)
            assert _kernels.launches["segment_sum_gather"] == 1
            pair = cs.segment_sum_cuda(cs.scale_rows(cg.gather_fwd_cuda(w, ids), n), ip, 3000,
                                       plan)
            assert torch.equal(got, pair)
            assert torch.equal(got, cs.gather_segment_sum_planned(w, ids, ip, 3000, plan, n))
