"""K1's plain version (the CPU path of segment_sum) and its chunk plan
against the JAX package's Pallas sorted segment-sum, run in interpret
mode on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allset_tpu.graph.incidence import Incidence as JIncidence
from allset_tpu.ops.pallas_segment import LANE, _sorted_segment_sum_fwd
from allset_tpu_torch.graph.incidence import ROW_BUDGET, Incidence, chunk_plan
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.ops.cuda_segment import (
    segment_sum,
    segment_sum_cuda,
    segment_sum_planned,
)

# f32: the JAX segment tests' tolerance; bf16: one bf16 ulp (2^-7 relative)
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _graph(rng, n=200, m=100, nnz=700, hot=60):
    node = rng.integers(0, n, size=nnz)
    edge = np.sort(rng.integers(0, m, size=nnz))
    edge[:hot] = 7  # one hot segment; many ids in [0, m) stay empty
    edge = np.sort(edge)
    node[:hot] = 3  # and one hot node
    return node, edge, n, m


def _jax_segment_sum(rng, dtype, order, hot):
    """(msgs [nnz_pad, 128] f32, the torch Incidence's indptr, its plan,
    nseg, the Pallas kernel's result in interpret mode)."""
    node, edge, n, m = _graph(rng, hot=hot)
    jinc = JIncidence.from_arrays(node, edge, num_nodes=n, num_edges=m, bucket=128,
                                  kernel_s_blk=16)
    tinc = Incidence.from_arrays(node, edge, num_nodes=n, num_edges=m, bucket=128)
    assert jinc.nnz_padded == tinc.nnz_padded
    msgs = rng.normal(size=(jinc.nnz_padded, LANE)).astype(np.float32)
    msgs[~np.asarray(jinc.mask)] = 0.0
    if order == "edge":
        ids, bptr, nseg, nseg_pad = jinc.edge, jinc.edge_block_indptr, m, jinc.num_edges_padded
        indptr, plan = tinc.edge_indptr, tinc.edge_plan
    else:
        ids, bptr, nseg, nseg_pad = (jinc.node_sorted, jinc.node_block_indptr, n,
                                     jinc.num_nodes_padded)
        indptr, plan = tinc.node_indptr, tinc.node_plan
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = _sorted_segment_sum_fwd(
        jnp.asarray(msgs, jd), ids.reshape(-1, LANE), bptr, nseg_pad, 16, 512, True
    )[:nseg]
    return msgs, indptr, plan, nseg, np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["edge", "node"])
def test_segment_sum_plain_matches_pallas_interpret(rng, dtype, order):
    msgs, indptr, plan, nseg, want = _jax_segment_sum(rng, dtype, order, hot=60)
    td = getattr(torch, dtype)
    got = segment_sum(torch.from_numpy(msgs).to(td), indptr, nseg, plan)
    assert got.dtype == td and got.shape == (nseg, LANE)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["edge", "node"])
def test_planned_order_matches_pallas_interpret_at_every_width(rng, dtype, order):
    """The kernel's order of additions (chunk partials, then the combine in
    chunk order), with a hot segment of 300 entries over several chunks,
    against the Pallas kernel; and the same bits at W=8 and W=264."""
    msgs, indptr, plan, nseg, want = _jax_segment_sum(rng, dtype, order, hot=300)
    assert plan.cuts.shape[0] >= 1 and int(plan.cuts[:, 2].max()) >= 5
    td = getattr(torch, dtype)
    got = segment_sum_planned(torch.from_numpy(msgs).to(td), indptr, nseg, plan)
    assert got.dtype == td and got.shape == (nseg, LANE)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])
    wide = torch.from_numpy(rng.normal(size=(msgs.shape[0], 264)).astype(np.float32)).to(td)
    narrow = segment_sum_planned(wide[:, :8].contiguous(), indptr, nseg, plan)
    assert torch.equal(segment_sum_planned(wide, indptr, nseg, plan)[:, :8], narrow)


def _plan_cases():
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 9, 400)
    counts[rng.random(400) < 0.3] = 0  # empty segments, some at chunk ends
    counts[100] = 1000  # a hot segment over 15 chunks
    return {
        "skewed": np.r_[0, np.cumsum(counts)],
        # segments of exactly one chunk: every chunk boundary on a segment start
        "aligned": np.arange(0, 10 * ROW_BUDGET + 1, ROW_BUDGET),
        # empty segments at both ends and at a cut inside a long segment
        "empties": np.array([0, 0, 0, 150, 150, 150, 200, 200, 256, 256]),
        "all_empty": np.zeros(5, np.int64),
        # long runs of empty segments, between entries and at the end (the
        # bench graph's node order: 120,634 of 131,072 nodes have none)
        "empty_runs": np.r_[np.zeros(3000, np.int64), np.full(2000, 7), np.full(4000, 40)],
        "no_segments": np.zeros(1, np.int64),
    }


@pytest.mark.parametrize("case", sorted(_plan_cases()))
def test_chunk_plan_covers_every_entry_and_segment_once(case):
    ip = _plan_cases()[case]
    plan = chunk_plan(ip)
    ch, cuts = plan.chunks.numpy().astype(np.int64), plan.cuts.numpy().astype(np.int64)
    n, num_seg = int(ip[-1]), ip.shape[0] - 1
    # the chunks tile [0, n) in order, none over its budget; the padded tail
    # (rows past indptr[-1]) is never planned
    assert ch[0, 0] == 0 and ch[-1, 1] == n
    assert (ch[1:, 0] == ch[:-1, 1]).all() and (ch[:, 1] - ch[:, 0] <= ROW_BUDGET).all()
    # and no chunk writes more than ROW_BUDGET + 1 segments, empty ones too
    assert (ch[:, 3] - ch[:, 2] <= ROW_BUDGET + 1).all()
    # each segment's rows, summed through the plan, once each
    rows = np.zeros(n, np.int64)
    direct = np.zeros(num_seg, np.int64)
    part_seg = np.full(plan.num_partials, -1)
    for r0, r1, lo, hi, head_row, tail_row in ch:
        assert 0 <= lo <= hi <= num_seg
        for s in range(lo, hi):
            a, b = ip[s], ip[s + 1]
            rows[max(a, r0):min(b, r1)] += 1
            if a < r0:
                assert part_seg[head_row] == -1 and lo == s
                part_seg[head_row] = s
            elif b > r1:
                assert part_seg[tail_row] == -1 and s == hi - 1
                part_seg[tail_row] = s
            else:
                direct[s] += 1
    assert (rows == 1).all()
    for s, first, count in cuts:
        assert direct[s] == 0 and count >= 2
        assert (part_seg[first:first + count] == s).all()
        direct[s] = 1
    assert (direct == 1).all() and (part_seg >= 0).all()
    if case == "skewed":
        assert int(cuts[:, 2].max()) == -(-1000 // ROW_BUDGET)


@pytest.mark.parametrize("case", ["skewed", "empties", "all_empty", "empty_runs"])
def test_planned_order_sums_each_segment_and_skips_the_padded_tail(case):
    ip = _plan_cases()[case]
    n = int(ip[-1])
    msgs = torch.from_numpy(np.random.default_rng(3).normal(size=(n + 5, 16))
                            .astype(np.float32))
    msgs[n:] = float("nan")  # padded tail
    indptr = torch.from_numpy(ip.astype(np.int32))
    plan = chunk_plan(ip)
    got = segment_sum_planned(msgs, indptr, ip.shape[0] - 1, plan)
    torch.testing.assert_close(got, segment_sum(msgs, indptr, ip.shape[0] - 1, plan),
                               rtol=1e-5, atol=1e-5)


def test_segment_sum_skips_rows_past_indptr_end():
    indptr = torch.tensor([0, 0, 3, 3, 5], dtype=torch.int32)  # empty segments
    msgs = torch.arange(7 * 8, dtype=torch.float32).reshape(7, 8)
    msgs[5:] = float("nan")  # padded tail
    out = segment_sum(msgs, indptr, 4, chunk_plan(indptr))
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[1], msgs[0:3].sum(0))
    torch.testing.assert_close(out[3], msgs[3:5].sum(0))
    assert (out[0] == 0).all() and (out[2] == 0).all()


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    _kernels.reset_launches()
    indptr = torch.tensor([0, 2, 4], dtype=torch.int32)
    plan = chunk_plan(indptr)
    segment_sum(torch.ones(4, 8), indptr, 2, plan)
    assert sum(_kernels.launches.values()) == 0
    with pytest.raises(ValueError):  # the kernel wrapper never runs on the CPU
        segment_sum_cuda(torch.ones(4, 8), indptr, 2, plan)
    with pytest.raises(ValueError):  # other devices raise; no fallback
        segment_sum(torch.ones(4, 8, device="meta"), indptr, 2, plan)


def test_failed_or_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_kernels, "_SO", str(tmp_path / "libkernels.so"))
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "false")  # exits 1
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _kernels.build(force=True)
    monkeypatch.undo()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels._nvcc()
