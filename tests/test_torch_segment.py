"""K1's plain version (the CPU path of segment_sum) against the JAX
package's Pallas sorted segment-sum, run in interpret mode on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allset_tpu.graph.incidence import Incidence as JIncidence
from allset_tpu.ops.pallas_segment import LANE, _sorted_segment_sum_fwd
from allset_tpu_torch.graph.incidence import Incidence
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.ops.cuda_segment import segment_sum, segment_sum_cuda

# f32: the JAX segment tests' tolerance; bf16: one bf16 ulp (2^-7 relative)
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _graph(rng, n=200, m=100, nnz=700):
    node = rng.integers(0, n, size=nnz)
    edge = np.sort(rng.integers(0, m, size=nnz))
    edge[:60] = 7  # one hot segment; many ids in [0, m) stay empty
    edge = np.sort(edge)
    return node, edge, n, m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["edge", "node"])
def test_segment_sum_plain_matches_pallas_interpret(rng, dtype, order):
    node, edge, n, m = _graph(rng)
    jinc = JIncidence.from_arrays(node, edge, num_nodes=n, num_edges=m, bucket=128,
                                  kernel_s_blk=16)
    tinc = Incidence.from_arrays(node, edge, num_nodes=n, num_edges=m, bucket=128)
    assert jinc.nnz_padded == tinc.nnz_padded
    F = LANE
    msgs = rng.normal(size=(jinc.nnz_padded, F)).astype(np.float32)
    msgs[~np.asarray(jinc.mask)] = 0.0
    if order == "edge":
        ids, bptr, nseg, nseg_pad = jinc.edge, jinc.edge_block_indptr, m, jinc.num_edges_padded
        indptr = tinc.edge_indptr
    else:
        ids, bptr, nseg, nseg_pad = (jinc.node_sorted, jinc.node_block_indptr, n,
                                     jinc.num_nodes_padded)
        indptr = tinc.node_indptr
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = _sorted_segment_sum_fwd(
        jnp.asarray(msgs, jd), ids.reshape(-1, LANE), bptr, nseg_pad, 16, 512, True
    )[:nseg]
    td = getattr(torch, dtype)
    got = segment_sum(torch.from_numpy(msgs).to(td), indptr, nseg)
    assert got.dtype == td and got.shape == (nseg, F)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_segment_sum_skips_rows_past_indptr_end():
    indptr = torch.tensor([0, 0, 3, 3, 5], dtype=torch.int32)  # empty segments
    msgs = torch.arange(7 * 8, dtype=torch.float32).reshape(7, 8)
    msgs[5:] = float("nan")  # padded tail
    out = segment_sum(msgs, indptr, 4)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[1], msgs[0:3].sum(0))
    torch.testing.assert_close(out[3], msgs[3:5].sum(0))
    assert (out[0] == 0).all() and (out[2] == 0).all()


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    _kernels.reset_launches()
    indptr = torch.tensor([0, 2, 4], dtype=torch.int32)
    segment_sum(torch.ones(4, 8), indptr, 2)
    assert sum(_kernels.launches.values()) == 0
    with pytest.raises(ValueError):  # the kernel wrapper never runs on the CPU
        segment_sum_cuda(torch.ones(4, 8), indptr, 2)
    with pytest.raises(ValueError):  # other devices raise; no fallback
        segment_sum(torch.ones(4, 8, device="meta"), indptr, 2)


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
