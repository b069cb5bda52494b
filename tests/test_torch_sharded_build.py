"""The edge partition of allset_tpu_torch/parallel/sharded.py on the host,
against the JAX package's ShardedExchange.build on the 8-device CPU mesh
that tests/conftest.py forces: every [D, ...] array equal, at D 2 and 4,
for equal row blocks and balanced cuts, split and unsplit; the placed
shards' row CSRs against JAX's block offsets; shard_entry_counts and
data/statistics.py against JAX's; the process-group helpers, and a rank's
Comm on a gloo group of one."""

import numpy as np
import pytest
import torch

import allset_tpu.data.synthetic as jsyn
import allset_tpu.graph.transforms as jtr
import allset_tpu_torch.data.synthetic as tsyn
import allset_tpu_torch.graph.transforms as ttr
from allset_tpu.data.statistics import dataset_statistics as jax_stats
from allset_tpu.parallel.mesh import make_mesh
from allset_tpu.parallel.sharded import ShardedExchange as JSX
from allset_tpu.parallel.sharded import shard_entry_counts as jax_counts
from allset_tpu_torch.data.statistics import dataset_statistics, print_statistics_table
from allset_tpu_torch.parallel import distributed
from allset_tpu_torch.parallel.sharded import ShardedExchange, shard_entry_counts

ARRAYS = ("src", "dst_local", "norm", "block_indptr", "src_sorted", "dst_srcsort_local",
          "norm_srcsort", "src_block_indptr", "perm_canon", "perm_canon_srcsort", "reasm",
          "dist_idx", "sl_mask", "sl_norm", "dst_count")
STATIC = ("nnz_pad_canon", "num_src", "num_src_padded", "num_dst", "num_dst_padded",
          "rows_per_shard", "s_blk", "chunk", "sl_mode", "num_dst_total")


def skewed_pair(seed=0, n=48, m=20, nnz=220, norm="all_one"):
    """(JAX, port) HyperData of a small graph whose hyperedge 0 holds half
    the entries (tests/test_sharded_epilogue.py's skewed graph), with its
    self-loops."""
    rng = np.random.default_rng(seed)
    edge = np.concatenate([np.zeros(nnz // 2, np.int64), rng.integers(0, m, size=nnz - nnz // 2)])
    node, edge = jtr.coalesce(rng.integers(0, n, size=nnz), edge)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=n)
    kw = dict(x=x, y=y, node=node, edge=edge, num_nodes=n, num_hyperedges=m)
    return tuple(tr.norm_construction(tr.add_self_loops(tr.HyperData(**kw)), norm)
                 for tr in (jtr, ttr))


@pytest.fixture(scope="module")
def incs():
    jh, th = skewed_pair()
    return jh.to_incidence(bucket=128), th.to_incidence(bucket=128)


@pytest.mark.parametrize("threshold", [1.05, float("inf")], ids=["balanced", "equal"])
@pytest.mark.parametrize("split", [None, False], ids=["split", "unsplit"])
@pytest.mark.parametrize("D", [2, 4])
def test_partition_equals_jax_array_for_array(incs, D, split, threshold):
    jinc, tinc = incs
    j = JSX.build(jinc, make_mesh(D), split=split, balance_threshold=threshold)
    t = ShardedExchange.build(tinc, D, split=split, balance_threshold=threshold)
    for name in ("v2e", "e2v"):
        jd, td = getattr(j, name), getattr(t, name)
        for f in ARRAYS:
            a, b = getattr(jd, f), getattr(td, f)
            assert (a is None) == (b is None), (name, f)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{name}.{f}")
        for f in STATIC:
            assert getattr(td, f) == getattr(jd, f), (name, f)
        # valid entries per shard, as the JAX tests count them
        np.testing.assert_array_equal(td.shard_nnz, np.asarray((jd.src < jd.num_src).sum(1)))
    assert t.v2e.sl_mode == ("append" if split is None else "none")
    assert (t.e2v.reasm is not None) == (threshold < 2)  # the skew fires the balanced cuts


@pytest.mark.parametrize("D", [1, 2, 4])
def test_placed_shards_refine_the_jax_block_offsets(incs, D):
    """Each shard's row CSRs, sampled every s_blk rows, are JAX's
    block_indptr/src_block_indptr; a Comm of all D shards places all of
    them, a rank's Comm its own."""
    _, tinc = incs
    shex = ShardedExchange.build(tinc, D, balance_threshold=1.05)
    placed = shex.shard(distributed.local_comm(D, "cpu"))
    for sd, pd in ((shex.v2e, placed.v2e), (shex.e2v, placed.e2v)):
        assert [sh.index for sh in pd.local] == list(range(D))
        for sh in pd.local:
            d, k = sh.index, sh.nnz
            np.testing.assert_array_equal(sh.indptr[::sd.s_blk].numpy(), sd.block_indptr[d])
            nb = -(-(sd.num_src + 1) // sd.s_blk)
            np.testing.assert_array_equal(sh.src_indptr[::sd.s_blk].numpy(),
                                          sd.src_block_indptr[d, :nb])
            assert int(sh.indptr[-1]) == int(sh.src_indptr[-1]) == k
            assert sh.plan.num_partials >= 0 and int(sh.plan.chunks[:, 1].max()) == k
        assert sum(sh.nnz for sh in pd.local) == sum(sd.shard_nnz)
        # each shard's rows: those its entries reach lie inside them
        rows = sd.shard_rows
        assert sum(rows) == sd.num_dst and max(rows) <= sd.rows_per_shard
        for sh in pd.local:
            assert sh.nnz == 0 or int(sh.dst_local.max()) < rows[sh.index]
    rank1 = distributed.Comm(D, (D - 1,), torch.device("cpu"))
    assert [sh.index for sh in shex.shard(rank1).v2e.local] == [D - 1]


def test_shard_entry_counts_equal_jax(incs):
    jinc, tinc = incs
    for ids, num in ((tinc.edge[: tinc.nnz].numpy(), tinc.num_edges),
                     (np.sort(tinc.node[: tinc.nnz].numpy()), tinc.num_nodes)):
        for D in (2, 4, 8):
            got, want = shard_entry_counts(ids, num, D), jax_counts(ids, num, D)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)


def test_dataset_statistics_equal_jax(capsys):
    """tests/test_shard_balance.py's scale-free graph: every statistic, the
    shard skews included, equal to JAX's; the balanced cut lowers the Zipf
    node side's skew."""
    kw = dict(num_nodes=512, num_hyperedges=128, avg_edge_size=8, exponent=1.8,
              feature_dim=4, seed=2)
    jh, th = jsyn.scale_free_hypergraph(**kw), tsyn.scale_free_hypergraph(**kw)
    got, want = dataset_statistics(th), jax_stats(jh)
    assert got == want
    assert got["shard8_e2v_skew_balanced"] < got["shard8_e2v_skew_rowblock"]
    table = print_statistics_table([("sf", th)])
    assert capsys.readouterr().out.strip() == table
    assert table.splitlines()[0] == "dataset," + ",".join(got)


def test_process_group_helpers_without_a_group():
    assert distributed.host_major_ranks(8, 4) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError):
        distributed.host_major_ranks(6, 4)
    comm = distributed.local_comm(3, "cpu")
    assert comm.shards == (0, 1, 2) and comm.world == 1
    distributed.reset_collectives()
    parts = [torch.full((2, 3), float(i), dtype=torch.bfloat16) for i in range(3)]
    assert torch.equal(comm.all_gather(parts), torch.cat(parts))
    red = comm.all_reduce(parts)
    assert red.dtype == torch.float32 and torch.equal(red, torch.full((2, 3), 3.0))
    assert dict(distributed.collectives) == {"all_gather": 1, "all_reduce": 1}
    assert dict(distributed.collective_bytes) == {"all_gather": 36, "all_reduce": 24}
    assert "in-process" in distributed.comm_summary(comm)


def test_gloo_world_one_moves_bfloat16(tmp_path):
    """A rank's Comm over a real gloo group (world 1, in this process):
    gloo moves no bfloat16, so the all-gather moves its bytes; the
    all-reduce sums in f32."""
    import torch.distributed as dist

    dev = distributed.init_process_group("gloo", 0, 1, "file://" + str(tmp_path / "store"),
                                         device="cpu", timeout_s=60)
    try:
        comm = distributed.edge_comm(dev)
        assert comm.shards == (0,) and comm.world == 1 and "gloo" in distributed.comm_summary(comm)
        x = torch.randn(5, 7).to(torch.bfloat16)
        assert torch.equal(comm.all_gather([x]), x)
        assert torch.equal(comm.all_reduce([x]), x.float())
    finally:
        dist.destroy_process_group()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default without a card")
def test_entry_points_default_to_the_card_and_raise_without_one():
    from allset_tpu_torch.parallel import step

    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_comm(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.init_process_group(rank=0, world_size=1)
    with pytest.raises(ValueError, match="nccl"):
        distributed.init_process_group("nccl", 0, 1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        step.run(1, step.StepConfig())
