"""The edge-partitioned step on real gloo process groups: one spawn of
``allset_tpu_torch.parallel.step.train_worker`` per world size (2 and 4
ranks, one torch thread each, every join under a timeout) for the whole
module. Two Adam steps with dropout on leave the parameters bit-identical
on every rank; each step's collectives are one all-gather per exchange
forward (and the 'add' direction's d_sl all-gather), one all-reduce of
``dw`` and one of the epilogue's parameter gradients per exchange
backward, no all-to-all, matching the JAX census accounting
(``allset_tpu/parallel/sharded.py::sharded_comm_stats``, which
tests/test_sharded_epilogue.py pins to the compiled program) on the same
partition; and the losses equal those of the same shards run one after
another in one process."""

import dataclasses

import numpy as np
import pytest

from allset_tpu.graph.batch import Batch as JBatch
from allset_tpu.parallel.mesh import make_mesh
from allset_tpu.parallel.sharded import ShardedExchange as JSX
from allset_tpu.parallel.sharded import sharded_comm_stats as jax_stats
from allset_tpu_torch.parallel import step

CFG = step.StepConfig(nodes=512, edges=256, edge_size=6, features=16, classes=4, hidden=64,
                      heads=4, steps=2, seed=0)


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    """(world size, every rank's result, the in-process run of as many
    shard bodies)."""
    W = request.param
    ranks = step.run(W, CFG, device="cpu", timeout_s=240)
    return W, ranks, step.run(0, CFG, device="cpu", bodies=W)[0]


def test_ranks_end_with_bit_identical_parameters(world):
    W, ranks, _ = world
    assert len(ranks) == W
    assert len({r["digest"] for r in ranks}) == 1
    assert len({tuple(r["losses"]) for r in ranks}) == 1
    assert all(np.isfinite(r["losses"]).all() for r in ranks)


def test_collective_census_equals_the_jax_accounting(world):
    """Issued per step on every rank: what the port's sharded_comm_stats
    counts, whose counts and bytes equal the JAX accounting's on the JAX
    build of the same graph at the same D (the d_sl all-gather, which the
    JAX accounting counts only in bytes, besides)."""
    W, ranks, _ = world
    assert all(step.census_matches(r) for r in ranks)
    data = step.make_data(CFG)
    jb = JBatch.from_hyperdata(_jax_data(data), bucket=1024)
    want = jax_stats(JSX.build(jb.inc, make_mesh(W)), 72, 4, epilogue_hc=CFG.hidden,
                     epilogue_layers=CFG.mlp_layers)
    got = dict(ranks[0]["stats"])
    assert got.pop("allgathers_bwd") == 1
    assert got == want
    counts = ranks[0]["per_step"][-1]["counts"]
    assert counts == {"all_gather": want["reassembly_fwd"] + 1, "all_reduce": want["psums_bwd"]}
    assert want["reassembly_fwd"] == 2 and want["psums_bwd"] == 4  # per exchange: 1 and 2


def test_losses_equal_the_in_process_shard_bodies(world):
    W, ranks, local = world
    np.testing.assert_allclose(ranks[0]["losses"], local["losses"], rtol=1e-5, atol=1e-6)
    assert ranks[0]["entries"] == local["entries"]
    for a, b in zip(local["per_step"], ranks[0]["per_step"]):
        assert (a["counts"], a["bytes"]) == (b["counts"], b["bytes"])
    # both directions partition the same real entries
    assert sum(local["entries"]["e2v"]) == sum(local["entries"]["v2e"])


def _jax_data(d):
    """The port's HyperData as the JAX package's."""
    import allset_tpu.graph.transforms as jtr

    return jtr.HyperData(**{f.name: getattr(d, f.name) for f in dataclasses.fields(d)})


def test_a_failing_rank_raises_in_the_parent():
    from allset_tpu_torch.parallel import distributed

    with pytest.raises(RuntimeError, match="rank"):
        distributed.spawn(step.train_worker, 2, (None,), timeout_s=120)
