"""The port's host build against the JAX package's: generators, transforms
and every Incidence index array, element for element."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import allset_tpu.data.synthetic as jsyn
import allset_tpu.graph.transforms as jtr
import allset_tpu_torch.data.synthetic as tsyn
import allset_tpu_torch.graph.transforms as ttr
from allset_tpu_torch.graph import native as tnative
from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.graph.incidence import Incidence

HD_FIELDS = ("x", "y", "node", "edge")


def _assert_hd_equal(a, b):
    for f in HD_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.num_nodes, a.num_hyperedges, a.num_sl_edges) == (
        b.num_nodes, b.num_hyperedges, b.num_sl_edges)
    if a.norm is None:
        assert b.norm is None
    else:
        np.testing.assert_array_equal(a.norm, b.norm)


GRAPHS = {
    "scale_free": lambda m: m.scale_free_hypergraph(
        num_nodes=600, num_hyperedges=300, avg_edge_size=6, feature_dim=16, seed=3),
    "synthetic": lambda m: m.synthetic_hypergraph(
        num_nodes=120, num_hyperedges=60, feature_dim=8, seed=2),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_match_jax(name):
    _assert_hd_equal(GRAPHS[name](tsyn), GRAPHS[name](jsyn))


@pytest.mark.parametrize("norm", ["all_one", "deg_half_sym"])
def test_transforms_match_jax(norm):
    t = GRAPHS["scale_free"](tsyn)
    j = GRAPHS["scale_free"](jsyn)
    _assert_hd_equal(ttr.norm_construction(ttr.add_self_loops(t), norm),
                     jtr.norm_construction(jtr.add_self_loops(j), norm))
    rng = np.random.default_rng(0)
    node, edge = rng.integers(0, 40, 300), rng.integers(0, 20, 300)
    for a, b in zip(ttr.coalesce(node, edge), jtr.coalesce(node, edge)):
        np.testing.assert_array_equal(a, b)


def test_add_self_loops_skips_singleton_members():
    hd = ttr.HyperData(
        x=np.zeros((5, 2), np.float32), y=np.zeros(5, np.int64),
        node=np.array([0, 1, 2, 3]), edge=np.array([0, 0, 1, 2]),
        num_nodes=5, num_hyperedges=3,
    )
    out = ttr.add_self_loops(hd)
    # nodes 2 and 3 sit in singleton edges: only 0, 1 and the isolated 4
    np.testing.assert_array_equal(out.node[4:], [0, 1, 4])
    np.testing.assert_array_equal(out.edge[4:], [3, 4, 5])
    assert out.num_sl_edges == 3 and out.num_hyperedges == 6


INC_ARRAYS = ("node", "edge", "norm", "mask", "node_perm", "inv_node_perm",
              "node_sorted", "edge_by_node", "node_count", "edge_count")


def _assert_inc_equal(t, j):
    for f in INC_ARRAYS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    assert (t.num_nodes, t.num_edges, t.nnz, t.num_sl_edges) == (
        j.num_nodes, j.num_edges, j.nnz, j.num_sl_edges)
    # the CUDA reduce's per-segment CSR: searchsorted over the VALID entries
    nnz = t.nnz
    np.testing.assert_array_equal(
        t.edge_indptr.numpy(),
        np.searchsorted(np.asarray(j.edge)[:nnz], np.arange(j.num_edges + 1)))
    np.testing.assert_array_equal(
        t.node_indptr.numpy(),
        np.searchsorted(np.asarray(j.node_sorted)[:nnz], np.arange(j.num_nodes + 1)))


@pytest.mark.parametrize("bucket", [8, 256, 1024])
def test_incidence_matches_jax(bucket):
    t = ttr.norm_construction(ttr.add_self_loops(GRAPHS["scale_free"](tsyn)), "deg_half_sym")
    j = jtr.norm_construction(jtr.add_self_loops(GRAPHS["scale_free"](jsyn)), "deg_half_sym")
    ti, ji = t.to_incidence(bucket=bucket), j.to_incidence(bucket=bucket)
    _assert_inc_equal(ti, ji)
    # self-loop split: the nested real-edge incidence and the N-slot fields
    assert ti.real is not None and ji.real is not None
    _assert_inc_equal(ti.real, ji.real)
    for f in ("sl_node", "sl_mask", "sl_norm_full"):
        np.testing.assert_array_equal(getattr(ti, f).numpy(), np.asarray(getattr(ji, f)),
                                      err_msg=f)
    # the split directions carry the same counts
    for tdir, jdir in ((ti.v2e_split(), ji.v2e_split()), (ti.e2v_split(), ji.e2v_split())):
        np.testing.assert_array_equal(tdir.dst_count.numpy(), np.asarray(jdir.dst_count))
        assert (tdir.sl_mode, tdir.num_dst_total) == (jdir.sl_mode, jdir.num_dst_total)
        np.testing.assert_array_equal(tdir.norm.numpy(), np.asarray(jdir.norm))


def test_incidence_padding_sorts_last():
    inc = ttr.add_self_loops(GRAPHS["synthetic"](tsyn)).to_incidence()
    nnz = inc.nnz
    assert not inc.mask[nnz:].any() and inc.mask[:nnz].all()
    for ids, bound in ((inc.node_sorted, inc.num_nodes), (inc.edge, inc.num_edges),
                       (inc.edge_by_node[inc.inv_node_perm], inc.num_edges)):
        assert (ids[nnz:] == bound).all() and (ids[:nnz] < bound).all()
    d = inc.e2v()
    assert (d.dst_srcsort[:nnz] < inc.num_nodes).all()


def test_incidence_without_selfloops_has_no_split():
    inc = GRAPHS["synthetic"](tsyn).to_incidence()
    assert inc.real is None
    with pytest.raises(ValueError):
        inc.v2e_split()


def test_native_and_numpy_sorts_agree():
    keys = np.random.default_rng(1).integers(0, 50, 1000)
    np.testing.assert_array_equal(tnative.stable_argsort(keys, 50),
                                  np.argsort(keys, kind="stable"))


def test_batch_holds_tensors_on_its_device():
    hd = ttr.add_self_loops(GRAPHS["synthetic"](tsyn))
    b = Batch.from_hyperdata(hd, device="cpu")
    assert b.x.device.type == "cpu" and b.x.dtype == torch.float32
    assert b.inc.real.edge_indptr.dtype == torch.int32
    moved = b.inc.to("meta")
    assert moved.node.device.type == "meta" and moved.real.node.device.type == "meta"


def test_batch_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    hd = ttr.add_self_loops(GRAPHS["synthetic"](tsyn))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Batch.from_hyperdata(hd)


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, allset_tpu_torch\n"
        "for m in pkgutil.walk_packages(allset_tpu_torch.__path__, 'allset_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'allset_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
