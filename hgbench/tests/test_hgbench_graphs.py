"""The frozen generators against the port's, the relabelling, the
self-loop rule."""

import numpy as np
import pytest

from hgbench import graphs


def _port():
    from allset_tpu_torch.data import synthetic

    return synthetic


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 11])
def test_cornell_like_is_the_ports(seed):
    kw = dict(num_nodes=500, num_hyperedges=400, avg_edge_size=6, num_classes=11,
              feature_dim=100, feature_noise=1.0, exponent=1.2, homophily=0.6, seed=seed)
    a, b = graphs.cornell_like_hypergraph(**kw), _port().cornell_like_hypergraph(**kw)
    for k in ("x", "y", "node", "edge"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert (a.num_nodes, a.num_hyperedges) == (b.num_nodes, b.num_hyperedges)


@pytest.mark.parametrize("seed", [0, 7])
def test_scale_free_is_the_ports(seed):
    kw = dict(num_nodes=700, num_hyperedges=300, avg_edge_size=12, exponent=1.5,
              num_classes=8, feature_dim=32, seed=seed)
    a, b = graphs.scale_free_hypergraph(**kw), _port().scale_free_hypergraph(**kw)
    for k in ("x", "y", "node", "edge"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_relabel_keeps_the_sizes():
    g = graphs.cornell_like_hypergraph(num_nodes=600, num_hyperedges=400, seed=0)
    r1, r2 = graphs.relabel(g, 1), graphs.relabel(g, 2**31 + 5)
    for r in (r1, r2):
        assert r.nnz == g.nnz
        assert sorted(np.bincount(r.node, minlength=600)) == sorted(
            np.bincount(g.node, minlength=600))
        assert sorted(np.bincount(r.edge)) == sorted(np.bincount(g.edge))
        assert np.all(np.diff(r.edge) >= 0)
        assert sorted(map(tuple, r.x.tolist())) == sorted(map(tuple, g.x.tolist()))
        assert self_loops(r) == self_loops(g)
    assert not np.array_equal(r1.node, r2.node)
    again = graphs.relabel(g, 1)
    assert np.array_equal(again.node, r1.node) and np.array_equal(again.x, r1.x)


def self_loops(g):
    return int(graphs.self_loop_nodes(g).sum())


def test_self_loop_rule_is_the_ports():
    from allset_tpu_torch.graph.transforms import HyperData, add_self_loops

    g = graphs.cornell_like_hypergraph(num_nodes=300, num_hyperedges=250, avg_edge_size=2,
                                       seed=1)
    d = add_self_loops(HyperData(x=g.x, y=g.y, node=g.node, edge=g.edge,
                                 num_nodes=g.num_nodes, num_hyperedges=g.num_hyperedges))
    loops = graphs.self_loop_nodes(g)
    assert 0 < d.num_sl_edges == loops.sum() < g.num_nodes
    assert np.array_equal(d.node[g.nnz:], np.flatnonzero(loops))
