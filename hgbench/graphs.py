"""The traffic's graphs: frozen copies of the port's generators, the
relabelling that makes each seed's graph, and the self-loop rule.

``cornell_like_hypergraph`` and ``scale_free_hypergraph`` are copies of
``allset_tpu_torch/data/synthetic.py`` at commit b978a993e545, and
``coalesce`` of the numpy branch of ``graph/transforms.py::coalesce``:
given the same seed they return the same arrays as the port's functions
(a CPU test holds them to it). ``self_loop_nodes`` is the rule of
``graph/transforms.py::add_self_loops`` at that commit. The program under
test receives only the arrays; nothing here imports it.

A traffic file fixes the graph by its generator, its parameters and a
``graph_seed``; the run's ``--seed`` then relabels nodes and hyperedges
by a permutation of each. Every seed so gets the same sizes (entries,
degrees, hyperedge sizes, the hub) in another order, and the seed
changes the inputs but not the work.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """A hypergraph as the generators make it: features x [N, F] float32,
    labels y [N] int64, and its incidence entries node[i] in edge[i],
    sorted by (edge, node) without repeats."""

    x: np.ndarray
    y: np.ndarray
    node: np.ndarray
    edge: np.ndarray
    num_nodes: int
    num_hyperedges: int

    @property
    def nnz(self) -> int:
        return int(self.node.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])

    @property
    def num_classes(self) -> int:
        return int(self.y.max()) + 1


def coalesce(node: np.ndarray, edge: np.ndarray):
    """Sort by (edge, node) and drop repeated entries: the rows of
    ``np.unique(np.stack([edge, node], 1), axis=0)``, through one int64
    key per entry."""
    node, edge = np.asarray(node, np.int64), np.asarray(edge, np.int64)
    width = int(node.max()) + 1 if node.size else 1
    key = np.unique(edge * width + node)
    return key % width, key // width


def scale_free_hypergraph(num_nodes: int, num_hyperedges: int, avg_edge_size: int = 8,
                          exponent: float = 1.5, num_classes: int = 8,
                          feature_dim: int = 256, seed: int = 0) -> Graph:
    """Power-law node popularity ~ Zipf(exponent), Poisson edge sizes (at
    least 2), one global inverse-CDF draw, repeats within an edge removed."""
    rng = np.random.default_rng(seed)
    pop = (np.arange(1, num_nodes + 1, dtype=np.float64)) ** -exponent
    pop /= pop.sum()
    sizes = np.maximum(2, rng.poisson(avg_edge_size, size=num_hyperedges))
    cdf = np.cumsum(pop)
    cdf[-1] = 1.0
    total = int(sizes.sum())
    draws = np.searchsorted(cdf, rng.random(total), side="right")
    edge_ids = np.repeat(np.arange(num_hyperedges, dtype=np.int64), sizes)
    node, edge = coalesce(draws.astype(np.int64), edge_ids)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int64)
    x = rng.normal(size=(num_nodes, feature_dim)).astype(np.float32)
    return Graph(x=x, y=y, node=node, edge=edge, num_nodes=num_nodes,
                 num_hyperedges=num_hyperedges)


def cornell_like_hypergraph(num_nodes: int = 88860, num_hyperedges: int = 69906,
                            avg_edge_size: int = 7, num_classes: int = 11,
                            feature_dim: int = 100, feature_noise: float = 1.0,
                            exponent: float = 1.2, homophily: float = 0.6,
                            seed: int = 0) -> Graph:
    """Walmart-shaped: Zipf popularity over a random node permutation,
    planted classes (each hyperedge's members drawn from its anchor class
    with probability ``homophily``), features one-hot(label) + N(0, noise)
    zero-padded to ``feature_dim``."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes)

    rank = rng.permutation(num_nodes)
    pop = np.empty(num_nodes, np.float64)
    pop[rank] = (np.arange(1, num_nodes + 1, dtype=np.float64)) ** -exponent
    pop /= pop.sum()
    cdf = np.cumsum(pop)
    cdf[-1] = 1.0

    sizes = np.maximum(2, rng.poisson(avg_edge_size, size=num_hyperedges))
    total = int(sizes.sum())
    edge_ids = np.repeat(np.arange(num_hyperedges, dtype=np.int64), sizes)
    draws = np.searchsorted(cdf, rng.random(total), side="right")

    anchor = rng.integers(0, num_classes, size=num_hyperedges)[edge_ids]
    replace = rng.random(total) < homophily
    u = rng.random(total)
    for c in range(num_classes):
        members = np.where(y == c)[0]
        if not len(members):
            continue
        pc = pop[members]
        cdf_c = np.cumsum(pc / pc.sum())
        cdf_c[-1] = 1.0
        m = replace & (anchor == c)
        draws[m] = members[np.searchsorted(cdf_c, u[m], side="right")]

    node, edge = coalesce(draws, edge_ids)

    feats = np.zeros((num_nodes, num_classes), dtype=np.float64)
    feats[np.arange(num_nodes), y] = 1.0
    if feature_dim > num_classes:
        feats = np.hstack([feats, np.zeros((num_nodes, feature_dim - num_classes))])
    feats = rng.normal(feats, feature_noise)
    return Graph(x=feats.astype(np.float32), y=y.astype(np.int64), node=node, edge=edge,
                 num_nodes=num_nodes, num_hyperedges=num_hyperedges)


GENERATORS = {"cornell_like": cornell_like_hypergraph, "scale_free": scale_free_hypergraph}


def relabel(g: Graph, seed: int) -> Graph:
    """The same hypergraph under a permutation of its node ids and one of
    its hyperedge ids, both drawn from ``seed``; features and labels follow
    their nodes, and the entries are sorted again by (edge, node)."""
    rng = np.random.default_rng(seed)
    pn = rng.permutation(g.num_nodes)  # old node i -> pn[i]
    pe = rng.permutation(g.num_hyperedges)
    x = np.empty_like(g.x)
    y = np.empty_like(g.y)
    x[pn] = g.x
    y[pn] = g.y
    node, edge = coalesce(pn[g.node], pe[g.edge])
    return Graph(x=x, y=y, node=node, edge=edge, num_nodes=g.num_nodes,
                 num_hyperedges=g.num_hyperedges)


def make_graph(spec: dict, seed: int) -> Graph:
    """The graph a traffic file's ``graph`` entry describes, relabelled by
    the run's seed."""
    params = {k: v for k, v in spec.items() if k not in ("generator", "graph_seed")}
    g = GENERATORS[spec["generator"]](seed=spec["graph_seed"], **params)
    return relabel(g, seed)


def self_loop_nodes(g: Graph) -> np.ndarray:
    """[N] bool: the nodes that get a self-loop hyperedge, all but those
    already in a hyperedge of one member (reference
    ``src/preprocessing.py:412-448``)."""
    sizes = np.bincount(g.edge, minlength=g.num_hyperedges)
    skip = np.zeros(g.num_nodes, bool)
    singles = np.where(sizes == 1)[0]
    if singles.size:
        skip[g.node[np.isin(g.edge, singles)]] = True
    return ~skip
