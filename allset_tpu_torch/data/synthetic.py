"""Synthetic hypergraph generators.

Counterpart of ``allset_tpu/data/synthetic.py``, limited to
``synthetic_hypergraph`` (small learnable graphs for tests) and
``scale_free_hypergraph`` (the benchmark graph). Given the same seed both
return the same arrays as the JAX package's: the draws come from the same
``numpy.random.default_rng`` stream in the same order.
"""

from __future__ import annotations

import numpy as np

from allset_tpu_torch.graph.transforms import HyperData, coalesce


def synthetic_hypergraph(
    num_nodes: int = 200,
    num_hyperedges: int = 100,
    num_classes: int = 4,
    avg_edge_size: int = 5,
    homophily: float = 0.8,
    feature_noise: float = 1.0,
    feature_dim: int | None = None,
    seed: int = 0,
) -> HyperData:
    """Planted-partition hypergraph with cornell-style noisy features.

    Each hyperedge picks an anchor class; members are drawn from that
    class w.p. ``homophily``, uniformly otherwise. Features are
    one-hot(label) + N(0, feature_noise), optionally zero-padded to
    ``feature_dim``.
    """
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes)
    class_members = [np.where(y == c)[0] for c in range(num_classes)]

    nodes, edges = [], []
    for e in range(num_hyperedges):
        k = max(2, rng.poisson(avg_edge_size))
        anchor = rng.integers(0, num_classes)
        members = set()
        for _ in range(k):
            if rng.random() < homophily and len(class_members[anchor]):
                members.add(int(rng.choice(class_members[anchor])))
            else:
                members.add(int(rng.integers(0, num_nodes)))
        for v in members:
            nodes.append(v)
            edges.append(e)
    node, edge = coalesce(np.array(nodes), np.array(edges))

    feats = np.zeros((num_nodes, num_classes), dtype=np.float64)
    feats[np.arange(num_nodes), y] = 1.0
    if feature_dim is not None and feature_dim > num_classes:
        feats = np.hstack(
            [feats, np.zeros((num_nodes, feature_dim - num_classes))]
        )
    feats = rng.normal(feats, feature_noise)

    return HyperData(
        x=feats.astype(np.float32),
        y=y.astype(np.int64),
        node=node,
        edge=edge,
        num_nodes=num_nodes,
        num_hyperedges=num_hyperedges,
    )


def scale_free_hypergraph(
    num_nodes: int,
    num_hyperedges: int,
    avg_edge_size: int = 8,
    exponent: float = 1.5,
    num_classes: int = 8,
    feature_dim: int = 256,
    seed: int = 0,
) -> HyperData:
    """Power-law node-degree hypergraph (walmart/yelp-like skew): node
    popularity ~ Zipf(exponent), Poisson edge sizes (at least 2), one
    global inverse-CDF draw, within-edge repeats removed by coalesce."""
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
    return HyperData(
        x=x, y=y, node=node, edge=edge,
        num_nodes=num_nodes, num_hyperedges=num_hyperedges,
    )
