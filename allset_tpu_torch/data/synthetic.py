"""Synthetic hypergraph generators.

Counterpart of ``allset_tpu/data/synthetic.py``: ``synthetic_hypergraph``
(small learnable graphs), ``distractor_hypergraph`` (the attention band's
graph), ``scale_free_hypergraph`` (the benchmark graph) and
``cornell_like_hypergraph`` (the walmart-shaped stand-in of the runs
protocol). Given the same seed each returns the same arrays as the JAX
package's: the draws come from the same ``numpy.random.default_rng``
stream in the same order.
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


def distractor_hypergraph(
    num_nodes: int = 2000,
    num_hyperedges: int = 1200,
    num_classes: int = 4,
    avg_edge_size: int = 12,
    distractor_frac: float = 0.5,
    distractor_scale: float = 3.0,
    feature_noise: float = 1.0,
    seed: int = 0,
) -> HyperData:
    """Planted partition where attention is load-bearing.

    ``distractor_frac`` of the nodes are distractors: unlabelled (-1, left
    out of the splits) with features imitating a fake class plus a marker
    column (~``distractor_scale``). Each hyperedge anchored at class ``a``
    mixes informative members of ``a`` with distractors faking ``a ^ 1``,
    so mean pooling cannot tell paired classes apart while per-member
    attention keyed on the marker can. Use with ``all_num_layers=1``.
    """
    rng = np.random.default_rng(seed)
    n_dis = int(num_nodes * distractor_frac)
    n_inf = num_nodes - n_dis
    y = np.concatenate([
        rng.integers(0, num_classes, size=n_inf),
        np.full(n_dis, -1, dtype=np.int64),
    ])
    class_members = [np.where(y == c)[0] for c in range(num_classes)]
    fake_class = rng.integers(0, num_classes, size=n_dis)
    fake_members = [
        n_inf + np.where(fake_class == c)[0] for c in range(num_classes)
    ]

    nodes, edges = [], []
    for e in range(num_hyperedges):
        k = max(4, rng.poisson(avg_edge_size))
        k_inf = max(2, k // 2)
        anchor = int(rng.integers(0, num_classes))
        confuser = anchor ^ 1  # paired-class collision (even num_classes)
        members = set(
            int(v) for v in rng.choice(class_members[anchor], k_inf)
        )
        members |= set(
            int(v) for v in rng.choice(fake_members[confuser], k - k_inf)
        )
        for v in members:
            nodes.append(v)
            edges.append(e)
    node, edge = coalesce(np.array(nodes), np.array(edges))

    feats = np.zeros((num_nodes, num_classes + 1), dtype=np.float64)
    feats[np.arange(n_inf), y[:n_inf]] = 1.0
    feats[np.arange(n_inf, num_nodes), fake_class] = 1.0
    feats[n_inf:, num_classes] = distractor_scale  # the marker column
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


def cornell_like_hypergraph(
    num_nodes: int = 88860,
    num_hyperedges: int = 69906,
    avg_edge_size: int = 7,
    num_classes: int = 11,
    feature_dim: int = 100,
    feature_noise: float = 1.0,
    exponent: float = 1.2,
    homophily: float = 0.6,
    seed: int = 0,
) -> HyperData:
    """Walmart-shaped synthetic: power-law node popularity (the degree skew
    SURVEY §7 names as the hard case), planted class structure, and
    cornell-style features — one-hot(label) + N(0, noise) zero-padded to
    ``feature_dim`` (reference ``src/load_other_datasets.py:317-327`` +
    the '-100' rule of ``convert_datasets_to_pygDataset.py:141-150``).

    Defaults mirror walmart-trips-100's published shape (88860 nodes,
    69906 hyperedges, 11 classes, 100-dim features) so the Table-2
    protocol can be exercised end to end without the raw archive.
    """
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes)

    # Zipf popularity over a random node permutation (hot nodes land in
    # every class); global + per-class inverse-CDF tables
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

    # homophily: with prob h, replace the draw with a popularity-weighted
    # draw from the edge's anchor class (vectorized per class)
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
