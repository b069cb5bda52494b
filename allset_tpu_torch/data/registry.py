"""Dataset registry: the synthetic names of ``allset_tpu/data/registry.py``.

The synthetic datasets are generated in-process from ``seed`` with the
same numpy streams as the JAX package, so ``load_dataset`` returns the
same arrays. The reference's real datasets (the AllSet raw archive) need
the raw loaders, which are not ported yet: their names raise.
"""

from __future__ import annotations

from typing import Optional

from allset_tpu_torch.data.synthetic import (
    cornell_like_hypergraph,
    distractor_hypergraph,
    synthetic_hypergraph,
)
from allset_tpu_torch.graph.transforms import HyperData

EXISTING_DATASETS = [
    "20newsW100", "ModelNet40", "zoo", "NTU2012", "Mushroom",
    "coauthor_cora", "coauthor_dblp",
    "yelp", "amazon-reviews", "walmart-trips", "house-committees",
    "walmart-trips-100", "house-committees-100",
    "cora", "citeseer", "pubmed",
]

SYNTHETIC_FEATURE_DATASETS = [
    "amazon-reviews", "walmart-trips", "house-committees",
    "walmart-trips-100", "house-committees-100",
]


def load_dataset(
    name: str,
    root: str = "data/AllSet_all_raw_data",
    cache_dir: str = "data/cache",
    feature_noise: Optional[float] = None,
    seed: int = 0,
) -> HyperData:
    """Generate a synthetic dataset by name:

      synthetic / synthetic-large   planted partition, 500 / 20,000 nodes
      synthetic-mid                 planted partition, 2,000 nodes
      synthetic-att                 distractor graph (attention band)
      synthetic-walmart             walmart-trips-100's shape (88,860 nodes)

    ``root`` and ``cache_dir`` belong to the real datasets' loaders."""
    if name.startswith("synthetic"):
        noise = feature_noise if feature_noise is not None else 1.0
        if name == "synthetic-walmart":
            return cornell_like_hypergraph(feature_noise=noise, seed=seed)
        if name == "synthetic-att":
            return distractor_hypergraph(
                num_nodes=2000, num_hyperedges=1200, num_classes=4,
                avg_edge_size=12, distractor_frac=0.4,
                distractor_scale=2.0, feature_noise=noise, seed=seed,
            )
        if name == "synthetic-mid":
            return synthetic_hypergraph(
                num_nodes=2000, num_hyperedges=1200, num_classes=4,
                feature_noise=noise, seed=seed,
            )
        big = name.endswith("large")
        return synthetic_hypergraph(
            num_nodes=20000 if big else 500,
            num_hyperedges=10000 if big else 300,
            num_classes=8 if big else 4,
            feature_noise=noise,
            seed=seed,
        )
    if name in EXISTING_DATASETS:
        raise NotImplementedError(
            f"dataset {name!r} needs the raw-archive loaders (ROADMAP Queue 1 "
            "item 8); the synthetic names run now"
        )
    raise ValueError(f"unknown dataset {name!r}; known: {EXISTING_DATASETS}")
