"""Dataset registry and cache: the ``dataset_Hypergraph`` equivalent.

Counterpart of ``allset_tpu/data/registry.py`` (reference
``src/convert_datasets_to_pygDataset.py:39-178``). The synthetic datasets
are generated in-process from ``seed`` with the same numpy streams as the
JAX package. The 16 real names of the AllSet raw archive dispatch to the
raw loaders (``data/loaders.py``) under the same p2raw layout rules
(``src/train.py:308-326``), are cached as npz files, and take the same
label fix-ups (``src/train.py:328-339``): ``load_dataset`` returns the same
arrays as the JAX package's.

One difference: the JAX cache key ignores ``seed``, so a cached cornell
dataset (whose features are drawn from the seed) comes back with the
features of whichever seed filled the cache first. Here the cornell
family's key holds the seed.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from allset_tpu_torch.data.loaders import (
    load_citation_dataset,
    load_cornell_dataset,
    load_LE_dataset,
    load_yelp_dataset,
)
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

# label rebasing rule of src/train.py:330-333
RELABEL_DATASETS = [
    "yelp", "walmart-trips", "house-committees",
    "walmart-trips-100", "house-committees-100",
]


def default_p2raw(name: str, root: str) -> str:
    if name in ("cora", "citeseer", "pubmed"):
        return osp.join(root, "cocitation")
    if name in ("coauthor_cora", "coauthor_dblp"):
        return osp.join(root, "coauthorship")
    if name == "yelp":
        return osp.join(root, "yelp")
    return root


def _cache_path(cache_dir: str, name: str, feature_noise: Optional[float],
                seed: Optional[int] = None) -> str:
    """The npz file of a dataset: the JAX package's name, and for the
    datasets whose features depend on the seed (the cornell family) the
    seed as well."""
    suffix = f"_noise_{feature_noise}" if feature_noise is not None else ""
    if seed is not None:
        suffix += f"_seed_{seed}"
    return osp.join(cache_dir, f"{name}{suffix}.npz")


def save_hyperdata(path: str, data: HyperData) -> None:
    os.makedirs(osp.dirname(path), exist_ok=True)
    np.savez_compressed(
        path,
        x=data.x, y=data.y, node=data.node, edge=data.edge,
        num_nodes=data.num_nodes, num_hyperedges=data.num_hyperedges,
        **{f"extra_{k}": v for k, v in data.extras.items()},
    )


def load_hyperdata(path: str) -> HyperData:
    z = np.load(path)
    extras = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
    return HyperData(
        x=z["x"], y=z["y"], node=z["node"], edge=z["edge"],
        num_nodes=int(z["num_nodes"]), num_hyperedges=int(z["num_hyperedges"]),
        extras=extras,
    )


def _load_raw(name: str, root: str, feature_noise: Optional[float], seed: int) -> HyperData:
    p2raw = default_p2raw(name, root)
    if name in ("cora", "citeseer", "pubmed", "coauthor_cora", "coauthor_dblp"):
        # coauthorship raws live under their bare names: coauthorship/cora,
        # coauthorship/dblp (convert_datasets_to_pygDataset.py:127-132)
        raw_name = name.split("_")[-1] if name.startswith("coauthor") else name
        return load_citation_dataset(p2raw, raw_name)
    if name in ("20newsW100", "ModelNet40", "zoo", "NTU2012", "Mushroom"):
        return load_LE_dataset(p2raw, name)
    if name == "yelp":
        return load_yelp_dataset(p2raw, name)
    base = name[:-4] if name.endswith("-100") else name  # the cornell family
    return load_cornell_dataset(
        p2raw, base, feature_noise=1.0 if feature_noise is None else feature_noise,
        feature_dim=100 if name.endswith("-100") else None, seed=seed,
    )


def load_dataset(
    name: str,
    root: str = "data/AllSet_all_raw_data",
    cache_dir: str = "data/cache",
    feature_noise: Optional[float] = None,
    seed: int = 0,
) -> HyperData:
    """A dataset by name, the reference's label fix-ups applied.

      synthetic / synthetic-large   planted partition, 500 / 20,000 nodes
      synthetic-mid                 planted partition, 2,000 nodes
      synthetic-att                 distractor graph (attention band)
      synthetic-walmart             walmart-trips-100's shape (88,860 nodes)

    are generated in-process; a real name (EXISTING_DATASETS) is read from
    the raw archive under ``root`` and cached in ``cache_dir``."""
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
    if name not in EXISTING_DATASETS:
        raise ValueError(f"unknown dataset {name!r}; known: {EXISTING_DATASETS}")

    needs_noise = name in SYNTHETIC_FEATURE_DATASETS
    cpath = _cache_path(cache_dir, name, feature_noise if needs_noise else None,
                        seed if needs_noise else None)
    if osp.exists(cpath):
        data = load_hyperdata(cpath)
    else:
        data = _load_raw(name, root, feature_noise, seed)
        save_hyperdata(cpath, data)
    if name in RELABEL_DATASETS:
        data.y = data.y - data.y.min()  # labels from 0 (src/train.py:330-333)
    return data
