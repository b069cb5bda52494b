"""Raw dataset loaders for the four AllSet formats.

Counterpart of ``allset_tpu/data/loaders.py`` (reference
``src/load_other_datasets.py``): each returns a :class:`HyperData` with
node and hyperedge ids in separate 0-based id spaces, its incidence
entries coalesced (sorted by hyperedge then node, duplicates dropped), and
gives the same arrays as the JAX package's loader on the same files.

The JAX loaders read the cornell and yelp CSV files with pandas; these
read them with the standard library and numpy, so the numpy-only names
(every family but yelp) load on a machine without pandas. Yelp's
bag-of-words of the restaurant names is scikit-learn's CountVectorizer,
imported when yelp is loaded.
"""

from __future__ import annotations

import csv
import os.path as osp
import pickle
from typing import Optional

import numpy as np

from allset_tpu_torch.graph.transforms import HyperData, coalesce


def load_LE_dataset(path: str, dataset: str = "ModelNet40") -> HyperData:
    """'.content'/'.edges' text datasets: NTU2012, ModelNet40, zoo,
    Mushroom, 20newsW100 (reference ``src/load_other_datasets.py:32-119``).

    .content rows: id, features..., label, covering both node and
    hyperedge ids (features sliced to the first num_nodes rows).
    .edges rows: (node_id, hyperedge_id) with hyperedge ids offset.
    """
    content = np.genfromtxt(osp.join(path, dataset, f"{dataset}.content"), dtype=str)
    features = content[:, 1:-1].astype(np.float32)
    labels = content[:, -1].astype(float).astype(np.int64)

    idx = content[:, 0].astype(np.int32)
    idx_map = {j: i for i, j in enumerate(idx)}
    edges_un = np.genfromtxt(osp.join(path, dataset, f"{dataset}.edges"), dtype=np.int32)
    edges = np.array(
        [idx_map[v] for v in edges_un.flatten()], dtype=np.int64
    ).reshape(edges_un.shape)

    edge_index = edges.T  # [2, nnz]: row 0 nodes, row 1 offset hyperedge ids
    if edge_index[0].max() != edge_index[1].min() - 1:
        raise ValueError(f"{dataset}: node and hyperedge ids are not contiguous")
    if len(np.unique(edge_index)) != edge_index.max() + 1:
        raise ValueError(f"{dataset}: some ids have no incidence entry")

    num_nodes = int(edge_index[0].max()) + 1
    num_he = int(edge_index[1].max()) - num_nodes + 1
    node, edge = coalesce(edge_index[0], edge_index[1] - num_nodes)

    return HyperData(
        x=features[:num_nodes],
        y=labels[:num_nodes],
        node=node,
        edge=edge,
        num_nodes=num_nodes,
        num_hyperedges=num_he,
    )


def load_citation_dataset(path: str, dataset: str = "cora") -> HyperData:
    """HyperGCN-format pickles (cora/citeseer/pubmed cocitation,
    coauthor_cora/dblp): features.pickle (scipy sparse), labels.pickle,
    hypergraph.pickle ({he: [nodes]}); reference
    ``src/load_other_datasets.py:121-196``. The pickles are the archive's
    own files: unpickling runs code, so load only an archive you trust."""
    with open(osp.join(path, dataset, "features.pickle"), "rb") as f:
        features = np.asarray(pickle.load(f).todense(), dtype=np.float32)
    with open(osp.join(path, dataset, "labels.pickle"), "rb") as f:
        labels = np.asarray(pickle.load(f), dtype=np.int64)
    num_nodes = features.shape[0]
    if num_nodes != len(labels):
        raise ValueError(f"{dataset}: {num_nodes} feature rows and {len(labels)} labels")

    with open(osp.join(path, dataset, "hypergraph.pickle"), "rb") as f:
        hypergraph = pickle.load(f)

    node_list, edge_list = [], []
    for he_id, he in enumerate(hypergraph.keys()):
        members = list(hypergraph[he])
        node_list += members
        edge_list += [he_id] * len(members)
    node, edge = coalesce(np.array(node_list), np.array(edge_list))

    return HyperData(
        x=features, y=labels, node=node, edge=edge,
        num_nodes=num_nodes, num_hyperedges=len(hypergraph),
    )


def _read_csv(path: str):
    """A CSV file with a header row -> (header, rows of cell strings);
    blank lines are skipped, as pandas' reader skips them."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    return rows[0], rows[1:]


def _column(path: str, name: str) -> np.ndarray:
    header, rows = _read_csv(path)
    i = header.index(name)
    return np.array([int(r[i]) for r in rows], dtype=np.int64)


def _cells(path: str) -> list:
    """Every cell below the header, row by row (pandas' values.flatten())."""
    return [c for r in _read_csv(path)[1] for c in r]


def load_yelp_dataset(
    path: str, dataset: str = "yelp", name_dictionary_size: int = 1000
) -> HyperData:
    """Yelp restaurants (reference ``src/load_other_datasets.py:198-291``):
    features = [latlong | state 1-hot | city 1-hot | name bag-of-words],
    labels = star bins, incidence from yelp_restaurant_incidence_H.csv."""
    from sklearn.feature_extraction.text import CountVectorizer

    latlong = np.array([[float(c) for c in r] for r in
                        _read_csv(osp.join(path, "yelp_restaurant_latlong.csv"))[1]])
    loc = osp.join(path, "yelp_restaurant_locations.csv")
    state_int = _column(loc, "state_int")
    city_int = _column(loc, "city_int")
    num_nodes = state_int.shape[0]

    state_1hot = np.zeros((num_nodes, state_int.max()))
    state_1hot[np.arange(num_nodes), state_int - 1] = 1
    city_1hot = np.zeros((num_nodes, city_int.max()))
    city_1hot[np.arange(num_nodes), city_int - 1] = 1

    vectorizer = CountVectorizer(
        max_features=name_dictionary_size, stop_words="english", strip_accents="ascii"
    )
    res_name = np.array(_cells(osp.join(path, "yelp_restaurant_name.csv")), dtype=object)
    name_bow = np.asarray(vectorizer.fit_transform(res_name).todense())

    features = np.hstack([latlong, state_1hot, city_1hot, name_bow]).astype(np.float32)
    stars = _cells(osp.join(path, "yelp_restaurant_business_stars.csv"))
    labels = np.array([float(c) for c in stars]).astype(np.int64)
    if num_nodes != len(labels):
        raise ValueError(f"yelp: {num_nodes} restaurants and {len(labels)} labels")

    H = osp.join(path, "yelp_restaurant_incidence_H.csv")
    he = _column(H, "he")
    node, edge = coalesce(_column(H, "node") - 1, he - 1)

    return HyperData(
        x=features, y=labels, node=node, edge=edge,
        num_nodes=num_nodes, num_hyperedges=int(he.max()),
    )


def load_cornell_dataset(
    path: str,
    dataset: str = "amazon",
    feature_noise: float = 0.1,
    feature_dim: Optional[int] = None,
    seed: Optional[int] = None,
) -> HyperData:
    """Cornell datasets (walmart-trips / house-committees / amazon-reviews,
    reference ``src/load_other_datasets.py:293-386``): labels from text,
    synthetic features = one-hot(label) + N(0, feature_noise), optionally
    zero-padded to feature_dim (the '-100' variants); hyperedges
    one-per-line comma-separated; node ids shifted to start at 0. The
    features depend on ``seed``."""
    with open(osp.join(path, dataset, f"node-labels-{dataset}.txt")) as f:
        labels = np.array([int(line) for line in f if line.strip()], dtype=np.int64)
    num_nodes = labels.shape[0]

    num_classes = int(labels.max())
    features = np.zeros((num_nodes, num_classes))
    features[np.arange(num_nodes), labels - 1] = 1.0
    if feature_dim is not None and feature_dim > num_classes:
        features = np.hstack(
            [features, np.zeros((num_nodes, feature_dim - num_classes))]
        )
    rng = np.random.default_rng(seed)
    features = rng.normal(features, feature_noise).astype(np.float32)

    node_list, he_list = [], []
    he_id = 0
    with open(osp.join(path, dataset, f"hyperedges-{dataset}.txt")) as f:
        for line in f:
            members = [int(x) for x in line.strip().split(",") if x]
            node_list += members
            he_list += [he_id] * len(members)
            he_id += 1
    node_arr = np.array(node_list)
    node_arr = node_arr - node_arr.min()  # shift to 0-based
    node, edge = coalesce(node_arr, np.array(he_list))

    return HyperData(
        x=features, y=labels, node=node, edge=edge,
        num_nodes=num_nodes, num_hyperedges=he_id,
    )
