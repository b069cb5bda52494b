"""A miniature AllSet raw archive, for runs where the real one is absent.

``write_miniature_archive(root)`` writes, under ``root``, files in the
layout and formats the raw loaders read (``data/loaders.py``; the p2raw
rules of ``data/registry.py``) for every real dataset name: the citation
pickles under ``cocitation/`` and ``coauthorship/``, the LE
``.content``/``.edges`` text files, yelp's CSV files and the cornell
family's label and hyperedge lists. The graphs are random, drawn from
``seed``, with labels the features and hyperedges carry (each hyperedge
mostly draws one class's nodes), so a model can learn them; their sizes
are ``nodes`` and about ``nodes // 2`` hyperedges, not the real ones.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

CITATION = {"cocitation": ("cora", "citeseer", "pubmed"), "coauthorship": ("cora", "dblp")}
LE = ("20newsW100", "ModelNet40", "zoo", "NTU2012", "Mushroom")
CORNELL = ("amazon-reviews", "walmart-trips", "house-committees")


def _graph(rng, nodes: int, classes: int, size: int = 5):
    """(labels [nodes], hyperedges: a list of member arrays): each
    hyperedge draws 80% of its members from one class; a last hyperedge
    holds every node, so none is left out."""
    labels = rng.integers(0, classes, size=nodes)
    by_class = [np.flatnonzero(labels == c) for c in range(classes)]
    edges = []
    for _ in range(max(nodes // 2, 1)):
        pool = by_class[rng.integers(classes)]
        k = int(rng.integers(2, size + 1))
        own = rng.choice(pool, size=min(len(pool), k), replace=False) if len(pool) else []
        other = rng.choice(nodes, size=max(k // 5, 1), replace=False)
        edges.append(np.unique(np.concatenate([own, other]).astype(np.int64)))
    edges.append(np.arange(nodes))
    return labels, edges


def _features(rng, labels, classes: int, dim: int) -> np.ndarray:
    """Binary bag-of-words rows: a few class words and random ones."""
    x = (rng.random((len(labels), dim)) < 0.05).astype(np.float32)
    x[np.arange(len(labels)), labels % dim] = 1.0
    x[np.arange(len(labels)), (labels + classes) % dim] = 1.0
    return x


def write_miniature_archive(root: str, nodes: int = 60, seed: int = 0) -> str:
    """Write the miniature archive under ``root`` (created) and return it."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    classes = 3
    for group, names in CITATION.items():
        for name in names:
            d = os.path.join(root, group, name)
            os.makedirs(d, exist_ok=True)
            labels, edges = _graph(rng, nodes, classes)
            x = sp.csr_matrix(_features(rng, labels, classes, 24))
            with open(os.path.join(d, "features.pickle"), "wb") as f:
                pickle.dump(x, f)
            with open(os.path.join(d, "labels.pickle"), "wb") as f:
                pickle.dump([int(v) for v in labels], f)
            with open(os.path.join(d, "hypergraph.pickle"), "wb") as f:
                pickle.dump({f"e{j}": [int(v) for v in e] for j, e in enumerate(edges)}, f)

    for name in LE:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        labels, edges = _graph(rng, nodes, classes)
        # ids cover the nodes, then the hyperedges; raw ids start at 7
        x = np.concatenate([_features(rng, labels, classes, 10),
                            np.zeros((len(edges), 10), np.float32)])
        y = np.concatenate([labels, np.zeros(len(edges), np.int64)])
        with open(os.path.join(d, f"{name}.content"), "w") as f:
            for i in range(len(y)):
                feats = " ".join(str(int(v)) for v in x[i])
                f.write(f"{7 + i} {feats} {y[i]}\n")
        with open(os.path.join(d, f"{name}.edges"), "w") as f:
            for j, e in enumerate(edges):
                for v in e:
                    f.write(f"{7 + v} {7 + nodes + j}\n")

    d = os.path.join(root, "yelp")
    os.makedirs(d, exist_ok=True)
    labels, edges = _graph(rng, nodes, classes)
    words = ("golden dragon burger haven noodle house pizza palace taco grill sushi bar "
             "cafe bistro diner kitchen").split()
    with open(os.path.join(d, "yelp_restaurant_latlong.csv"), "w") as f:
        f.write("latitude,longitude\n")
        f.writelines(f"{35 + rng.random():.6f},{-110 - rng.random():.6f}\n"
                     for _ in range(nodes))
    with open(os.path.join(d, "yelp_restaurant_locations.csv"), "w") as f:
        f.write("state_int,city_int\n")
        f.writelines(f"{1 + i % 3},{1 + i % 5}\n" for i in range(nodes))
    with open(os.path.join(d, "yelp_restaurant_name.csv"), "w") as f:
        f.write("name\n")
        f.writelines(" ".join(rng.choice(words, size=2)) + f" {words[c]}\n" for c in labels)
    with open(os.path.join(d, "yelp_restaurant_business_stars.csv"), "w") as f:
        f.write("stars\n")
        f.writelines(f"{1 + c}\n" for c in labels)
    with open(os.path.join(d, "yelp_restaurant_incidence_H.csv"), "w") as f:
        f.write("node,he\n")
        f.writelines(f"{v + 1},{j + 1}\n" for j, e in enumerate(edges) for v in e)

    for name in CORNELL:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        labels, edges = _graph(rng, nodes, classes)
        with open(os.path.join(d, f"node-labels-{name}.txt"), "w") as f:
            f.writelines(f"{c + 1}\n" for c in labels)  # 1-based labels
        with open(os.path.join(d, f"hyperedges-{name}.txt"), "w") as f:
            f.writelines(",".join(str(v + 1) for v in e) + "\n" for e in edges)  # 1-based ids
    return root
