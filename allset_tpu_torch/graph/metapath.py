"""Metapath graphs for the HAN vertical.

Counterpart of ``allset_tpu/graph/metapath.py`` (reference
``src/DGL_HAN/print_dataset_statistics.py:106-159``), the same numpy and
scipy code: vertices and hyperedges are concatenated into one id space
(hyperedges get zero features and the label -1); the squared symmetric
star incidence gives the two metapath adjacencies

    VEV = (H_sym @ H_sym) restricted to the V block   (V-E-V co-membership)
    EVE = (H_sym @ H_sym) restricted to the E block   (E-V-E overlap)

built on the host with scipy SpGEMM, as the reference does. Every index
array of the two Incidences equals the JAX package's entry for entry.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from allset_tpu_torch.graph.incidence import Incidence
from allset_tpu_torch.graph.transforms import HyperData


def build_metapath_graphs(
    data: HyperData, bucket: int = 256
) -> Tuple[np.ndarray, np.ndarray, Incidence, Incidence]:
    """Returns (features, labels, VEV, EVE) over the combined V+E id space.

    features: [(N+M), F] with zero rows for hyperedges; labels: [(N+M)]
    with -1 (ignored) for hyperedges. VEV/EVE are Incidences over N+M ids
    (only their own block populated), on the CPU.
    """
    N, M = data.num_nodes, data.num_hyperedges
    T = N + M

    # symmetric star-expansion incidence over the combined space
    rows = np.concatenate([data.node, data.edge + N])
    cols = np.concatenate([data.edge + N, data.node])
    inc = sp.csr_matrix(
        (np.ones(len(rows), dtype=np.float32), (rows, cols)), shape=(T, T)
    )
    two_step = (inc @ inc).tocoo()

    r, c = two_step.row, two_step.col
    v_block = (r < N) & (c < N)
    e_block = (r >= N) & (c >= N)

    vev = Incidence.from_arrays(
        r[v_block], c[v_block],
        norm=np.ones(v_block.sum(), np.float32),
        num_nodes=T, num_edges=T, bucket=bucket,
    )
    eve = Incidence.from_arrays(
        r[e_block], c[e_block],
        norm=np.ones(e_block.sum(), np.float32),
        num_nodes=T, num_edges=T, bucket=bucket,
    )

    feats = np.vstack(
        [data.x, np.zeros((M, data.num_features), dtype=data.x.dtype)]
    )
    labels = np.concatenate(
        [data.y - data.y.min(), np.full(M, -1, dtype=data.y.dtype)]
    )
    return feats, labels, vev, eve
