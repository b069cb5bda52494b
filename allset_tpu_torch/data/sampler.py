"""Random-walk neighbour sampler for mini-batch HAN training.

Counterpart of ``allset_tpu/data/sampler.py``, the same numpy code on the
same ``default_rng(seed)`` stream, so the blocks equal the JAX sampler's
bit for bit for the same seed and seeds (reference
``src/DGL_HAN/train_sampling.py:93-116``): per metapath ([V-E-V] and
[E-V-E]), each seed draws ``num_neighbors`` one-step metapath random
walks; duplicate routes collapse; a self-loop is added; the frontier
becomes a block (neighbours -> seeds).

The blocks have a static shape, [B, K+1] neighbour ids and a mask per
metapath (K walks and the self-loop), with duplicates masked out instead
of removed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from allset_tpu_torch.graph.transforms import HyperData


def _adjacency_csr(data: HyperData):
    """CSR adjacency (offsets and values) in both directions: flat arrays,
    so walks batch as vectorised numpy draws."""
    order = np.argsort(data.node, kind="stable")
    v2e_vals = data.edge[order]
    v2e_off = np.searchsorted(data.node[order], np.arange(data.num_nodes + 1))

    order = np.argsort(data.edge, kind="stable")
    e2v_vals = data.node[order]
    e2v_off = np.searchsorted(
        data.edge[order], np.arange(data.num_hyperedges + 1)
    )
    return (v2e_off, v2e_vals), (e2v_off, e2v_vals)


@dataclasses.dataclass
class Block:
    """One metapath block: neighbors[b, k] feed seed b. Static shape."""

    src: np.ndarray  # [B, K+1] global ids in the combined V+E space
    mask: np.ndarray  # [B, K+1] bool; duplicates / failed walks masked off


class HANNeighborSampler:
    """Metapath random-walk sampler over the combined V+E id space
    (hyperedge global id = num_nodes + e, as in ``graph/metapath.py``)."""

    def __init__(self, data: HyperData, num_neighbors: int = 20, seed: int = 0):
        self.num_nodes = data.num_nodes
        self.num_neighbors = num_neighbors
        (self.v2e_off, self.v2e_vals), (self.e2v_off, self.e2v_vals) = (
            _adjacency_csr(data)
        )
        self.rng = np.random.default_rng(seed)

    def _walks_vev(self, seeds: np.ndarray, K: int) -> np.ndarray:
        """All B x K one-step V-E-V walks as two vectorised CSR draws (a
        uniform member per hop); isolated seeds walk to themselves."""
        s = np.asarray(seeds, np.int64)
        B = len(s)
        deg1 = self.v2e_off[s + 1] - self.v2e_off[s]  # [B]
        r1 = (self.rng.random((B, K)) * np.maximum(deg1, 1)[:, None]).astype(
            np.int64
        )
        e = self.v2e_vals[
            np.minimum(self.v2e_off[s][:, None] + r1, len(self.v2e_vals) - 1)
        ]
        deg2 = self.e2v_off[e + 1] - self.e2v_off[e]  # [B, K]
        r2 = (self.rng.random((B, K)) * np.maximum(deg2, 1)).astype(np.int64)
        v = self.e2v_vals[self.e2v_off[e] + r2]
        return np.where(deg1[:, None] > 0, v, s[:, None])

    def sample(self, seeds: np.ndarray, num_neighbors: Optional[int] = None) -> Dict[str, Block]:
        """seeds are node ids (< num_nodes).

        The VEV block holds K metapath random walks and a self-loop per
        seed (duplicate routes masked, as DGL's frontier dedup keeps one;
        the self-loop column is the seed's canonical occurrence, so walks
        back to the seed are masked too). The second metapath starts in
        the appended hyperedge id space, where node seeds have no out-edges
        (``DGL_HAN/utils.py:205-222``), so for node classification the
        reference's second block is self-loops only, as here.
        """
        K = num_neighbors or self.num_neighbors
        B = len(seeds)
        blocks = {}

        src = np.empty((B, K + 1), dtype=np.int64)
        src[:, :K] = self._walks_vev(seeds, K)
        src[:, K] = seeds  # self loop (train_sampling.py:111-112)
        order = np.argsort(src, axis=1, kind="stable")
        sv = np.take_along_axis(src, order, axis=1)
        dup_sorted = np.zeros_like(sv, dtype=bool)
        dup_sorted[:, 1:] = sv[:, 1:] == sv[:, :-1]
        dup = np.empty_like(dup_sorted)
        np.put_along_axis(dup, order, dup_sorted, axis=1)
        mask = ~dup
        mask[:, :K] &= src[:, :K] != src[:, K][:, None]
        mask[:, K] = True
        blocks["vev"] = Block(src=src, mask=mask)

        src_e = np.repeat(np.asarray(seeds, np.int64)[:, None], K + 1, axis=1)
        mask_e = np.zeros((B, K + 1), dtype=bool)
        mask_e[:, K] = True  # self-loop only
        blocks["eve"] = Block(src=src_e, mask=mask_e)
        return blocks

    def batches(self, nids: np.ndarray, batch_size: int, shuffle: bool = True):
        """Static-size batches; the last partial batch is padded by
        repeating its first seed (padded seeds masked in the loss)."""
        if shuffle:
            nids = self.rng.permutation(nids)
        for i in range(0, len(nids), batch_size):
            chunk = nids[i: i + batch_size]
            pad = batch_size - len(chunk)
            valid = np.concatenate([np.ones(len(chunk), bool), np.zeros(pad, bool)])
            if pad:
                chunk = np.concatenate([chunk, np.full(pad, chunk[0])])
            yield chunk, valid
