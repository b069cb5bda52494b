"""Heterogeneous-graph HAN: the reference's cached-metapath variant
(``src/DGL_HAN/model_hetero.py:40-117``).

Counterpart of ``allset_tpu/graph/hetero.py``. The model takes the
original heterogeneous graph and a list of metapaths, and on first use
derives one homogeneous graph per metapath, as
``dgl.metapath_reachable_graph`` does: SpGEMM composition of the
edge-type adjacencies on the host (numpy/scipy), binarised reachability,
cached on the graph object's identity (``model_hetero.py:76-84``). The
derived Incidences then feed a GAT per metapath and semantic attention
(``models/han.py::MetapathStack``). ``HeteroHAN`` is an ``nn.Module``
called with the graph, in place of flax's init/apply pair; its parameter
names are MetapathHAN's flax names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from allset_tpu_torch.graph.incidence import Incidence
from allset_tpu_torch.models.han import HANConfig, MetapathStack

# the JAX package's name for the same fields
HeteroHANConfig = HANConfig


@dataclasses.dataclass(frozen=True)
class HeteroGraph:
    """A typed graph: per-type node counts and per-edge-type COO arrays.

    ``edges`` maps canonical edge types ``(src_type, relation, dst_type)``
    to ``(src_ids, dst_ids)`` numpy arrays: the dgl heterograph surface
    the reference's HAN consumes (``model_hetero.py:103-117``)."""

    num_nodes: Dict[str, int]
    edges: Dict[Tuple[str, str, str], Tuple[np.ndarray, np.ndarray]]

    def adj(self, etype: Tuple[str, str, str]) -> sp.csr_matrix:
        s, _, d = etype
        src, dst = self.edges[etype]
        return sp.csr_matrix(
            (np.ones(len(src), np.float32), (src, dst)),
            shape=(self.num_nodes[s], self.num_nodes[d]),
        )

    def etype_by_relation(self, relation: str) -> Tuple[str, str, str]:
        hits = [e for e in self.edges if e[1] == relation]
        if len(hits) != 1:
            raise KeyError(f"relation {relation!r} matches {len(hits)} edge types")
        return hits[0]


def metapath_reachable(
    g: HeteroGraph, metapath: Sequence[str], bucket: int = 256
) -> Incidence:
    """``dgl.metapath_reachable_graph`` semantics: compose the edge-type
    adjacencies along ``metapath`` (relation names), binarise reachability,
    and return the homogeneous graph over the endpoint node type as an
    Incidence on the CPU (node=src, edge=dst: DGLGATConv aggregates
    g.node rows into g.edge segments)."""
    etypes = [g.etype_by_relation(r) for r in metapath]
    for a, b in zip(etypes, etypes[1:]):
        if a[2] != b[0]:
            raise ValueError(f"metapath breaks between {a} and {b}")
    acc = g.adj(etypes[0])
    for e in etypes[1:]:
        acc = acc @ g.adj(e)
    acc = (acc != 0).tocoo()  # reachability, not path counts
    n_dst = g.num_nodes[etypes[-1][2]]
    n_src = g.num_nodes[etypes[0][0]]
    if n_dst != n_src:
        raise ValueError("metapath must start and end on the same node type")
    return Incidence.from_arrays(
        np.asarray(acc.row, np.int64),
        np.asarray(acc.col, np.int64),
        norm=np.ones(acc.nnz, np.float32),
        num_nodes=n_dst,
        num_edges=n_src,
        bucket=bucket,
    )


class MetapathHAN(MetapathStack):
    """HAN over P precomputed metapath graphs: one DGLGATConv per metapath
    per layer, semantic attention across metapaths, a linear predict head
    (reference ``model_hetero.py:40-117``; models/han.py's VEV/EVE pair
    generalised to any metapath list)."""

    def forward(self, graphs: List[Incidence], x: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        return self.stack(graphs, x, train, generator)


class HeteroHAN(MetapathHAN):
    """The reference's hetero HAN surface: built with metapaths, called
    with the original heterogeneous graph; the per-metapath reachable
    graphs are derived on first use and cached on the graph's identity,
    as ``model_hetero.py:70-84``'s ``_cached_coalesced_graph``, and moved
    once to the features' device."""

    def __init__(self, cfg: HANConfig, meta_paths: Sequence[Sequence[str]],
                 generator: torch.Generator, bucket: int = 256):
        paths = [tuple(mp) for mp in meta_paths]
        super().__init__(cfg, len(paths), generator)
        self.meta_paths, self.bucket = paths, bucket
        self._cached_graph = None
        self._cached_coalesced: Dict[Tuple[str, ...], Incidence] = {}

    def coalesced(self, g: HeteroGraph, device=None) -> List[Incidence]:
        """The metapath graphs of ``g`` (built once per graph object), on
        ``device`` when one is given."""
        if self._cached_graph is not g:
            self._cached_graph = g
            self._cached_coalesced = {mp: metapath_reachable(g, mp, bucket=self.bucket)
                                      for mp in self.meta_paths}
        if device is not None:
            for mp, inc in self._cached_coalesced.items():
                if inc.node.device != torch.device(device):
                    self._cached_coalesced[mp] = inc.to(device)
        return [self._cached_coalesced[mp] for mp in self.meta_paths]

    def forward(self, g: HeteroGraph, x: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        return super().forward(self.coalesced(g, x.device), x, train, generator)
