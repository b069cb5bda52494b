"""Host-side hypergraph transforms (numpy), mirroring reference preprocessing.

Counterpart of ``allset_tpu/graph/transforms.py``, limited to what the
ported methods need: ``HyperData``, ``coalesce``, ``add_self_loops``,
``expand_edge_index``, ``norm_construction``, ``rand_train_test_idx``,
the zoo's degree vectors ``generate_norm_hnhn`` (HNHN) and
``unignn_degrees`` (UniGNN, UniGCNII), carried in ``HyperData.extras``,
the clique expansion ``construct_v2v`` with ``gcn_norm`` (CEGCN, CEGAT)
and HyperGCN's ``hypergcn_edge_dict``.
The port keeps its own copy because importing the JAX package's module
loads jax. Given the same inputs (and the same numpy generator state),
every function returns the same arrays as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from allset_tpu_torch.graph import native


@dataclasses.dataclass
class HyperData:
    """Host-side hypergraph: features, labels, V2E incidence COO.

    node[i]/edge[i]: the i-th incidence entry, 0-based in separate id
    spaces. num_hyperedges counts original hyperedges; after
    :func:`add_self_loops` it grows by ``num_sl_edges`` singleton edges
    appended at the end of the edge id space.
    """

    x: np.ndarray  # [N, F] float32
    y: np.ndarray  # [N] int64
    node: np.ndarray  # [nnz] int64
    edge: np.ndarray  # [nnz] int64
    num_nodes: int
    num_hyperedges: int
    norm: Optional[np.ndarray] = None  # [nnz] float32
    num_sl_edges: int = 0
    # per-model host arrays (HNHN's norm vectors, UniGNN's degrees)
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def nnz(self) -> int:
        return int(self.node.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])

    @property
    def num_classes(self) -> int:
        return int(self.y.max()) + 1

    def copy(self) -> "HyperData":
        return dataclasses.replace(
            self,
            node=self.node.copy(),
            edge=self.edge.copy(),
            norm=None if self.norm is None else self.norm.copy(),
            extras=dict(self.extras),
        )

    def to_incidence(self, bucket: int = 256):
        from allset_tpu_torch.graph.incidence import Incidence

        return Incidence.from_arrays(
            self.node,
            self.edge,
            norm=self.norm,
            num_nodes=self.num_nodes,
            num_edges=self.num_hyperedges,
            bucket=bucket,
            num_sl_edges=self.num_sl_edges,
        )


def coalesce(node: np.ndarray, edge: np.ndarray):
    """Sort (by edge, then node) and drop duplicate incidence entries.
    Native hypercore kernel when built; numpy otherwise."""
    native_out = native.coalesce(node, edge)
    if native_out is not None:
        return native_out
    pairs = np.stack([edge, node], axis=1)
    uniq = np.unique(pairs, axis=0)
    return uniq[:, 1], uniq[:, 0]


def add_self_loops(data: HyperData) -> HyperData:
    """Append one new singleton hyperedge per node, skipping nodes that
    already sit in a size-1 hyperedge (reference
    ``src/preprocessing.py:412-448``)."""
    edge_sizes = np.bincount(data.edge, minlength=data.num_hyperedges)
    singleton_edges = np.where(edge_sizes == 1)[0]
    skip = np.zeros(data.num_nodes, bool)
    if singleton_edges.size:
        skip[data.node[np.isin(data.edge, singleton_edges)]] = True
    new_nodes = np.flatnonzero(~skip).astype(np.int64)
    new_edges = data.num_hyperedges + np.arange(len(new_nodes), dtype=np.int64)

    out = data.copy()
    out.node = np.concatenate([data.node, new_nodes])
    out.edge = np.concatenate([data.edge, new_edges])
    out.num_hyperedges = data.num_hyperedges + len(new_nodes)
    out.num_sl_edges = len(new_nodes)
    if data.norm is not None:
        out.norm = np.concatenate(
            [data.norm, np.ones(len(new_nodes), dtype=np.float32)]
        )
    return out


def norm_construction(data: HyperData, option: str = "all_one") -> HyperData:
    """Per-incidence-entry weights (reference ``src/preprocessing.py:451-464``).

    'all_one'     : data.norm = 1 everywhere
    'deg_half_sym': d_v^{-1/2} * d_e^{-1/2} per entry
    """
    out = data.copy()
    if option == "all_one":
        out.norm = np.ones(data.nnz, dtype=np.float32)
    elif option == "deg_half_sym":
        vdeg = np.bincount(data.node, minlength=data.num_nodes).astype(np.float64)
        edeg = np.bincount(data.edge, minlength=data.num_hyperedges).astype(np.float64)
        with np.errstate(divide="ignore"):
            vn = vdeg ** -0.5
            en = edeg ** -0.5
        vn[~np.isfinite(vn)] = 0.0
        en[~np.isfinite(en)] = 0.0
        out.norm = (vn[data.node] * en[data.edge]).astype(np.float32)
    else:
        raise ValueError(f"unknown norm option {option!r}")
    return out


def expand_edge_index(data: HyperData, edge_th: int = 0) -> HyperData:
    """The 'exclude_self' expansion: each hyperedge of size k is split into
    k sub-edges, each excluding one member (so a node never aggregates its
    own feature). Reference ``src/preprocessing.py:22-144``; off by default
    (``src/train.py:281``). Singleton hyperedges become fresh singletons,
    in order, so self-loops appended by :func:`add_self_loops` stay the
    last ``num_sl_edges`` edges (``data.copy()`` keeps that count).
    """
    order = np.argsort(data.edge, kind="stable")
    nodes = data.node[order]
    edges = data.edge[order]
    boundaries = np.searchsorted(edges, np.arange(data.num_hyperedges + 1))

    new_node_parts = []
    new_edge_parts = []
    cur = 0
    for e in range(data.num_hyperedges):
        lo, hi = boundaries[e], boundaries[e + 1]
        k = hi - lo
        if k == 0:
            continue
        if edge_th > 0 and k > edge_th:
            continue
        members = nodes[lo:hi]
        if k == 1:
            new_node_parts.append(members)
            new_edge_parts.append(np.array([cur], dtype=np.int64))
            cur += 1
            continue
        # member i belongs to every sub-edge except its own: the (k, k)
        # grid minus the diagonal.
        rep_nodes = np.repeat(members, k)
        sub_ids = np.tile(np.arange(k, dtype=np.int64), k) + cur
        grid_i = np.repeat(np.arange(k), k)  # which member
        grid_j = np.tile(np.arange(k), k)  # which sub-edge
        keep = grid_i != grid_j
        new_node_parts.append(rep_nodes[keep])
        new_edge_parts.append(sub_ids[keep])
        cur += k

    out = data.copy()
    out.node = np.concatenate(new_node_parts)
    out.edge = np.concatenate(new_edge_parts)
    out.num_hyperedges = cur
    order = np.argsort(out.node, kind="stable")
    out.node, out.edge = out.node[order], out.edge[order]
    out.norm = None
    return out


def generate_norm_hnhn(
    data: HyperData, alpha: float = -1.5, beta: float = -0.5
) -> HyperData:
    """HNHN degree-powered norm vectors (reference
    ``src/preprocessing.py:295-340``), computed sparsely over the COO:

      D_e_alpha[e]     = d_e^alpha
      D_v_alpha_inv[v] = 1 / sum_{e ∋ v} d_e^alpha     (inf -> 0)
      D_v_beta[v]      = d_v^beta
      D_e_beta_inv[e]  = 1 / sum_{v ∈ e} d_v^beta      (inf -> 0)
    """
    dv = np.bincount(data.node, minlength=data.num_nodes).astype(np.float64)
    de = np.bincount(data.edge, minlength=data.num_hyperedges).astype(np.float64)
    with np.errstate(divide="ignore"):
        de_alpha = de ** alpha
        dv_beta = dv ** beta
    d_v_alpha = np.zeros(data.num_nodes)
    np.add.at(d_v_alpha, data.node, de_alpha[data.edge])
    d_e_beta = np.zeros(data.num_hyperedges)
    np.add.at(d_e_beta, data.edge, dv_beta[data.node])
    with np.errstate(divide="ignore"):
        d_v_alpha_inv = 1.0 / d_v_alpha
        d_e_beta_inv = 1.0 / d_e_beta
    d_v_alpha_inv[~np.isfinite(d_v_alpha_inv)] = 0.0
    d_e_beta_inv[~np.isfinite(d_e_beta_inv)] = 0.0

    out = data.copy()
    # isolated rows (degree 0 with a negative power) are never gathered
    out.extras.update(
        D_e_alpha=np.nan_to_num(de_alpha, posinf=0.0, neginf=0.0).astype(np.float32),
        D_v_alpha_inv=d_v_alpha_inv.astype(np.float32),
        D_v_beta=np.nan_to_num(dv_beta, posinf=0.0, neginf=0.0).astype(np.float32),
        D_e_beta_inv=d_e_beta_inv.astype(np.float32),
    )
    return out


def unignn_degrees(data: HyperData):
    """UniGCNII degree vectors (reference ``src/train.py:396-412``):
    degV = d_v^{-1/2} with inf -> 1, degE = (mean_{v in e} d_v)^{-1/2};
    both float32 columns [rows, 1]."""
    dv = np.bincount(data.node, minlength=data.num_nodes).astype(np.float64)
    sums = np.zeros(data.num_hyperedges)
    np.add.at(sums, data.edge, dv[data.node])
    cnt = np.maximum(np.bincount(data.edge, minlength=data.num_hyperedges), 1)
    degE = (sums / cnt) ** -0.5
    with np.errstate(divide="ignore"):
        degV = dv ** -0.5
    degV[~np.isfinite(degV)] = 1.0
    degE = np.nan_to_num(degE)
    return degV.astype(np.float32)[:, None], degE.astype(np.float32)[:, None]


def construct_v2v(data: HyperData):
    """Weighted clique expansion: each hyperedge contributes all (i<j) node
    pairs; pair weight = co-occurrence count across hyperedges.

    Reference ``src/preprocessing.py:343-391``. Returns (edge_index[2,P],
    weight[P]) with each pair stored once (i<j), as the reference does,
    in the native library's order (``native/hypercore.cpp``), or in
    first-seen order by the python loop where the library is absent.
    """
    native_out = native.clique_expand(data.node, data.edge, data.num_hyperedges)
    if native_out is not None:
        return native_out
    order = np.argsort(data.edge, kind="stable")
    nodes = data.node[order]
    edges = data.edge[order]
    boundaries = np.searchsorted(edges, np.arange(data.num_hyperedges + 1))

    pair_weight: Dict[tuple, int] = defaultdict(int)
    for e in range(data.num_hyperedges):
        lo, hi = boundaries[e], boundaries[e + 1]
        members = np.sort(nodes[lo:hi])
        k = len(members)
        if k <= 1:
            continue
        ii, jj = np.triu_indices(k, k=1)
        for a, b in zip(members[ii], members[jj]):
            pair_weight[(int(a), int(b))] += 1

    if not pair_weight:
        return np.zeros((2, 0), dtype=np.int64), np.zeros(0, dtype=np.float32)
    pairs = np.array(list(pair_weight.keys()), dtype=np.int64).T
    weights = np.array(list(pair_weight.values()), dtype=np.float32)
    return pairs, weights


def gcn_norm(
    edge_index: np.ndarray,
    edge_weight: Optional[np.ndarray],
    num_nodes: int,
    add_self_loops: bool = True,
):
    """PyG-style GCN normalization (the reference's
    ``torch_geometric.nn.conv.gcn_conv.gcn_norm`` at
    ``src/preprocessing.py:466-468``): append unit self-loops, then
    w_ij <- d_i^{-1/2} w_ij d_j^{-1/2} with d = weighted in-degree."""
    row, col = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    if edge_weight is None:
        edge_weight = np.ones(row.shape[0], dtype=np.float32)
    edge_weight = edge_weight.astype(np.float64)
    if add_self_loops:
        loop = np.arange(num_nodes, dtype=np.int64)
        row = np.concatenate([row, loop])
        col = np.concatenate([col, loop])
        edge_weight = np.concatenate([edge_weight, np.ones(num_nodes)])
    deg = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(deg, col, edge_weight)
    with np.errstate(divide="ignore"):
        dinv = deg ** -0.5
    dinv[~np.isfinite(dinv)] = 0.0
    norm = dinv[row] * edge_weight * dinv[col]
    return np.stack([row, col]), norm.astype(np.float32)


def hypergcn_edge_dict(data: HyperData) -> Dict[int, list]:
    """Hyperedge -> member-node list dict for the HyperGCN Laplacian builder
    (reference ``get_HyperGCN_He_dict``, ``src/preprocessing.py:148-183``)."""
    out: Dict[int, list] = {}
    order = np.argsort(data.edge, kind="stable")
    nodes, edges = data.node[order], data.edge[order]
    boundaries = np.searchsorted(edges, np.arange(data.num_hyperedges + 1))
    for e in range(data.num_hyperedges):
        lo, hi = boundaries[e], boundaries[e + 1]
        if hi > lo:
            out[e] = nodes[lo:hi].tolist()
    return out


def construct_h_dense(data: HyperData) -> np.ndarray:
    """Dense incidence H [N, M] (reference ``src/preprocessing.py:186-221``);
    only for the small legacy path."""
    H = np.zeros((data.num_nodes, data.num_hyperedges), dtype=np.float32)
    H[data.node, data.edge] = 1.0
    return H


def generate_g_from_h(H: np.ndarray) -> np.ndarray:
    """Legacy HGNN dense propagation matrix
    G = D_v^{-1/2} H W D_e^{-1} H^T D_v^{-1/2}
    (reference ``src/preprocessing.py:224-259``)."""
    W = np.ones(H.shape[1])
    DV = (H * W).sum(axis=1)
    DE = H.sum(axis=0)
    with np.errstate(divide="ignore"):
        invDE = np.where(DE > 0, 1.0 / DE, 0.0)
        DV2 = np.where(DV > 0, DV ** -0.5, 0.0)
    G = (DV2[:, None] * H * W[None, :] * invDE[None, :]) @ (H.T * DV2[None, :])
    return np.nan_to_num(G).astype(np.float32)


def rand_train_test_idx(
    label: np.ndarray,
    train_prop: float = 0.5,
    valid_prop: float = 0.25,
    ignore_negative: bool = True,
    balance: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """Random split (reference ``src/preprocessing.py:472-519``) drawn from
    an explicit numpy generator; nodes labelled -1 are left out."""
    if rng is None:
        rng = np.random.default_rng()
    label = np.asarray(label)
    if not balance:
        labeled = np.where(label != -1)[0] if ignore_negative else np.arange(len(label))
        n = len(labeled)
        train_num = int(n * train_prop)
        valid_num = int(n * valid_prop)
        perm = rng.permutation(n)
        return {
            "train": labeled[perm[:train_num]],
            "valid": labeled[perm[train_num : train_num + valid_num]],
            "test": labeled[perm[train_num + valid_num :]],
        }
    indices = []
    for c in range(label.max() + 1):
        idx = np.where(label == c)[0]
        indices.append(rng.permutation(idx))
    percls_trn = int(train_prop / (label.max() + 1) * len(label))
    val_lb = int(valid_prop * len(label))
    train_idx = np.concatenate([i[:percls_trn] for i in indices])
    rest = np.concatenate([i[percls_trn:] for i in indices])
    rest = rest[rng.permutation(len(rest))]
    return {
        "train": train_idx,
        "valid": rest[:val_lb],
        "test": rest[val_lb:],
    }
