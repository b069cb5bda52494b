"""HyperGCN: non-uniform hypergraph Laplacian graph approximation.

Counterpart of ``allset_tpu/models/hypergcn.py`` (reference
``src/models.py:29-77`` + ``src/utils.py:11-263``). Per hyperedge, member
features are projected on a random vector; the argmax/argmin
("supremum/infimum") pair is connected, plus optional mediator edges with
weight 1/(2k-3); the resulting graph is symmetrically normalized with unit
self-loops. Convolution is A @ (X W) + b: one ``dir_spmm`` over the
approximation's Incidence (a B10 gather, K1 by column), relu after every
layer, the output layer's included, as in the reference.

Two modes (``src/train.py:285`` defaults fast=True):
  * fast (:class:`HyperGCN`): the Laplacian is built ONCE from the input
    features on the host (:func:`build_hypergcn_laplacian`) and carried as
    the batch's Incidence;
  * reapproximate (:class:`HyperGCNReapprox`): the Laplacian is rebuilt on
    the host from the current activations in every forward
    (``src/utils.py:39-41``), with ``default_rng(seed + layer)`` each
    time, as the JAX package's host callback does; no static padding is
    needed here. It runs in f32, as the JAX model does. Runs are not
    folded: each run's structure follows its own activations, so the
    runs go one after another inside the forward, as the JAX package's
    ``vmap_method="sequential"`` callback does.

Layer init: W and bias ~ U(+-1/sqrt(out_features)) (``src/utils.py:27-30``).
Layer widths descend in powers of two: h = [d, 2^(l-i+2)..., c]
(``src/models.py:40-46``; citeseer uses l-i+4).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.graph.incidence import Incidence
from allset_tpu_torch.nn.init import Generators, uniform_symmetric
from allset_tpu_torch.nn.modules import dropout, fold, runs_apply, runs_of, unfold
from allset_tpu_torch.ops.exchange import dir_spmm

Tensor = torch.Tensor


def _laplacian_coo(
    num_nodes: int, edge_dict: Dict[int, List[int]], X: np.ndarray, mediators: bool, rng
):
    """(rows, cols, vals) of the symnormalized approximation adjacency."""
    rv = rng.random(X.shape[1])
    weights: Dict[tuple, float] = {}

    for members in edge_dict.values():
        members = list(members)
        k = len(members)
        if k == 0:
            continue
        p = X[members] @ rv
        Se, Ie = members[int(np.argmax(p))], members[int(np.argmin(p))]
        if mediators:
            c = 2 * k - 3 if 2 * k - 3 > 0 else 1
            for (a, b) in ((Se, Ie), (Ie, Se)):
                weights[(a, b)] = weights.get((a, b), 0.0) + 1.0 / c
            for mdt in members:
                if mdt != Se and mdt != Ie:
                    for (a, b) in ((Se, mdt), (Ie, mdt), (mdt, Se), (mdt, Ie)):
                        weights[(a, b)] = weights.get((a, b), 0.0) + 1.0 / c
        else:
            for (a, b) in ((Se, Ie), (Ie, Se)):
                weights[(a, b)] = weights.get((a, b), 0.0) + 1.0 / k

    # accumulate + unit self loops
    for v in range(num_nodes):
        weights[(v, v)] = weights.get((v, v), 0.0) + 1.0

    rows = np.fromiter((k[0] for k in weights), dtype=np.int64, count=len(weights))
    cols = np.fromiter((k[1] for k in weights), dtype=np.int64, count=len(weights))
    vals = np.fromiter(weights.values(), dtype=np.float64, count=len(weights))

    # D^{-1/2} A D^{-1/2}, D = row sums (src/utils.py:203-221)
    deg = np.zeros(num_nodes)
    np.add.at(deg, rows, vals)
    with np.errstate(divide="ignore"):
        dinv = deg ** -0.5
    dinv[~np.isfinite(dinv)] = 0.0
    vals = dinv[rows] * vals * dinv[cols]
    return rows, cols, vals.astype(np.float32)


def build_hypergcn_laplacian(
    num_nodes: int,
    edge_dict: Dict[int, List[int]],
    X: np.ndarray,
    mediators: bool = True,
    seed: int = 0,
    bucket: int = 256,
) -> Incidence:
    """The approximation's Incidence (entries sorted by column, stably),
    from ``X`` on the host; the fast path builds it once from the raw
    features (``src/models.py:48-50``)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = _laplacian_coo(num_nodes, edge_dict, np.asarray(X), mediators, rng)
    return Incidence.from_arrays(
        rows, cols, norm=vals, num_nodes=num_nodes, num_edges=num_nodes, bucket=bucket,
    )


def laplacian_nnz_bound(edge_dict: Dict[int, List[int]], num_nodes: int, mediators: bool) -> int:
    """Upper bound on the approximation's nnz (the JAX package pads its
    callback output to it; here it sizes the trainer's memory estimate)."""
    total = num_nodes  # self loops
    for members in edge_dict.values():
        k = len(members)
        total += 2 + (4 * max(k - 2, 0) if mediators else 0)
    return total


@dataclasses.dataclass(frozen=True)
class HyperGCNConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    dropout: float = 0.5
    mediators: bool = True
    fast: bool = True
    dname: str = ""  # citeseer gets wider powers (src/models.py:43-44)
    dtype: str = "float32"  # 'bfloat16' -> mixed precision (fast path)
    # the reapprox path's host data: hyperedge -> member nodes, and the
    # seed of its projections (default_rng(seed + layer))
    edge_dict: Optional[dict] = dataclasses.field(default=None, compare=False, repr=False)
    seed: int = 0

    def widths(self) -> List[int]:
        l = self.all_num_layers  # noqa: E741
        h = [self.num_features]
        for i in range(l - 1):
            power = l - i + 4 if self.dname == "citeseer" else l - i + 2
            h.append(2 ** power)
        h.append(self.num_classes)
        return h


class HyperGCNLayer(nn.Module):
    """relu-free A (x W) + b over a Laplacian Incidence; W, bias ~
    U(+-1/sqrt(out_features))."""

    def __init__(self, in_dim: int, out_features: int, generator: Generators,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.runs, self.dtype = runs_of(generator), dtype
        std = 1.0 / math.sqrt(out_features)
        self.W = nn.Parameter(uniform_symmetric((in_dim, out_features), std, generator))
        self.bias = nn.Parameter(uniform_symmetric((out_features,), std, generator))

    def _dense(self, x, w):
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
        return x @ w

    def forward(self, x: Tensor, struct: Incidence) -> Tensor:
        R = self.runs
        hw = self._dense(x, self.W) if R is None else runs_apply(self._dense, x, self.W)
        out = unfold(dir_spmm(fold(hw, R), struct.v2e(), norm=struct.norm)[: struct.num_nodes],
                     R)
        add = lambda o, b: o + b.to(o.dtype)  # noqa: E731
        return add(out, self.bias) if R is None else runs_apply(add, out, self.bias)


def _dt(cfg) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else None


class HyperGCN(nn.Module):
    """Fast-path HyperGCN over ``batch.inc``, the Laplacian built once."""

    def __init__(self, cfg: HyperGCNConfig, generator: Generators):
        super().__init__()
        self.cfg = cfg
        widths = cfg.widths()
        self.num_layers = len(widths) - 1
        for i in range(self.num_layers):
            self.add_module(f"layer{i}", HyperGCNLayer(widths[i], widths[i + 1], generator,
                                                       dtype=_dt(cfg)))

    def forward(self, batch: Batch, train: bool = False, generator=None) -> Tensor:
        dt = _dt(self.cfg)
        h = batch.x if dt is None else batch.x.to(dt)
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"layer{i}")(h, batch.inc))
            if i < self.num_layers - 1:
                h = dropout(h, self.cfg.dropout, train, generator)
        return h.float()


class HyperGCNReapprox(nn.Module):
    """The reference's slow path (``HyperGCN_fast=False``): every forward
    re-approximates each layer's Laplacian on the host from that run's
    current ``x W`` (detached), then A (x W) + b, relu, dropout between
    layers. Parameters ``W{i}``, ``bias{i}`` as in the JAX model; f32."""

    def __init__(self, cfg: HyperGCNConfig, generator: Generators):
        super().__init__()
        if cfg.edge_dict is None:
            raise ValueError("HyperGCNReapprox needs the config's edge_dict")
        self.cfg, self.runs = cfg, runs_of(generator)
        widths = cfg.widths()
        self.num_layers = len(widths) - 1
        for i in range(self.num_layers):
            std = 1.0 / math.sqrt(widths[i + 1])
            self.register_parameter(f"W{i}", nn.Parameter(
                uniform_symmetric((widths[i], widths[i + 1]), std, generator)))
            self.register_parameter(f"bias{i}", nn.Parameter(
                uniform_symmetric((widths[i + 1],), std, generator)))
        self.host_seconds = 0.0  # host time spent building Laplacians

    def structure(self, hw: Tensor, layer: int) -> Incidence:
        """The Laplacian of ``hw`` (one run's [N, F]) on the host, on hw's
        device."""
        t0 = time.perf_counter()
        c, n = self.cfg, hw.shape[0]
        rows, cols, vals = _laplacian_coo(n, c.edge_dict, hw.detach().float().cpu().numpy(),
                                          c.mediators, np.random.default_rng(c.seed + layer))
        inc = Incidence.from_arrays(rows, cols, norm=vals, num_nodes=n, num_edges=n).to(hw.device)
        self.host_seconds += time.perf_counter() - t0
        return inc

    def _run(self, x: Tensor, params, train: bool, generator) -> Tensor:
        h = x
        for i, (W, b) in enumerate(params):
            hw = h @ W
            struct = self.structure(hw, i)
            h = torch.relu(dir_spmm(hw, struct.v2e(), norm=struct.norm)[: struct.num_nodes] + b)
            if i < self.num_layers - 1:
                h = dropout(h, self.cfg.dropout, train, generator)
        return h

    def forward(self, batch: Batch, train: bool = False, generator=None) -> Tensor:
        params = [(getattr(self, f"W{i}"), getattr(self, f"bias{i}"))
                  for i in range(self.num_layers)]
        if self.runs is None:
            return self._run(batch.x, params, train, generator)
        gens = generator if generator is not None else [None] * self.runs
        return torch.stack([self._run(batch.x, [(W[r], b[r]) for W, b in params], train, gens[r])
                            for r in range(self.runs)], dim=1)


def build_hypergcn(cfg: HyperGCNConfig, generator: Generators) -> nn.Module:
    """HyperGCN (fast) or HyperGCNReapprox, as ``cfg.fast`` says."""
    return (HyperGCN if cfg.fast else HyperGCNReapprox)(cfg, generator)
