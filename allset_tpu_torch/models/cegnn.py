"""Clique-expansion baselines: CEGCN / CEGAT.

Counterpart of ``allset_tpu/models/cegnn.py`` (reference
``src/models.py:80-183``): hyperedges are expanded into weighted
node-node pairs (``graph.transforms.construct_v2v``), then graph convs
run on the resulting directed V2V graph, each pair once (i<j), plus the
self-loops the factory appends. The V2V graph is carried as an Incidence
whose 'edge' space is the node space (num_edges == num_nodes): entry i
sends node[i] to edge[i], and the canonical order sorts the destinations.

GCNConv follows PyG's GCNConv(normalize=False): X' = A_norm (X W) + b with
A_norm precomputed by gcn_norm, one ``dir_spmm`` (a B10 gather of the
source rows, K1 by destination). GATConv follows PyG 1.6.x GATConv:
per-head scores att_l . x_src + att_r . x_dst in f32, leaky_relu, a
softmax over each destination's incoming entries, attention dropout
(0.6 by default, not the model's dropout), then the source rows gathered
(``dir_gather``, B10), weighted per head in h's dtype and summed by
destination (``dir_reduce``, K1); heads concatenate except on the output
layer, where they are averaged. The destination ids are the canonical
order's sorted ids (``Incidence.edge_order``), so the three gathers of
[rows, heads] score tables by destination (a_dst, the segment max and the
denominators) and the softmax sum's transpose take B9 where the row is
narrow (``ops/cuda_gather.py::gather_route``); the source scores are
gathered in the node-sorted order (``node_order``), whose K1 sum is their
transpose.

Between convs: relu, under ``normalization='bn'`` a BatchNorm ``bn{i}``
(flax's, momentum 0.9, eps 1e-5, as the JAX models), then dropout.

Statistical runs (a list of generators): parameters carry a leading [R]
axis, activations are [rows, R, F], the sparse ops take the runs folded
into the width and the dense products and scores run run by run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.models.hcha import _leaky_relu
from allset_tpu_torch.nn.init import Generators, glorot_uniform, xavier_uniform_torch_fans
from allset_tpu_torch.nn.modules import (BatchNorm, dropout, fold, head_expand, per_run,
                                         runs_apply, runs_of, unfold)
from allset_tpu_torch.ops.exchange import dir_gather, dir_reduce, dir_spmm
from allset_tpu_torch.ops.segment import gather_rows, segment_softmax

Tensor = torch.Tensor


class _Conv(nn.Module):
    def __init__(self, generator: Generators, width: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.runs, self.dtype = runs_of(generator), dtype
        lead = () if self.runs is None else (self.runs,)
        self._bias_shape = lead + (width,)

    def _dense(self, x, w):
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
        return x @ w

    def _h(self, x: Tensor) -> Tensor:
        """x W, run by run with runs: [N, (R,) out]."""
        if self.runs is None:
            return self._dense(x, self.weight)
        return runs_apply(self._dense, x, self.weight)

    def _add_bias(self, out: Tensor) -> Tensor:
        add = lambda o, b: o + b.to(o.dtype)  # noqa: E731
        return add(out, self.bias) if self.runs is None else runs_apply(add, out, self.bias)


class GCNConv(_Conv):
    """PyG GCNConv(normalize=False): out = sum over entries of norm *
    (XW)[src] by dst, plus b."""

    def __init__(self, in_dim: int, out_channels: int, generator: Generators,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(generator, out_channels, dtype)
        self.weight = nn.Parameter(glorot_uniform((in_dim, out_channels), generator))
        self.bias = nn.Parameter(torch.zeros(self._bias_shape))

    def forward(self, x: Tensor, batch: Batch) -> Tensor:
        g, R = batch.inc, self.runs
        out = dir_spmm(fold(self._h(x), R), g.v2e(), norm=g.norm)[: g.num_nodes]
        return self._add_bias(unfold(out, R))


class GATConv(_Conv):
    def __init__(self, in_dim: int, out_channels: int, generator: Generators, heads: int = 1,
                 dtype: Optional[torch.dtype] = None, concat: bool = True,
                 negative_slope: float = 0.2, dropout: float = 0.6):
        super().__init__(generator, heads * out_channels if concat else out_channels, dtype)
        self.H, self.C = heads, out_channels
        self.concat, self.negative_slope, self.p = concat, negative_slope, dropout
        self.weight = nn.Parameter(glorot_uniform((in_dim, heads * out_channels), generator))
        shape = (1, heads, out_channels)
        self.att_l = nn.Parameter(xavier_uniform_torch_fans(shape, generator))
        self.att_r = nn.Parameter(xavier_uniform_torch_fans(shape, generator))
        self.bias = nn.Parameter(torch.zeros(self._bias_shape))

    def _scores(self, h: Tensor, att: Tensor) -> Tensor:
        """One run's per-head scores [N, H] in f32."""
        return (h.reshape(-1, self.H, self.C) * att).sum(-1).float()

    def forward(self, x: Tensor, batch: Batch, train: bool = False, generator=None) -> Tensor:
        g, R, H, C = batch.inc, self.runs, self.H, self.C
        if R is None:
            h = self._dense(x, self.weight)
            a_src, a_dst = self._scores(h, self.att_l), self._scores(h, self.att_r)
        else:
            # each run's x W kept whole: its gradient, the scores' and the
            # gather's summed, is then a contiguous [N, HC] as a single run's
            hs = [self._dense(xr, w) for xr, w in zip(per_run(x, R), self.weight.unbind(0))]
            a_src = fold(torch.stack([self._scores(t, self.att_l[r]) for r, t in enumerate(hs)],
                                     dim=1), R)
            a_dst = fold(torch.stack([self._scores(t, self.att_r[r]) for r, t in enumerate(hs)],
                                     dim=1), R)
            h = torch.stack(hs, dim=1)
        by_v, by_e = g.node_order(), g.edge_order()
        alpha = gather_rows(a_src, g.node, by_v) + gather_rows(a_dst, g.edge, by_e)
        alpha = _leaky_relu(alpha, self.negative_slope)
        alpha = segment_softmax(alpha, g.edge, g.num_nodes, mask=g.mask, order=by_e)
        alpha = dropout(unfold(alpha, R), self.p, train, generator)
        d = g.v2e()
        msg = dir_gather(fold(h, R), d) * fold(head_expand(alpha.to(h.dtype), C), R)
        out = unfold(dir_reduce(msg, d, "add")[: g.num_nodes], R)
        if not self.concat:
            out = out.reshape(out.shape[:-1] + (H, C)).mean(dim=-2)
        return self._add_bias(out)


@dataclasses.dataclass(frozen=True)
class CEConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_hidden: int = 64
    dropout: float = 0.5
    normalization: str = "None"  # 'bn': BatchNorm between convs; anything else: none
    heads: int = 1
    output_heads: int = 1
    dtype: str = "float32"  # 'bfloat16' -> mixed precision
    conv: str = "GCN"  # 'GCN' -> CEGCN, 'GAT' -> CEGAT


def _dt(cfg) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else None


class _CE(nn.Module):
    """What CEGCN and CEGAT share: between convs relu, under 'bn' a
    BatchNorm ``bn{i}`` (momentum 0.9, eps 1e-5, f32 output as the JAX
    module's, which takes no dtype), then dropout."""

    def _between(self, i: int, x: Tensor, train: bool, generator) -> Tensor:
        x = torch.relu(x)
        if self.cfg.normalization == "bn":
            x = getattr(self, f"bn{i}")(x, train)
        return dropout(x, self.cfg.dropout, train, generator)

    def _add_bns(self, count: int, width: int, generator: Generators) -> None:
        if self.cfg.normalization == "bn":
            R = runs_of(generator)
            for i in range(count):
                self.add_module(f"bn{i}", BatchNorm(width, () if R is None else (R,)))


class CEGCN(_CE):
    """GCN stack on the clique expansion (``src/models.py:80-128``): relu,
    the batch norm under 'bn', and dropout between convs."""

    def __init__(self, cfg: CEConfig, generator: Generators):
        super().__init__()
        self.cfg = cfg
        widths = [cfg.mlp_hidden] * (cfg.all_num_layers - 1) + [cfg.num_classes]
        self.num_layers = len(widths)
        in_dim = cfg.num_features
        for i, w in enumerate(widths):
            self.add_module(f"conv{i}", GCNConv(in_dim, w, generator, dtype=_dt(cfg)))
            in_dim = w
        self._add_bns(self.num_layers - 1, cfg.mlp_hidden, generator)

    def forward(self, batch: Batch, train: bool = False, generator=None) -> Tensor:
        x = batch.x
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i}")(x, batch)
            if i < self.num_layers - 1:
                x = self._between(i, x, train, generator)
        return x.float()


class CEGAT(_CE):
    """GAT stack on the clique expansion (``src/models.py:131-183``):
    hidden convs of ``heads`` heads concatenated, relu, the batch norm
    under 'bn' and dropout between convs, an output conv of
    ``output_heads`` heads averaged."""

    def __init__(self, cfg: CEConfig, generator: Generators):
        super().__init__()
        self.cfg = cfg
        self.num_hidden = cfg.all_num_layers - 1
        in_dim = cfg.num_features
        for i in range(self.num_hidden):
            self.add_module(f"conv{i}", GATConv(in_dim, cfg.mlp_hidden, generator,
                                                heads=cfg.heads, dtype=_dt(cfg)))
            in_dim = cfg.heads * cfg.mlp_hidden
        self.add_module(f"conv{self.num_hidden}",
                        GATConv(in_dim, cfg.num_classes, generator, heads=cfg.output_heads,
                                dtype=_dt(cfg), concat=False))
        self._add_bns(self.num_hidden, cfg.heads * cfg.mlp_hidden, generator)

    def forward(self, batch: Batch, train: bool = False, generator=None) -> Tensor:
        x = batch.x
        for i in range(self.num_hidden):
            x = getattr(self, f"conv{i}")(x, batch, train, generator)
            x = self._between(i, x, train, generator)
        return getattr(self, f"conv{self.num_hidden}")(x, batch, train, generator).float()


def build_ce(cfg: CEConfig, generator: Generators) -> nn.Module:
    """CEGCN or CEGAT, as ``cfg.conv`` says."""
    models = {"GCN": CEGCN, "GAT": CEGAT}
    if cfg.conv not in models:
        raise ValueError(f"unknown CE conv {cfg.conv!r}; expected one of {sorted(models)}")
    return models[cfg.conv](cfg, generator)
