"""UniGNN family (UniSAGE, UniGIN, UniGCN, UniGCN2, UniGAT) and UniGCNII.

Counterpart of ``allset_tpu/models/unignn.py`` (reference
``src/models.py:580-996``). Every conv but UniGAT is the two-stage idiom

    Xe = reduce_e(X[vertex]);  Xv = reduce_v(Xe[edges])

over the whole incidence (self-loop edges included, no split), routed
through the sorted exchange ``dir_spmm`` (K1 reduces, a permute-free
backward), with UniGCN's degE and degV as row scalings (``batch.extras``
from ``graph.transforms.unignn_degrees``). UniGAT gathers rows itself:
node rows by entry (B10), a reduce by the sorted hyperedge ids (K1), the
edge scores gathered back by entry (B10), a softmax over each node's
entries (``segment_softmax``: a scatter max, B10 gathers, the
denominators by K1 in the node-sorted order), the edge rows gathered again
(B10) and weighted, and a sum by node (K1 in the node-sorted order). Every
reduce by node and every gather's transpose runs K1 over the incidence's
precomputed sorted orders (``Incidence.node_order``/``edge_order``), so a
step adds in the same order every run.

Statistical runs: parameters carry a leading [R] axis, activations are
[rows, R, F], the sparse ops take the runs folded into the width, and the
dense products run run by run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.models.hcha import _leaky_relu
from allset_tpu_torch.nn.init import Generators, xavier_uniform_torch_fans
from allset_tpu_torch.nn.modules import (PReLU, TorchDense, dropout, fold, head_expand,
                                         normalize_l2, row_scale, runs_apply, runs_of, unfold)
from allset_tpu_torch.ops.exchange import dir_spmm
from allset_tpu_torch.ops.segment import gather_rows, segment_reduce, segment_softmax, segment_sum

Tensor = torch.Tensor


def _two_stage(x: Tensor, batch: Batch, first_aggregate: str, second_aggregate: str = "sum",
               scale_e: Optional[Tensor] = None, scale_v: Optional[Tensor] = None,
               R: Optional[int] = None):
    """(Xv, Xe) of the two-stage idiom through dir_spmm; 'mean' before a
    degE scaling folds its divisor into the scaling (one [E, F] pass).
    A batch's edge-partitioned exchange ``shex`` serves both passes when
    it was built unsplit (``allset_tpu/models/unignn.py:58-74``).
    scale_e, scale_v: [rows, 1] columns."""
    inc = batch.inc
    shex = batch.shex
    if shex is not None and shex.v2e.sl_mode != "none":
        shex = None  # UniGNN reads every entry alike: only an unsplit build applies
    dv = inc.v2e() if shex is None else shex.v2e
    de = inc.e2v() if shex is None else shex.e2v
    agg1 = {"sum": "add"}.get(first_aggregate, first_aggregate)
    agg2 = {"sum": "add"}.get(second_aggregate, second_aggregate)
    if agg1 == "mean" and scale_e is not None:
        scale_e = (scale_e.reshape(-1) / inc.edge_count.clamp_min(1.0))[:, None]
        agg1 = "add"
    xe = dir_spmm(fold(x, R), dv, reduce=agg1)
    if scale_e is not None:
        xe = row_scale(xe, scale_e[:, 0])
    xv = dir_spmm(xe, de, reduce=agg2)
    if scale_v is not None:
        xv = row_scale(xv, scale_v[:, 0])
    return unfold(xv, R), unfold(xe, R)


@dataclasses.dataclass(frozen=True)
class UniGNNConfig:
    num_features: int
    num_classes: int
    model_name: str = "UniGCN"  # UniGAT | UniGCN | UniGCN2 | UniGIN | UniSAGE
    all_num_layers: int = 2
    mlp_hidden: int = 8
    heads: int = 8
    dropout: float = 0.6
    input_drop: float = 0.6
    attn_drop: float = 0.6
    first_aggregate: str = "mean"
    second_aggregate: str = "sum"
    use_norm: bool = False
    activation: str = "relu"
    dtype: str = "float32"  # 'bfloat16' -> mixed precision


def _dt(cfg) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else None


class _Conv(nn.Module):
    def __init__(self, cfg, in_dim: int, out_channels: int, generator: Generators,
                 heads: int = 1):
        super().__init__()
        self.cfg, self.runs = cfg, runs_of(generator)
        self.H, self.C = heads, out_channels


class UniSAGEConv(_Conv):
    def __init__(self, cfg, in_dim, out_channels, generator, heads=1):
        super().__init__(cfg, in_dim, out_channels, generator, heads)
        self.W = TorchDense(in_dim, heads * out_channels, generator, dtype=_dt(cfg),
                            use_bias=False)

    def forward(self, x, batch, train=False, generator=None):
        c = self.cfg
        x = self.W(x)
        xv, _ = _two_stage(x, batch, c.first_aggregate, c.second_aggregate, R=self.runs)
        x = x + xv
        return normalize_l2(x) if c.use_norm else x


class UniGINConv(_Conv):
    def __init__(self, cfg, in_dim, out_channels, generator, heads=1):
        super().__init__(cfg, in_dim, out_channels, generator, heads)
        lead = () if self.runs is None else (self.runs,)
        self.eps = nn.Parameter(torch.zeros(lead + (1,)))
        self.W = TorchDense(in_dim, heads * out_channels, generator, dtype=_dt(cfg),
                            use_bias=False)

    def forward(self, x, batch, train=False, generator=None):
        c = self.cfg
        x = self.W(x)
        xv, _ = _two_stage(x, batch, c.first_aggregate, "sum", R=self.runs)
        scale = lambda x_r, e: (1 + e) * x_r  # noqa: E731
        x = (scale(x, self.eps) if self.runs is None else runs_apply(scale, x, self.eps)) + xv
        return normalize_l2(x) if c.use_norm else x


class UniGCNConv(_Conv):
    def __init__(self, cfg, in_dim, out_channels, generator, heads=1):
        super().__init__(cfg, in_dim, out_channels, generator, heads)
        self.W = TorchDense(in_dim, heads * out_channels, generator, dtype=_dt(cfg),
                            use_bias=False)

    def forward(self, x, batch, train=False, generator=None):
        c = self.cfg
        x = self.W(x)
        xv, _ = _two_stage(x, batch, c.first_aggregate, "sum", scale_e=batch.extras["degE"],
                           scale_v=batch.extras["degV"], R=self.runs)
        return normalize_l2(xv) if c.use_norm else xv


class UniGCNConv2(_Conv):
    """v2: X -> AX -> norm -> AXW (``src/models.py:742-788``)."""

    def __init__(self, cfg, in_dim, out_channels, generator, heads=1):
        super().__init__(cfg, in_dim, out_channels, generator, heads)
        self.W = TorchDense(in_dim, heads * out_channels, generator, dtype=_dt(cfg))

    def forward(self, x, batch, train=False, generator=None):
        c = self.cfg
        xv, _ = _two_stage(x, batch, c.first_aggregate, "sum", scale_e=batch.extras["degE"],
                           scale_v=batch.extras["degV"], R=self.runs)
        if c.use_norm:
            xv = normalize_l2(xv)
        return self.W(xv)


class UniGATConv(_Conv):
    def __init__(self, cfg, in_dim, out_channels, generator, heads=1,
                 negative_slope: float = 0.2, skip_sum: bool = False):
        super().__init__(cfg, in_dim, out_channels, generator, heads)
        self.negative_slope, self.skip_sum = negative_slope, skip_sum
        self.W = TorchDense(in_dim, heads * out_channels, generator, dtype=_dt(cfg),
                            use_bias=False)
        self.att_e = nn.Parameter(xavier_uniform_torch_fans((1, heads, out_channels),
                                                            generator))

    def _scores(self, xe, att):
        """One run's hyperedge scores [E, H]."""
        return (xe.reshape(-1, self.H, self.C) * att).sum(-1)

    def forward(self, x, batch, train=False, generator=None):
        c, inc, R = self.cfg, batch.inc, self.runs
        by_v, by_e = inc.node_order(), inc.edge_order()
        x0 = self.W(x)
        xve = gather_rows(fold(x0, R), inc.node, by_v)
        xe = segment_reduce(xve, inc.edge, inc.num_edges, c.first_aggregate,
                            order=by_e)  # [E, (R*)H*C]
        if R is None:
            alpha_e = self._scores(xe, self.att_e)
        else:
            xr = unfold(xe, R)
            alpha_e = fold(torch.stack([self._scores(xr[:, r].contiguous(), self.att_e[r])
                                        for r in range(R)], dim=1), R)
        a_ev = gather_rows(alpha_e, inc.edge, by_e)
        alpha = _leaky_relu(a_ev, self.negative_slope)
        alpha = segment_softmax(alpha, inc.node, inc.num_nodes, mask=inc.mask, order=by_v)
        alpha = dropout(unfold(alpha, R), c.attn_drop, train, generator)
        xev = gather_rows(xe, inc.edge, by_e) * fold(head_expand(alpha.to(xe.dtype), self.C), R)
        out = unfold(segment_sum(xev, inc.node, inc.num_nodes, order=by_v), R)
        if c.use_norm:
            out = normalize_l2(out)
        if self.skip_sum:
            out = out + x0
        return out


CONVS = {
    "UniGAT": UniGATConv,
    "UniGCN": UniGCNConv,
    "UniGCN2": UniGCNConv2,
    "UniGIN": UniGINConv,
    "UniSAGE": UniSAGEConv,
}


class UniGNN(nn.Module):
    """Generic UniGNN stack (``src/models.py:869-907``); returns logits (the
    loss applies log_softmax)."""

    def __init__(self, cfg: UniGNNConfig, generator: Generators):
        super().__init__()
        self.cfg, self.runs = cfg, runs_of(generator)
        Conv = CONVS[cfg.model_name]
        if cfg.activation != "relu":
            self.PReLU_0 = PReLU(() if self.runs is None else (self.runs,))
        in_dim = cfg.num_features
        self.num_hidden = cfg.all_num_layers - 1
        for i in range(self.num_hidden):
            self.add_module(f"conv{i}", Conv(cfg, in_dim, cfg.mlp_hidden, generator,
                                             heads=cfg.heads))
            in_dim = cfg.heads * cfg.mlp_hidden
        self.conv_out = Conv(cfg, in_dim, cfg.num_classes, generator, heads=1)

    def forward(self, batch: Batch, train: bool = False, generator=None) -> Tensor:
        c = self.cfg
        act = torch.relu if c.activation == "relu" else self.PReLU_0
        x = dropout(batch.x, c.input_drop, train, generator)
        for i in range(self.num_hidden):
            x = getattr(self, f"conv{i}")(x, batch, train, generator)
            x = act(x)
            x = dropout(x, c.dropout, train, generator)
        return self.conv_out(x, batch, train, generator).float()


@dataclasses.dataclass(frozen=True)
class UniGCNIIConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_hidden: int = 64
    heads: int = 1
    use_norm: bool = False
    dtype: str = "float32"  # 'bfloat16' -> mixed precision


class UniGCNIIConv(nn.Module):
    """GCNII-style identity-mapped conv (``src/models.py:911-944``)."""

    def __init__(self, cfg: UniGCNIIConfig, features: int, generator: Generators):
        super().__init__()
        self.cfg, self.runs = cfg, runs_of(generator)
        self.W = TorchDense(features, features, generator, dtype=_dt(cfg), use_bias=False)

    def forward(self, x, x0, alpha, beta, batch: Batch) -> Tensor:
        xv, _ = _two_stage(x, batch, "mean", "sum", scale_e=batch.extras["degE"],
                           scale_v=batch.extras["degV"], R=self.runs)
        if self.cfg.use_norm:
            xv = normalize_l2(xv)
        xi = (1 - alpha) * xv + alpha * x0.to(xv.dtype)
        return (1 - beta) * xi + beta * self.W(xi)


class UniGCNII(nn.Module):
    """UniGCNII (``src/models.py:948-996``): input linear, identity-mapping
    convs with beta = log(lamda/(i+1)+1), output linear; dropout 0.2,
    lamda 0.5 and alpha 0.1 as in the reference."""

    def __init__(self, cfg: UniGCNIIConfig, generator: Generators):
        super().__init__()
        self.cfg = cfg
        dt = _dt(cfg)
        nhid = cfg.mlp_hidden * cfg.heads
        self.lin_in = TorchDense(cfg.num_features, nhid, generator, dtype=dt)
        for i in range(cfg.all_num_layers):
            self.add_module(f"conv{i}", UniGCNIIConv(cfg, nhid, generator))
        self.lin_out = TorchDense(nhid, cfg.num_classes, generator, dtype=dt)

    def forward(self, batch: Batch, train: bool = False, generator=None) -> Tensor:
        c = self.cfg
        lamda, alpha = 0.5, 0.1
        x = dropout(batch.x, 0.2, train, generator)
        x = torch.relu(self.lin_in(x))
        x0 = x
        for i in range(c.all_num_layers):
            x = dropout(x, 0.2, train, generator)
            beta = math.log(lamda / (i + 1) + 1)
            x = torch.relu(getattr(self, f"conv{i}")(x, x0, alpha, beta, batch))
        x = dropout(x, 0.2, train, generator)
        return self.lin_out(x).float()
