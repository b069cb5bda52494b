"""HCHA / HGNN: Hypergraph Convolution (+ optional attention).

Counterpart of ``allset_tpu/models/hcha.py`` (reference
``src/layers.py:318-494`` and ``src/models.py:252-292``):

    X' = D^-1 H W B^-1 H^T X Theta          (HCHA)
    X' = D^-1/2 H W B^-1 H^T D^-1/2 X Theta (symdegnorm -> HGNN)

Without attention (the CLI's path) both passes are the sorted exchange
``dir_spmm`` with the destination norms B^-1 and D^-* pulled out of the
reduces as row scalings; on the self-loop split the V->E output is the
N-slot layout, scaled by [1/|e| of the real edges | sl_mask]; a batch
with an edge-partitioned exchange ``shex`` (``parallel/sharded.py``,
split or unsplit) runs both passes through it. With
attention each incidence entry is scored att . [x_i || x_e], softmaxed
over the node's entries (``segment_softmax``), and both passes gather
(B10) and reduce per entry, by K1 over the incidence's sorted orders (the
hyperedge ids as they are, the node ids in the node-sorted order), which
also serve the gathers' transposes.

Statistical runs (a list of generators): parameters carry a leading [R]
axis, activations are [rows, R, F], the sparse ops take the runs folded
into the width and the dense products run run by run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.nn.init import Generators, glorot_uniform, xavier_uniform_torch_fans
from allset_tpu_torch.nn.modules import (dropout, fold, head_expand, row_scale, runs_apply,
                                         runs_of, unfold)
from allset_tpu_torch.ops.exchange import dir_spmm
from allset_tpu_torch.ops.segment import gather_rows, segment_softmax, segment_sum

Tensor = torch.Tensor


def _safe_inv(x: Tensor, power: float = 1.0) -> Tensor:
    """1/x**power with empty (0) degrees -> 0."""
    return torch.where(x > 0, x.clamp_min(1e-30) ** -power, torch.zeros_like(x))


def _leaky_relu(x: Tensor, slope: float) -> Tensor:
    return torch.where(x >= 0, x, slope * x)


class HypergraphConv(nn.Module):
    def __init__(self, in_dim: int, out_channels: int, generator: Generators,
                 symdegnorm: bool = False, use_attention: bool = False, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2, dropout: float = 0.0,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.runs = runs_of(generator)
        lead = () if self.runs is None else (self.runs,)
        H = heads if use_attention else 1
        self.H, self.F = H, out_channels
        self.symdegnorm, self.use_attention, self.concat = symdegnorm, use_attention, concat
        self.negative_slope, self.p, self.dtype = negative_slope, dropout, dtype
        self.weight = nn.Parameter(glorot_uniform((in_dim, H * out_channels), generator))
        if use_attention:
            self.att = nn.Parameter(xavier_uniform_torch_fans((1, H, 2 * out_channels),
                                                              generator))
        if use_bias:
            width = H * out_channels if (use_attention and concat) else out_channels
            self.bias = nn.Parameter(torch.zeros(lead + (width,)))

    def _dense(self, x, w):
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
        return x @ w

    def _scores(self, x, att):
        """One run's per-node scores against att_i and att_e -> [N, H] each."""
        H, F = self.H, self.F
        xh = x.reshape(-1, H, F)
        return ((xh * att[..., :F]).sum(-1), (xh * att[..., F:]).sum(-1))

    def forward(self, x: Tensor, batch: Batch, train: bool = False, generator=None) -> Tensor:
        inc, R = batch.inc, self.runs
        n, H, F = inc.num_nodes, self.H, self.F
        x = self._dense(x, self.weight) if R is None else runs_apply(self._dense, x,
                                                                     self.weight)
        D, B = inc.node_count, inc.edge_count
        Binv = _safe_inv(B)
        if not self.symdegnorm:
            Dinv = _safe_inv(D)
        else:
            Dinv = _safe_inv(D, 0.5)
            x = row_scale(x, Dinv)

        if self.use_attention:
            if R is None:
                s_i, s_e = self._scores(x, self.att)
            else:
                s = [self._scores(x[:, r].contiguous(), self.att[r]) for r in range(R)]
                s_i = torch.stack([a for a, _ in s], dim=1)  # [N, R, H]
                s_e = torch.stack([b for _, b in s], dim=1)
            by_v, by_e = inc.node_order(), inc.edge_order()
            # the reference indexes x by hyperedge id here (src/layers.py:431)
            alpha = (gather_rows(fold(s_i, R), inc.node, by_v)
                     + gather_rows(fold(s_e, R), inc.edge.clamp_max(n - 1)))
            alpha = _leaky_relu(alpha, self.negative_slope)
            alpha = segment_softmax(alpha, inc.node, n, mask=inc.mask, order=by_v)
            alpha = fold(dropout(unfold(alpha, R), self.p, train, generator), R)
            ex = fold(head_expand(unfold(alpha, R), F), R)  # [nnz, R*H*F]

            def prop(h, src, by_src, dst, by_dst, num_seg, norm_dst):
                msg = row_scale(gather_rows(h, src, by_src), gather_rows(norm_dst, dst))
                return segment_sum(msg * ex.to(msg.dtype), dst, num_seg, order=by_dst)

            out = prop(fold(x, R), inc.node, by_v, inc.edge, by_e, inc.num_edges, Binv)
            out = unfold(prop(out, inc.edge, by_e, inc.node, by_v, n, Dinv), R)
        else:
            if batch.shex is not None:  # the edge-partitioned exchange, split or unsplit
                dv, de = batch.shex.v2e, batch.shex.e2v
            elif inc.real is not None:
                dv, de = inc.v2e_split(), inc.e2v_split()
            else:
                dv, de = inc.v2e(), inc.e2v()
            if dv.sl_mode == "append":
                scale_e = torch.cat([_safe_inv(inc.real.edge_count), inc.sl_mask])
            else:
                scale_e = Binv
            out = row_scale(dir_spmm(fold(x, R), dv), scale_e)
            out = unfold(row_scale(dir_spmm(out, de), Dinv), R)

        if self.use_attention and not self.concat:
            out = out.reshape(out.shape[:-1] + (H, F)).mean(dim=-2)
        if hasattr(self, "bias"):
            add = lambda o, b: o + b.to(o.dtype)  # noqa: E731
            out = add(out, self.bias) if R is None else runs_apply(add, out, self.bias)
        return out


@dataclasses.dataclass(frozen=True)
class HCHAConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_hidden: int = 64
    dropout: float = 0.5
    symdegnorm: bool = False  # True -> the HGNN variant
    dtype: str = "float32"  # 'bfloat16' -> mixed precision


class HCHA(nn.Module):
    """Stack of HypergraphConv with ELU + dropout (``src/models.py:280-292``)."""

    def __init__(self, cfg: HCHAConfig, generator: Generators):
        super().__init__()
        self.cfg = cfg
        self.runs = runs_of(generator)
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else None
        widths = [cfg.mlp_hidden] * (cfg.all_num_layers - 1) + [cfg.num_classes]
        self.num_layers = len(widths)
        for i, w in enumerate(widths):
            fan_in = cfg.num_features if i == 0 else cfg.mlp_hidden
            self.add_module(f"conv{i}", HypergraphConv(fan_in, w, generator,
                                                       symdegnorm=cfg.symdegnorm, dtype=dt))

    def forward(self, batch: Batch, train: bool = False, generator=None) -> Tensor:
        x = batch.x
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i}")(x, batch, train, generator)
            if i < self.num_layers - 1:
                x = torch.nn.functional.elu(x)
                x = dropout(x, self.cfg.dropout, train, generator)
        return x.float()
