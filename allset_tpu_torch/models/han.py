"""HAN: Heterogeneous Graph Attention Network over metapath graphs.

Counterpart of ``allset_tpu/models/han.py`` (reference
``src/DGL_HAN/model.py``): one DGL-style GAT per metapath graph, a
semantic attention softmax over the per-metapath embeddings, stacked, then
a linear predictor. The metapath graphs (VEV, EVE) come from
``graph/metapath.py::build_metapath_graphs``.

DGL GATConv semantics: feature dropout on the inputs, attention dropout
on the softmaxed alphas, leaky_relu(0.2) scores, ELU, xavier-normal
(gain sqrt(2)) init, heads concatenated. Parameter names are the flax
names (``gat_l{i}_p{j}/fc``, ``attn_l``, ``attn_r``, ``sem_l{i}/proj1``,
``proj2``, ``predict``; SampledHAN's ``gat_p{j}`` and ``sem``), so
``utils/jax_bridge.py::params_from_jax`` loads the JAX trees as they are.
Single run: every parameter is f32 without a runs axis, as the JAX
package's HAN trainers are not vmapped.

``DGLGATConv`` has the JAX package's two compositions, chosen as there by
the graph: an Incidence with its node-sorted order takes the packed path,
one without it (``node_perm`` None: the reference composition, as the
flat legacy extras build it) the reference path. The packed path folds
the el/er score projections into the feature GEMM, ``x @ [w | w Pl |
w Pr]``, shifts the softmax by a global per-head bound
``leaky(colmax el + colmax er)`` (exact by shift invariance: leaky_relu is
monotone), and reduces one packed ``[h * e | e]`` table, so on the card
the conv is B10 (``dir_gather`` of the ``[T, HC + H]`` table), B9 (the
destination scores ``er[dst]``: a 4 H-byte row by sorted ids) and K1 (the
reduce by destination), with K1 and B10 again in the gathers' backward
(``ops/segment.py``). The reference path is ``segment_softmax`` over
unsorted ids, a gather and a ``segment_sum``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.graph.incidence import Incidence, SegOrder
from allset_tpu_torch.models.hcha import _leaky_relu
from allset_tpu_torch.nn.modules import TorchDense, dropout, head_expand
from allset_tpu_torch.ops.cuda_gather import gather
from allset_tpu_torch.ops.exchange import dir_gather, dir_reduce
from allset_tpu_torch.ops.segment import gather_rows, segment_softmax, segment_sum

Tensor = torch.Tensor

DEN_FLOOR = 1e-16  # the packed path's denominator floor


def xavier_normal_gain(gain: float):
    """N(0, gain * sqrt(2 / (fan_in + fan_out))) drawn from a generator:
    fans of an [in, out] kernel, or torch's fans for the (1, H, C)
    attention vectors (fan_in H*C, fan_out C)."""
    def init(shape, generator: torch.Generator) -> Tensor:
        fan_in, fan_out = shape[0], shape[-1]
        if len(shape) == 3:
            fan_in, fan_out = shape[1] * shape[2], shape[2]
        std = gain * math.sqrt(2.0 / (fan_in + fan_out))
        return std * torch.randn(shape, generator=generator)

    return init


_GAT_INIT = xavier_normal_gain(math.sqrt(2.0))


class DGLGATConv(nn.Module):
    """DGL-style GATConv over an Incidence taken as a graph: entry i sends
    node[i] to edge[i], both in one id space (``num_nodes == num_edges``);
    the output has a row per id, [T, heads * out_channels]."""

    def __init__(self, in_dim: int, out_channels: int, heads: int,
                 generator: torch.Generator, feat_drop: float = 0.0,
                 attn_drop: float = 0.0, negative_slope: float = 0.2, use_elu: bool = True):
        super().__init__()
        self.H, self.C = heads, out_channels
        self.feat_drop, self.attn_drop = feat_drop, attn_drop
        self.negative_slope, self.use_elu = negative_slope, use_elu
        self.fc = nn.Parameter(_GAT_INIT((in_dim, heads * out_channels), generator))
        self.attn_l = nn.Parameter(_GAT_INIT((1, heads, out_channels), generator))
        self.attn_r = nn.Parameter(_GAT_INIT((1, heads, out_channels), generator))

    def forward(self, g: Incidence, x: Tensor, train: bool = False, generator=None) -> Tensor:
        x = dropout(x, self.feat_drop, train, generator)
        if g.node_perm is not None:
            out = self._packed(g, x, train, generator)
        else:
            out = self._reference(g, x, train, generator)
        return F.elu(out) if self.use_elu else out

    def _packed(self, g: Incidence, x: Tensor, train: bool, generator) -> Tensor:
        H, C = self.H, self.C
        HC = H * C
        d = g.v2e()
        blk = (torch.arange(HC, device=x.device)[:, None] // C
               == torch.arange(H, device=x.device)[None, :]).to(x.dtype)
        Pl = self.attn_l.reshape(HC)[:, None] * blk  # [HC, H] block one-hot
        Pr = self.attn_r.reshape(HC)[:, None] * blk
        w = self.fc
        yf = x @ torch.cat([w, w @ Pl, w @ Pr], dim=1)  # ONE GEMM: [values | el | er]
        h, el, er = yf[:, :HC], yf[:, HC:HC + H], yf[:, HC + H:]
        with torch.no_grad():  # an upper bound of every score; no gradient
            gmax = _leaky_relu(el.amax(dim=0) + er.amax(dim=0), self.negative_slope)
            gmax = gmax.clamp_min(0.0)  # empty-table guard
        pj = dir_gather(torch.cat([h, el], dim=1), d)  # [nnz_pad, HC + H]
        er_j = gather_rows(er, d.dst, SegOrder(None, d.indptr, d.plan))
        e = torch.exp(_leaky_relu(pj[:, HC:] + er_j, self.negative_slope) - gmax)
        # DGL drops the normalised alphas; mask * e / den == mask * (e / den),
        # so dropout rides the numerator and the denominator stays undropped
        e_num = dropout(e, self.attn_drop, train, generator)
        agg = dir_reduce(torch.cat([pj[:, :HC] * head_expand(e_num, C), e], dim=1), d, "add")
        return agg[:, :HC] / head_expand(agg[:, HC:].clamp_min(DEN_FLOOR), C)

    def _reference(self, g: Incidence, x: Tensor, train: bool, generator) -> Tensor:
        H, C = self.H, self.C
        h = x @ self.fc
        el = (h.reshape(-1, H, C) * self.attn_l).sum(-1)  # [T, H]
        er = (h.reshape(-1, H, C) * self.attn_r).sum(-1)
        alpha = _leaky_relu(gather_rows(el, g.node) + gather_rows(er, g.edge),
                            self.negative_slope)
        alpha = segment_softmax(alpha, g.edge, g.num_edges, mask=g.mask)
        alpha = dropout(alpha, self.attn_drop, train, generator)
        return segment_sum(gather_rows(h, g.node) * head_expand(alpha, C), g.edge, g.num_edges)


class SemanticAttention(nn.Module):
    """Softmax over metapaths of a projected mean score
    (``DGL_HAN/model.py:7-22``): z [T, P, D] -> [T, D]."""

    def __init__(self, in_dim: int, generator: torch.Generator, hidden_size: int = 128):
        super().__init__()
        self.proj1 = TorchDense(in_dim, hidden_size, generator)
        self.proj2 = TorchDense(hidden_size, 1, generator, use_bias=False)

    def forward(self, z: Tensor) -> Tensor:
        w = self.proj2(torch.tanh(self.proj1(z)))  # [T, P, 1]
        beta = torch.softmax(w.mean(dim=0), dim=0)  # [P, 1]
        return (beta[None] * z).sum(dim=1)


@dataclasses.dataclass(frozen=True)
class HANConfig:
    num_features: int
    num_classes: int
    hidden_units: int = 8
    num_heads: Tuple[int, ...] = (8,)
    dropout: float = 0.6


class MetapathStack(nn.Module):
    """P metapath graphs per layer: one DGLGATConv each (``gat_l{i}_p{j}``),
    semantic attention across them (``sem_l{i}``), then ``predict``. HAN
    (VEV and EVE from a Batch) and graph/hetero.py's MetapathHAN (any
    metapath list) are this stack."""

    def __init__(self, cfg: HANConfig, num_paths: int, generator: torch.Generator):
        super().__init__()
        self.cfg, self.num_paths = cfg, num_paths
        in_dim = cfg.num_features
        for li, heads in enumerate(cfg.num_heads):
            for gi in range(num_paths):
                self.add_module(f"gat_l{li}_p{gi}", DGLGATConv(
                    in_dim, cfg.hidden_units, heads, generator,
                    feat_drop=cfg.dropout, attn_drop=cfg.dropout))
            in_dim = heads * cfg.hidden_units
            self.add_module(f"sem_l{li}", SemanticAttention(in_dim, generator))
        self.predict = TorchDense(in_dim, cfg.num_classes, generator)

    def stack(self, graphs: Sequence[Incidence], x: Tensor, train: bool, generator) -> Tensor:
        if len(graphs) != self.num_paths:
            raise ValueError(f"{len(graphs)} metapath graphs for a stack of {self.num_paths}")
        h = x
        for li in range(len(self.cfg.num_heads)):
            z = torch.stack([getattr(self, f"gat_l{li}_p{gi}")(g, h, train, generator)
                             for gi, g in enumerate(graphs)], dim=1)  # [T, P, D]
            h = getattr(self, f"sem_l{li}")(z)
        return self.predict(h)


def _flat_incidence(extras: Dict[str, Tensor], name: str, T: int) -> Incidence:
    """The JAX package's flat legacy keys ``{name}_node/_edge/_norm/_mask``
    as an Incidence over T ids without its sorted orders: DGLGATConv takes
    the reference composition on it."""
    node = extras[f"{name}_node"]
    unsorted = dict.fromkeys(("edge_indptr", "node_indptr", "edge_plan", "node_plan",
                              "node_perm", "inv_node_perm", "node_sorted", "edge_by_node",
                              "node_count", "edge_count"))
    return Incidence(node=node, edge=extras[f"{name}_edge"], norm=extras[f"{name}_norm"],
                     mask=extras[f"{name}_mask"], num_nodes=T, num_edges=T,
                     nnz=int(node.shape[0]), **unsorted)


class HAN(MetapathStack):
    """HAN over ``batch.extras``' VEV and EVE metapath graphs (whole
    Incidences, :func:`han_extras`; the flat legacy keys are accepted too,
    on the reference composition)."""

    def __init__(self, cfg: HANConfig, generator: torch.Generator):
        super().__init__(cfg, 2, generator)

    def forward(self, batch: Batch, train: bool = False, generator=None) -> Tensor:
        graphs = [batch.extras[name] if name in batch.extras
                  else _flat_incidence(batch.extras, name, batch.num_nodes)
                  for name in ("vev", "eve")]
        return self.stack(graphs, batch.x, train, generator)


class BlockGATConv(nn.Module):
    """GAT over a sampled block: each seed attends over its fixed-size
    [K+1] neighbour set, the dense regular-shape form of DGL's
    block-GATConv used by the sampled trainer
    (``DGL_HAN/train_sampling.py:28-90``). Plain PyTorch: the JAX package
    computes it outside any Pallas kernel."""

    def __init__(self, in_dim: int, out_channels: int, heads: int,
                 generator: torch.Generator, feat_drop: float = 0.0,
                 attn_drop: float = 0.0, negative_slope: float = 0.2):
        super().__init__()
        self.H, self.C = heads, out_channels
        self.feat_drop, self.attn_drop, self.negative_slope = feat_drop, attn_drop, negative_slope
        self.fc = nn.Parameter(_GAT_INIT((in_dim, heads * out_channels), generator))
        self.attn_l = nn.Parameter(_GAT_INIT((1, heads, out_channels), generator))
        self.attn_r = nn.Parameter(_GAT_INIT((1, heads, out_channels), generator))

    def forward(self, h_src: Tensor, h_dst: Tensor, mask: Tensor, train: bool = False,
                generator=None) -> Tensor:
        """h_src [B, K+1, F], h_dst [B, F], mask [B, K+1] -> [B, H*C]."""
        H, C = self.H, self.C
        h_src = dropout(h_src, self.feat_drop, train, generator)
        h_dst = dropout(h_dst, self.feat_drop, train, generator)
        zs = h_src @ self.fc  # [B, K+1, H*C]
        zd = h_dst @ self.fc  # [B, H*C]
        B, K1 = zs.shape[0], zs.shape[1]
        zs = zs.reshape(B, K1, H, C)
        el = (zs * self.attn_l[None]).sum(-1)  # [B, K+1, H]
        er = (zd.reshape(B, H, C) * self.attn_r).sum(-1)  # [B, H]
        scores = _leaky_relu(el + er[:, None, :], self.negative_slope)
        m = mask[..., None]
        scores = torch.where(m, scores, torch.full((), -1e30, device=scores.device))
        alpha = torch.where(m, torch.softmax(scores, dim=1), torch.zeros((), device=m.device))
        alpha = dropout(alpha, self.attn_drop, train, generator)
        return F.elu(torch.einsum("bkh,bkhc->bhc", alpha, zs).reshape(B, H * C))


class SampledHAN(nn.Module):
    """Mini-batch HAN over sampled blocks (``DGL_HAN/train_sampling.py``):
    per metapath a BlockGATConv (``gat_p{j}``), then semantic attention
    (``sem``), then ``predict``. The seeds' and the blocks' feature rows
    are gathered from the full table on the device by B10."""

    def __init__(self, cfg: HANConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        D = cfg.num_heads[0] * cfg.hidden_units
        for gi in range(2):
            self.add_module(f"gat_p{gi}", BlockGATConv(
                cfg.num_features, cfg.hidden_units, cfg.num_heads[0], generator,
                feat_drop=cfg.dropout, attn_drop=cfg.dropout))
        self.sem = SemanticAttention(D, generator)
        self.predict = TorchDense(D, cfg.num_classes, generator)

    def forward(self, x_full: Tensor, seeds: Tensor, blocks: Dict[str, Tensor],
                train: bool = False, generator=None) -> Tensor:
        h_dst = gather(x_full, seeds)
        embeds = []
        for gi, name in enumerate(("vev", "eve")):
            src = blocks[f"{name}_src"]  # [B, K+1]
            h_src = gather(x_full, src.reshape(-1)).reshape(src.shape + (x_full.shape[-1],))
            embeds.append(getattr(self, f"gat_p{gi}")(h_src, h_dst, blocks[f"{name}_mask"],
                                                      train, generator))
        return self.predict(self.sem(torch.stack(embeds, dim=1)))


def han_extras(vev: Incidence, eve: Incidence) -> Dict[str, Incidence]:
    """Batch extras for HAN: the whole metapath Incidences, so that
    DGLGATConv takes the packed path."""
    return {"vev": vev, "eve": eve}

