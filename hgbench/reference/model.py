"""SetGNN in plain PyTorch, float32: AllSetTransformer (PMA half-layers)
and AllDeepSets (Deep Sets half-layers), one statistical run at a time.

It follows the AllSet paper (ICLR 2022) and its code (``src/layers.py``
PMA, HalfNLHconv and MLP; ``src/models.py`` SetGNN) as the JAX package
and its port state them:

  * a PMA half-layer: x_K = x W_K + b_K, x_V = x W_V + b_V; per head the
    score alpha = leaky_relu(<x_K, a>, 0.2) of each member against the
    learned seed a; the softmax of the scores over each destination's
    members (shifted by the destination's own max); agg = the weighted
    sum of the members' x_V; z = LN0(agg + a); out = relu(LN1(z +
    relu(rFF(z)))), rFF an MLP of ``MLP_num_layers`` layers with relus
    between them, no norm and no dropout;
  * a Deep Sets half-layer: relu(f_dec(sum over members of
    dropout(relu(f_enc(x))))), f_enc and f_dec MLPs with an input
    LayerNorm, each hidden layer lin -> relu -> LN -> dropout;
  * SetGNN: input dropout 0.2; per layer V->E, dropout, E->V, dropout;
    then the classifier MLP.

LayerNorm has eps 1e-5 and takes the two-pass variance. The hyperedge
side of the exchange is a table of the real hyperedges followed by one
self-loop row per node; a node in a hyperedge of one member gets no
self-loop (``src/preprocessing.py:412-448``), and its row has no member.
Such a row reaches nothing, but its dropout mask is drawn with the rest:
each mask is drawn [rows, width] from the run's generator as
``torch.rand(...) >= p``, in the order of the forward, so that the masks
are the program's. Parameters are laid out [in, out], named and ordered
as the program's ``named_parameters`` with the runs axis taken away, and
drawn on the CPU from the run's generator in the order the program's
modules are built (``nn/init.py``'s laws).

The departure from the reference code: PyG's softmax over each
destination is taken here as it is written; the program shifts by a
global max per head, which is the same in real arithmetic.

``mm`` is the matrix product of every dense layer; the control passes
one that rounds its operands to TF32 (``control.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from hgbench.graphs import Graph, self_loop_nodes

LN_EPS = 1e-5
INPUT_DROPOUT = 0.2
NEGATIVE_SLOPE = 0.2

Params = Dict[str, torch.Tensor]


def plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


@dataclasses.dataclass(frozen=True)
class Model:
    """The sizes and settings a configuration file states."""

    method: str
    num_features: int
    num_classes: int
    layers: int
    mlp_layers: int
    hidden: int
    cls_layers: int
    cls_hidden: int
    heads: int
    dropout: float

    @property
    def pma(self) -> bool:
        return self.method == "AllSetTransformer"


SUPPORTED = {"normalization": "ln", "add_self_loop": True, "normtype": "all_one",
             "deepset_input_norm": True, "dtype": "float32", "GPR": False, "LearnMask": False}


def model_of(config: dict, graph: Graph) -> Model:
    """The reference model of a configuration file on ``graph``; raises on
    a setting this reference does not compute."""
    for key, want in SUPPORTED.items():
        if config.get(key, want) != want:
            raise NotImplementedError(f"the reference computes {key}={want!r} only")
    if config["method"] not in ("AllSetTransformer", "AllDeepSets"):
        raise NotImplementedError(f"no reference for {config['method']!r}")
    return Model(method=config["method"], num_features=graph.num_features,
                 num_classes=graph.num_classes, layers=config["All_num_layers"],
                 mlp_layers=config["MLP_num_layers"], hidden=config["MLP_hidden"],
                 cls_layers=config["Classifier_num_layers"],
                 cls_hidden=config["Classifier_hidden"], heads=config["heads"],
                 dropout=config["dropout"])


# --- the exchange's structure ---


@dataclasses.dataclass
class Structure:
    """Entries of both directions over the node table [N] and the
    hyperedge-side table [E + N] (real hyperedges, then a self-loop row
    per node)."""

    num_nodes: int
    edge_rows: int
    v2e_src: torch.Tensor  # node ids
    v2e_dst: torch.Tensor  # hyperedge-side rows

    @property
    def e2v_src(self):
        return self.v2e_dst

    @property
    def e2v_dst(self):
        return self.v2e_src


def structure(g: Graph, device) -> Structure:
    loops = np.flatnonzero(self_loop_nodes(g))
    src = np.concatenate([g.node, loops]).astype(np.int64)
    dst = np.concatenate([g.edge, g.num_hyperedges + loops]).astype(np.int64)
    return Structure(num_nodes=g.num_nodes, edge_rows=g.num_hyperedges + g.num_nodes,
                     v2e_src=torch.from_numpy(src).to(device),
                     v2e_dst=torch.from_numpy(dst).to(device))


# --- parameters ---


def _uniform(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def _dense(p: Params, name: str, fan_in: int, out: int, gen, kernel_bound=None) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    p[f"{name}.kernel"] = _uniform((fan_in, out), bound if kernel_bound is None else
                                   kernel_bound, gen)
    p[f"{name}.bias"] = _uniform((out,), bound, gen)


def _ln_params(p: Params, name: str, dim: int) -> None:
    p[f"{name}.scale"] = torch.ones(dim)
    p[f"{name}.bias"] = torch.zeros(dim)


def _mlp(p: Params, name: str, in_dim: int, hidden: int, out: int, layers: int, gen,
         input_norm: bool) -> None:
    if input_norm:
        _ln_params(p, f"{name}.input_norm.LayerNorm_0", in_dim)
    for i in range(layers - 1):
        _dense(p, f"{name}.lin{i}", in_dim if i == 0 else hidden, hidden, gen)
        _ln_params(p, f"{name}.norm{i}.LayerNorm_0", hidden)
    last = layers - 1
    _dense(p, f"{name}.lin{last}", in_dim if last == 0 else hidden, out, gen)


def _pma(p: Params, name: str, in_dim: int, hc: int, heads: int, layers: int, gen) -> None:
    c = hc // heads
    # draws in the order the program builds the module: lin_K, lin_V, the
    # seed, the rFF; named_parameters lists the seed first
    glorot = math.sqrt(6.0 / (in_dim + hc))
    k: Params = {}
    _dense(k, f"{name}.lin_K", in_dim, hc, gen, kernel_bound=glorot)
    _dense(k, f"{name}.lin_V", in_dim, hc, gen, kernel_bound=glorot)
    p[f"{name}.att_r"] = _uniform((1, heads, c), math.sqrt(6.0 / (heads * c + c)), gen)
    p.update(k)
    _ln_params(p, f"{name}.ln0", hc)
    for i in range(layers):
        _dense(p, f"{name}.rFF.lin{i}", hc, hc, gen)
    _ln_params(p, f"{name}.ln1", hc)


def init_params(m: Model, gen: torch.Generator) -> Params:
    """One run's parameters, named and ordered as the program's."""
    p: Params = {}
    for i in range(m.layers):
        for half, in_dim in ((f"V2E_{i}", m.num_features if i == 0 else m.hidden),
                             (f"E2V_{i}", m.hidden)):
            if m.pma:
                _pma(p, f"{half}.prop", in_dim, m.hidden, m.heads, m.mlp_layers, gen)
            else:
                _mlp(p, f"{half}.f_enc", in_dim, m.hidden, m.hidden, m.mlp_layers, gen, True)
                _mlp(p, f"{half}.f_dec", m.hidden, m.hidden, m.hidden, m.mlp_layers, gen, True)
    _mlp(p, "classifier", m.hidden if m.layers > 0 else m.num_features, m.cls_hidden,
         m.num_classes, m.cls_layers, gen, False)
    return p


# --- the forward ---


class Forward:
    """One run's forward on a structure: ``train`` draws dropout masks
    from ``gen`` on x's device."""

    def __init__(self, m: Model, s: Structure, mm: Callable = plain_mm):
        self.m, self.s, self.mm = m, s, mm

    def dropout(self, x, p, train, gen):
        if not train or p == 0.0:
            return x
        keep = torch.rand((x.shape[0], x.shape[-1]), generator=gen, device=x.device) >= p
        return x * keep.to(x.dtype) / (1.0 - p)

    def linear(self, x, p: Params, name: str):
        return self.mm(x, p[f"{name}.kernel"]) + p[f"{name}.bias"]

    @staticmethod
    def ln(x, p: Params, name: str):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + LN_EPS) * p[f"{name}.scale"] + p[f"{name}.bias"]

    def mlp(self, x, p, name, layers, train, gen, input_norm):
        if input_norm:
            x = self.ln(x, p, f"{name}.input_norm.LayerNorm_0")
        for i in range(layers - 1):
            x = torch.relu(self.linear(x, p, f"{name}.lin{i}"))
            x = self.ln(x, p, f"{name}.norm{i}.LayerNorm_0")
            x = self.dropout(x, self.m.dropout, train, gen)
        return self.linear(x, p, f"{name}.lin{layers - 1}")

    def pma(self, x, p, name, src, dst, rows):
        m = self.m
        H, HC = m.heads, m.hidden
        C = HC // H
        att = p[f"{name}.att_r"].reshape(HC)
        xk = self.linear(x, p, f"{name}.lin_K")
        xv = self.linear(x, p, f"{name}.lin_V")
        alpha = F.leaky_relu((xk.view(-1, H, C) * att.view(H, C)).sum(-1), NEGATIVE_SLOPE)
        a = alpha[src]  # [entries, H]
        top = torch.full((rows, H), float("-inf"), device=x.device)
        top = top.scatter_reduce(0, dst[:, None].expand(-1, H), a.detach(), "amax",
                                 include_self=True)
        e = torch.exp(a - top[dst])
        den = torch.zeros(rows, H, device=x.device).index_add(0, dst, e)
        w = e / den[dst]
        msg = (xv[src].view(-1, H, C) * w[:, :, None]).reshape(-1, HC)
        agg = torch.zeros(rows, HC, device=x.device).index_add(0, dst, msg)
        z = self.ln(agg + att, p, f"{name}.ln0")
        h = z
        for i in range(m.mlp_layers):
            h = self.linear(h, p, f"{name}.rFF.lin{i}")
            if i < m.mlp_layers - 1:
                h = torch.relu(h)
        return torch.relu(self.ln(z + torch.relu(h), p, f"{name}.ln1"))

    def deepsets(self, x, p, name, src, dst, rows, train, gen):
        m = self.m
        x = self.mlp(x, p, f"{name}.f_enc", m.mlp_layers, train, gen, True)
        x = self.dropout(torch.relu(x), m.dropout, train, gen)
        x = torch.zeros(rows, x.shape[1], device=x.device).index_add(0, dst, x[src])
        x = self.mlp(x, p, f"{name}.f_dec", m.mlp_layers, train, gen, True)
        return torch.relu(x)

    def __call__(self, x, p: Params, train: bool, gen=None):
        """Logits [N, classes] of features x [N, F]."""
        m, s = self.m, self.s
        h = self.dropout(x, INPUT_DROPOUT, train, gen)
        halves = ((s.v2e_src, s.v2e_dst, s.edge_rows), (s.e2v_src, s.e2v_dst, s.num_nodes))
        for i in range(m.layers):
            for (src, dst, rows), half in zip(halves, (f"V2E_{i}", f"E2V_{i}")):
                if m.pma:
                    h = self.pma(h, p, f"{half}.prop", src, dst, rows)
                else:
                    h = self.deepsets(h, p, half, src, dst, rows, train, gen)
                h = self.dropout(h, m.dropout, train, gen)
        return self.mlp(h, p, "classifier", m.cls_layers, train, gen, False)


def masked_nll(logits: torch.Tensor, y: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the node ids ``rows``."""
    return -torch.log_softmax(logits[rows], dim=-1).gather(1, y[rows][:, None]).mean()
