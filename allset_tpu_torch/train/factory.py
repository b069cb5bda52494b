"""Experiment config and per-method preparation.

Counterpart of ``allset_tpu/train/factory.py``: the typed flag surface of
the reference (``src/train.py:221-287``) and the host preprocessing each
method needs (self-loops, the exclude_self expansion, entry norms, HNHN's
norm vectors, UniGNN's degrees), then the device Batch and the model
configuration, for AllSetTransformer, AllDeepSets, HCHA, HGNN (HCHA with
the symmetric degree norm), HNHN, UniGNN, UniGCNII, MLP, CEGCN and CEGAT
(the clique expansion: ``gcn_norm`` with self-loops for CEGCN, host-side
self-loops and unit weights for CEGAT) and HyperGCN (the Laplacian built
once on the fast path; the hyperedge dict for the reapprox path, which
rebuilds it in every forward).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.graph.incidence import Incidence
from allset_tpu_torch.graph.transforms import (
    HyperData,
    add_self_loops,
    construct_v2v,
    expand_edge_index,
    gcn_norm,
    generate_norm_hnhn,
    hypergcn_edge_dict,
    norm_construction,
    unignn_degrees,
)
from allset_tpu_torch.models import (CEConfig, HCHAConfig, HNHNConfig, HyperGCNConfig,
                                     MLPConfig, SetGNNConfig, UniGCNIIConfig, UniGNNConfig)
from allset_tpu_torch.models.hypergcn import build_hypergcn_laplacian

METHODS = (
    "AllSetTransformer",
    "AllDeepSets",
    "CEGCN",
    "CEGAT",
    "HyperGCN",
    "HGNN",
    "HNHN",
    "HCHA",
    "MLP",
    "UniGCNII",
    "UniGNN",
)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """The part of the flag surface of ``src/train.py:221-287`` that the
    ported methods read, typed (the JAX package's field names)."""

    method: str = "AllSetTransformer"
    dname: str = "synthetic"
    # training
    epochs: int = 500
    runs: int = 20
    lr: float = 1e-3
    wd: float = 0.0
    train_prop: float = 0.5
    valid_prop: float = 0.25
    # model
    all_num_layers: int = 2
    mlp_num_layers: int = 2
    mlp_hidden: int = 64
    classifier_num_layers: int = 2
    classifier_hidden: int = 64
    heads: int = 1
    output_heads: int = 1  # CEGAT's output conv
    dropout: float = 0.5
    aggregate: str = "mean"
    normtype: str = "all_one"  # 'all_one' | 'deg_half_sym'
    add_self_loop: bool = True
    normalization: str = "ln"
    deepset_input_norm: bool = True
    gpr: bool = False
    learn_mask: bool = False
    exclude_self: bool = False
    # HNHN
    hnhn_alpha: float = -1.5
    hnhn_beta: float = -0.5
    hnhn_nonlinear_inbetween: bool = True
    # HCHA
    hcha_symdegnorm: bool = False
    # HyperGCN
    hypergcn_mediators: bool = True
    hypergcn_fast: bool = True
    # UniGNN
    unignn_model_name: str = "UniGCN"
    unignn_use_norm: bool = False
    # misc
    seed: int = 0
    bucket: int = 256
    dtype: str = "float32"  # or 'bfloat16' (mixed precision)


def prepare(cfg: ExperimentConfig, data: HyperData,
            device: torch.device | str = "cuda") -> Tuple[object, Batch]:
    """(method, raw HyperData) -> (model configuration, Batch on ``device``);
    the default, the card, raises without one."""
    method = cfg.method
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    if method in ("AllSetTransformer", "AllDeepSets"):
        return _prepare_setgnn(cfg, data, device)
    if method in ("CEGCN", "CEGAT"):
        return (zoo_config(cfg, data.num_features, data.num_classes),
                Batch.from_incidence(data, v2v_incidence(data, method, cfg.bucket), device))
    if method == "HyperGCN":
        edge_dict = hypergcn_edge_dict(data)
        mcfg = zoo_config(cfg, data.num_features, data.num_classes, edge_dict=edge_dict)
        struct = None
        if cfg.hypergcn_fast:
            struct = build_hypergcn_laplacian(data.num_nodes, edge_dict, data.x,
                                              mediators=cfg.hypergcn_mediators, seed=cfg.seed,
                                              bucket=cfg.bucket)
        return mcfg, Batch.from_incidence(data, struct, device)
    mcfg = zoo_config(cfg, data.num_features, data.num_classes)
    if method == "MLP":
        return mcfg, Batch.from_hyperdata(data, device=device, bucket=cfg.bucket,
                                          with_incidence=False)
    d = add_self_loops(data) if cfg.add_self_loop else data
    if method == "HNHN":
        d = generate_norm_hnhn(d, alpha=cfg.hnhn_alpha, beta=cfg.hnhn_beta)
    elif method in ("UniGCNII", "UniGNN"):
        degV, degE = unignn_degrees(d)
        d = d.copy()
        d.extras.update(degV=degV, degE=degE)
    return mcfg, Batch.from_hyperdata(d, device=device, bucket=cfg.bucket)


def v2v_incidence(data: HyperData, method: str, bucket: int = 256) -> Incidence:
    """The clique expansion's V2V graph (each pair once, i<j) with the
    self-loops of every node: weighted by gcn_norm for CEGCN, unit weights
    for CEGAT (PyG's GATConv adds the loops at call time; here the host
    appends them)."""
    pairs, weights = construct_v2v(data)
    if method == "CEGCN":
        ei, norm = gcn_norm(pairs, weights, data.num_nodes, add_self_loops=True)
    else:
        loop = np.arange(data.num_nodes, dtype=np.int64)
        ei = np.concatenate([pairs, np.stack([loop, loop])], axis=1)
        norm = np.ones(ei.shape[1], dtype=np.float32)
    return Incidence.from_arrays(ei[0], ei[1], norm=norm, num_nodes=data.num_nodes,
                                 num_edges=data.num_nodes, bucket=bucket)


def zoo_config(cfg: ExperimentConfig, num_features: int, num_classes: int,
               edge_dict: Optional[dict] = None):
    """The model configuration of a zoo method (HCHA, HGNN, HNHN, UniGNN,
    UniGCNII, MLP, CEGCN, CEGAT, HyperGCN) from the flags; HyperGCN's
    reapprox path takes the hyperedge dict ``edge_dict``."""
    method = cfg.method
    if method in ("CEGCN", "CEGAT"):
        return CEConfig(num_features=num_features, num_classes=num_classes,
                        all_num_layers=cfg.all_num_layers, mlp_hidden=cfg.mlp_hidden,
                        dropout=cfg.dropout, normalization=cfg.normalization, heads=cfg.heads,
                        output_heads=cfg.output_heads, dtype=cfg.dtype,
                        conv="GCN" if method == "CEGCN" else "GAT")
    if method == "HyperGCN":
        return HyperGCNConfig(num_features=num_features, num_classes=num_classes,
                              all_num_layers=cfg.all_num_layers, dropout=cfg.dropout,
                              mediators=cfg.hypergcn_mediators, fast=cfg.hypergcn_fast,
                              dname=cfg.dname, dtype=cfg.dtype,
                              edge_dict=None if cfg.hypergcn_fast else edge_dict, seed=cfg.seed)
    common = dict(num_features=num_features, num_classes=num_classes,
                  all_num_layers=cfg.all_num_layers, mlp_hidden=cfg.mlp_hidden,
                  dtype=cfg.dtype)
    if method == "MLP":
        return MLPConfig(dropout=cfg.dropout, normalization=cfg.normalization, **common)
    if method in ("HCHA", "HGNN"):
        # --method HGNN is HCHA with the symmetric degree norm (src/train.py:77-82)
        return HCHAConfig(dropout=cfg.dropout,
                          symdegnorm=(method == "HGNN") or cfg.hcha_symdegnorm, **common)
    if method == "HNHN":
        return HNHNConfig(dropout=cfg.dropout,
                          nonlinear_inbetween=cfg.hnhn_nonlinear_inbetween, **common)
    if method == "UniGCNII":
        return UniGCNIIConfig(heads=cfg.heads, use_norm=cfg.unignn_use_norm, **common)
    if method == "UniGNN":
        return UniGNNConfig(model_name=cfg.unignn_model_name, heads=cfg.heads,
                            dropout=cfg.dropout, use_norm=cfg.unignn_use_norm, **common)
    raise ValueError(f"{method!r} is not a zoo method")


def _prepare_setgnn(cfg: ExperimentConfig, data: HyperData, device):
    d = data
    if cfg.add_self_loop:
        d = add_self_loops(d)
    if cfg.exclude_self:
        d = expand_edge_index(d)
    d = norm_construction(d, option=cfg.normtype)
    batch = Batch.from_hyperdata(d, device=device, bucket=cfg.bucket)
    kw = dict(
        num_features=data.num_features,
        num_classes=data.num_classes,
        all_num_layers=cfg.all_num_layers,
        mlp_num_layers=cfg.mlp_num_layers,
        mlp_hidden=cfg.mlp_hidden,
        classifier_num_layers=cfg.classifier_num_layers,
        classifier_hidden=cfg.classifier_hidden,
        heads=cfg.heads,
        dropout=cfg.dropout,
        normalization=cfg.normalization,
        deepset_input_norm=cfg.deepset_input_norm,
        gpr=cfg.gpr,
        learn_mask=cfg.learn_mask,
        dtype=cfg.dtype,
        nnz_padded=batch.inc.nnz_padded,
    )
    if cfg.method == "AllDeepSets":
        return SetGNNConfig.all_deep_sets(**kw), batch
    return SetGNNConfig(pma=True, aggregate=cfg.aggregate, **kw), batch


def make_optimizer(model: torch.nn.Module, lr: float, wd: float) -> torch.optim.Optimizer:
    """torch Adam with coupled L2 (weight decay added to the gradient before
    the moments, as optax's add_decayed_weights then scale_by_adam). UniGCNII
    takes the reference's two groups (``src/train.py:463-467``): its convs
    weight decay 0.01, ``lin_in``/``lin_out`` 5e-4, both at lr 0.01,
    whatever ``lr`` and ``wd``."""
    from allset_tpu_torch.models import UniGCNII

    if isinstance(model, UniGCNII):
        groups = {"reg": [], "nonreg": []}
        for name, p in model.named_parameters():
            groups["nonreg" if name.split(".")[0] in ("lin_in", "lin_out") else "reg"].append(p)
        return torch.optim.Adam([{"params": groups["reg"], "weight_decay": 0.01},
                                 {"params": groups["nonreg"], "weight_decay": 5e-4}],
                                lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    return torch.optim.Adam(model.parameters(), lr=lr, weight_decay=wd)
