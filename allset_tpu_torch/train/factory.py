"""Experiment config and per-method preparation.

Counterpart of ``allset_tpu/train/factory.py`` for AllSetTransformer:
the typed flag surface of the reference (``src/train.py:221-287``) and
the host preprocessing the method needs (self-loops, the exclude_self
expansion, entry norms), then the device Batch and the model
configuration. The other methods raise,
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.graph.transforms import (
    HyperData,
    add_self_loops,
    expand_edge_index,
    norm_construction,
)
from allset_tpu_torch.models.setgnn import SetGNNConfig

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
    dropout: float = 0.5
    aggregate: str = "mean"
    normtype: str = "all_one"  # 'all_one' | 'deg_half_sym'
    add_self_loop: bool = True
    normalization: str = "ln"
    gpr: bool = False
    learn_mask: bool = False
    exclude_self: bool = False
    # misc
    seed: int = 0
    bucket: int = 256
    dtype: str = "float32"  # or 'bfloat16' (mixed precision)


_QUEUE = {
    "AllDeepSets": "ROADMAP Queue 1 item 6",
    "MLP": "ROADMAP Queue 1 item 9",
}


def prepare(cfg: ExperimentConfig, data: HyperData,
            device: torch.device | str = "cuda") -> Tuple[SetGNNConfig, Batch]:
    """(method, raw HyperData) -> (model configuration, Batch on ``device``);
    the default, the card, raises without one."""
    if cfg.method not in METHODS:
        raise ValueError(f"unknown method {cfg.method!r}; choose from {METHODS}")
    if cfg.method != "AllSetTransformer":
        raise NotImplementedError(
            f"--method {cfg.method} is not ported yet "
            f"({_QUEUE.get(cfg.method, 'ROADMAP Queue 1 item 9')})")
    d = data
    if cfg.add_self_loop:
        d = add_self_loops(d)
    if cfg.exclude_self:
        d = expand_edge_index(d)
    d = norm_construction(d, option=cfg.normtype)
    batch = Batch.from_hyperdata(d, device=device, bucket=cfg.bucket)
    mcfg = SetGNNConfig(
        num_features=data.num_features,
        num_classes=data.num_classes,
        all_num_layers=cfg.all_num_layers,
        mlp_num_layers=cfg.mlp_num_layers,
        mlp_hidden=cfg.mlp_hidden,
        classifier_num_layers=cfg.classifier_num_layers,
        classifier_hidden=cfg.classifier_hidden,
        heads=cfg.heads,
        dropout=cfg.dropout,
        aggregate=cfg.aggregate,
        normalization=cfg.normalization,
        gpr=cfg.gpr,
        learn_mask=cfg.learn_mask,
        dtype=cfg.dtype,
        nnz_padded=batch.inc.nnz_padded,
    )
    return mcfg, batch
