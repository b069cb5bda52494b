"""The structure-free MLP baseline and the legacy dense-G HGNN.

Counterpart of ``allset_tpu/models/legacy_hgnn.py``:

  * ``MLPModel`` (``--method MLP``; reference ``src/models.py:487-577``):
    the MLP of ``nn/modules.py`` on the features alone, its LayerNorms
    through the B12/B13 kernels on the card;
  * ``LegacyHGNN`` (Feng et al. 2019; reference ``src/layers.py:202-230``
    and ``src/models.py:186-204``): two dense propagations by the
    precomputed G = D_v^{-1/2} H W D_e^{-1} H^T D_v^{-1/2}
    (``graph.transforms.generate_g_from_h``) in ``batch.extras['G']``.
    Kept for completeness: ``--method HGNN`` runs HCHA with the symmetric
    degree norm, as in the reference and the JAX package.

Statistical runs: as in ``models/hcha.py``; G multiplies the runs folded
into the width.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.nn.init import Generators
from allset_tpu_torch.nn.modules import MLP, TorchDense, dropout, fold, runs_of, unfold

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LegacyHGNNConfig:
    num_features: int
    num_classes: int
    mlp_hidden: int = 64
    dropout: float = 0.5


class LegacyHGNN(nn.Module):
    def __init__(self, cfg: LegacyHGNNConfig, generator: Generators):
        super().__init__()
        self.cfg, self.runs = cfg, runs_of(generator)
        self.hgc1 = TorchDense(cfg.num_features, cfg.mlp_hidden, generator)
        self.hgc2 = TorchDense(cfg.mlp_hidden, cfg.num_classes, generator)

    def forward(self, batch: Batch, train: bool = False, generator=None) -> Tensor:
        G, R = batch.extras["G"], self.runs
        x = unfold(G @ fold(self.hgc1(batch.x), R), R)
        x = dropout(torch.relu(x), self.cfg.dropout, train, generator)
        return unfold(G @ fold(self.hgc2(x), R), R)


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_hidden: int = 64
    dropout: float = 0.5
    normalization: str = "ln"
    dtype: str = "float32"  # 'bfloat16' -> mixed precision


class MLPModel(nn.Module):
    """Structure-free MLP baseline: logits of the features alone."""

    def __init__(self, cfg: MLPConfig, generator: Generators):
        super().__init__()
        self.cfg = cfg
        self.dt = torch.bfloat16 if cfg.dtype == "bfloat16" else None
        self.mlp = MLP(cfg.num_features, cfg.mlp_hidden, cfg.num_classes, cfg.all_num_layers,
                       generator, dtype=self.dt, normalization=cfg.normalization,
                       dropout=cfg.dropout)

    def forward(self, batch: Batch, train: bool = False, generator=None) -> Tensor:
        x = batch.x if self.dt is None else batch.x.to(self.dt)
        return self.mlp(x, train, generator).float()
