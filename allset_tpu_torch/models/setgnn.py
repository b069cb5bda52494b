"""SetGNN: the AllSet model, AllSetTransformer mode.

Counterpart of ``allset_tpu/models/setgnn.py`` for ``pma=True`` on the
self-loop split path. ``All_num_layers`` rounds of V->E then E->V
attention pooling (HalfNLHconv), then the classifier MLP. The inter-stage
relu folds into each half-layer's fused epilogue. The fixed input dropout
0.2 of the reference is kept; it is the identity when ``train=False``.
Whether a kernel or its plain version runs is decided by the device of
the batch alone.

Statistical runs: built with a list of R generators, one per run, every
parameter carries a leading [R] axis (the JAX package's vmapped tree) and
the logits are [N, R, C]; run r is the model a single generator r builds,
and its dropout masks come from the r-th forward generator.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.nn.init import Generators
from allset_tpu_torch.nn.modules import MLP, HalfNLHconv, dropout, runs_of

_LATER = "comes with the AllDeepSets/GPR/LearnMask port (ROADMAP Queue 1 item 6)"


@dataclasses.dataclass(frozen=True)
class SetGNNConfig:
    """Hyperparameters of SetGNN: the JAX package's field names, limited
    to what the AllSetTransformer path reads or rejects. ``aggregate`` is
    the Deep Sets reduce; the attention path does not read it."""

    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_num_layers: int = 2
    mlp_hidden: int = 64
    classifier_num_layers: int = 2
    classifier_hidden: int = 64
    heads: int = 1
    dropout: float = 0.5
    aggregate: str = "mean"
    normalization: str = "ln"
    pma: bool = True
    gpr: bool = False
    learn_mask: bool = False
    dtype: str = "float32"  # or 'bfloat16': bf16 activations, f32 params


class SetGNN(nn.Module):
    def __init__(self, cfg: SetGNNConfig, generator: Generators):
        super().__init__()
        if not cfg.pma:
            raise NotImplementedError(f"AllDeepSets {_LATER}")
        if cfg.gpr or cfg.learn_mask:
            raise NotImplementedError(f"gpr / learn_mask {_LATER}")
        if cfg.all_num_layers < 1:
            raise NotImplementedError(f"all_num_layers=0 {_LATER}")
        if cfg.normalization == "bn":
            raise NotImplementedError(f"normalization='bn' {_LATER}")
        self.cfg = cfg
        self.runs = runs_of(generator)
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else None
        for i in range(cfg.all_num_layers):
            for name, in_dim in ((f"V2E_{i}", cfg.num_features if i == 0 else cfg.mlp_hidden),
                                 (f"E2V_{i}", cfg.mlp_hidden)):
                self.add_module(name, HalfNLHconv(
                    in_dim, cfg.mlp_hidden, cfg.mlp_hidden, cfg.mlp_num_layers,
                    cfg.heads, generator, dtype=dtype, fold_relu=True,
                ))
        self.classifier = MLP(cfg.mlp_hidden, cfg.classifier_hidden, cfg.num_classes,
                              cfg.classifier_num_layers, generator, dtype=dtype,
                              normalization=cfg.normalization, dropout=cfg.dropout)

    def forward(self, batch: Batch, train: bool = False,
                generator: Generators | None = None) -> torch.Tensor:
        """Logits [N, num_classes] ([N, R, num_classes] with runs) in
        float32. ``generator`` drives the dropout masks when ``train``:
        one generator, or with runs a list of R."""
        inc = batch.inc
        if inc.real is None:
            raise NotImplementedError(
                "SetGNN needs the self-loop split (add_self_loops); the "
                f"unsplit exchange {_LATER}"
            )
        if train and self.runs is not None and runs_of(generator) != self.runs:
            raise ValueError(f"train=True with {self.runs} runs needs {self.runs} generators")
        d_v2e, d_e2v = inc.v2e_split(), inc.e2v_split()
        p = self.cfg.dropout
        h = dropout(batch.x, 0.2, train, generator)  # fixed input dropout
        for i in range(self.cfg.all_num_layers):
            h = getattr(self, f"V2E_{i}")(h, d_v2e)  # relu folded in
            h = dropout(h, p, train, generator)
            h = getattr(self, f"E2V_{i}")(h, d_e2v)
            h = dropout(h, p, train, generator)
        return self.classifier(h, train, generator).float()
