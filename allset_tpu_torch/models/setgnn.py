"""SetGNN: the AllSet model, AllSetTransformer (pma=True) and AllDeepSets
(pma=False, the Deep Sets half-layer).

Counterpart of ``allset_tpu/models/setgnn.py``. ``All_num_layers``
rounds of V->E then E->V multiset functions (HalfNLHconv: PMA attention
pooling, or Deep Sets f_enc -> weighted reduce -> f_dec), then the
classifier MLP; ``All_num_layers=0`` is the classifier alone. The
inter-stage relu folds into each PMA half-layer's fused epilogue; the Deep
Sets half-layer ends in its own relu. Whether a kernel or its plain
version runs is decided by the device of the batch alone.

  * The exchange takes the self-loop split (N-slot layout) when the
    incidence has one, and the unsplit Directions when it has none
    (``add_self_loop=False``), under ``learn_mask``, or under
    ``normalization='bn'``: the split layout's hole rows would enter the
    batch statistics of the Deep Sets half-layer's f_dec, as in the JAX
    gate (``allset_tpu/models/setgnn.py:143-155``).
  * A batch with an edge-partitioned exchange ``shex``
    (``parallel/sharded.py``) routes both directions through it, except
    under 'bn', and under ``learn_mask`` unless it was built unsplit
    (``split=False``), which LearnMask's canonical-order norm needs to
    cover the self-loop entries (``allset_tpu/models/setgnn.py:137-150``).
    LearnMask's norm then travels on the Directions (``norm_canon``).
  * Without GPR the fixed input dropout 0.2 of the reference is kept; it
    is the identity when ``train=False``.
  * ``gpr`` (reference ``src/models.py:389-397,457-471``): the relu'd
    output of ``gpr_mlp`` on the features (f32, whatever ``dtype``) and
    every E->V output are stacked [N, hid, L+1] in f32 and mixed by the
    learned ``GPRweights`` [L+1, 1] before the classifier.
  * ``learn_mask``: a per-entry ``importance`` [nnz_padded] of ones,
    multiplied into the entry norm (canonical order; E->V takes it in the
    node-sorted order). The Deep Sets reduce is weighted by that product
    and gives importance its gradient (dir_spmm's SDDMM). PMA never reads
    the norm, so there (and with ``All_num_layers=0``) importance changes
    no logit and its gradient is zero: the port then gives it an explicit
    zero gradient, so Adam's weight decay still moves it as the JAX
    package's torch_adam does.

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
from allset_tpu_torch.nn.modules import MLP, HalfNLHconv, TorchDense, dropout, runs_of


@dataclasses.dataclass(frozen=True)
class SetGNNConfig:
    """Hyperparameters of SetGNN: the JAX package's field names.
    ``aggregate`` ('add', 'mean', 'max') is the Deep Sets reduce and
    ``deepset_input_norm`` gives its MLPs an input norm; the attention path
    reads neither. ``nnz_padded`` is the incidence's padded entry count,
    which sizes LearnMask's importance (the JAX model reads it from the
    batch at init)."""

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
    deepset_input_norm: bool = True
    pma: bool = True
    gpr: bool = False
    learn_mask: bool = False
    dtype: str = "float32"  # or 'bfloat16': bf16 activations, f32 params
    nnz_padded: int = 0

    @classmethod
    def all_deep_sets(cls, **kw) -> "SetGNNConfig":
        """The AllDeepSets factory override (``src/train.py:37-38``)."""
        kw.update(pma=False, aggregate="add")
        return cls(**kw)


class _ZeroGrad(torch.autograd.Function):
    """The identity on ``out`` that gives ``param`` a zero gradient."""

    @staticmethod
    def forward(ctx, out, param):
        ctx.save_for_backward(param)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        (param,) = ctx.saved_tensors
        return g, torch.zeros_like(param)


class SetGNN(nn.Module):
    def __init__(self, cfg: SetGNNConfig, generator: Generators):
        super().__init__()
        self.cfg = cfg
        self.runs = runs_of(generator)
        lead = () if self.runs is None else (self.runs,)
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else None
        L = cfg.all_num_layers
        if cfg.learn_mask:
            if cfg.nnz_padded <= 0:
                raise ValueError("learn_mask needs nnz_padded (the incidence's nnz_padded)")
            self.importance = nn.Parameter(torch.ones(lead + (cfg.nnz_padded,)))
        if cfg.gpr and L > 0:
            self.gpr_mlp = MLP(cfg.num_features, cfg.mlp_hidden, cfg.mlp_hidden,
                               cfg.mlp_num_layers, generator,
                               normalization=cfg.normalization, dropout=cfg.dropout)
        for i in range(L):
            for name, in_dim in ((f"V2E_{i}", cfg.num_features if i == 0 else cfg.mlp_hidden),
                                 (f"E2V_{i}", cfg.mlp_hidden)):
                self.add_module(name, HalfNLHconv(
                    in_dim, cfg.mlp_hidden, cfg.mlp_hidden, cfg.mlp_num_layers,
                    cfg.heads, generator, dtype=dtype, fold_relu=True,
                    attention=cfg.pma, dropout=cfg.dropout,
                    normalization=cfg.normalization, input_norm=cfg.deepset_input_norm,
                    norm_grad=cfg.learn_mask,
                ))
        if cfg.gpr and L > 0:
            self.GPRweights = TorchDense(L + 1, 1, generator, use_bias=False)
        self.classifier = MLP(cfg.mlp_hidden if L > 0 else cfg.num_features,
                              cfg.classifier_hidden, cfg.num_classes,
                              cfg.classifier_num_layers, generator, dtype=dtype,
                              normalization=cfg.normalization, dropout=cfg.dropout)

    def forward(self, batch: Batch, train: bool = False,
                generator: Generators | None = None) -> torch.Tensor:
        """Logits [N, num_classes] ([N, R, num_classes] with runs) in
        float32. ``generator`` drives the dropout masks when ``train``:
        one generator, or with runs a list of R."""
        cfg, inc = self.cfg, batch.inc
        if train and self.runs is not None and runs_of(generator) != self.runs:
            raise ValueError(f"train=True with {self.runs} runs needs {self.runs} generators")
        if cfg.learn_mask and self.importance.shape[-1] != inc.nnz_padded:
            raise ValueError(f"importance has {self.importance.shape[-1]} entries, the "
                             f"incidence {inc.nnz_padded}")
        logits = self._logits(batch, train, generator)
        if cfg.learn_mask and (cfg.pma or cfg.all_num_layers == 0):
            return _ZeroGrad.apply(logits, self.importance)
        return logits

    def _logits(self, batch: Batch, train: bool, generator) -> torch.Tensor:
        cfg, inc = self.cfg, batch.inc
        p = cfg.dropout
        if cfg.all_num_layers == 0:
            return self.classifier(batch.x, train, generator).float()
        shex = batch.shex
        if shex is not None and (cfg.normalization == "bn" or (
                cfg.learn_mask and shex.v2e.sl_mode != "none")):
            shex = None  # the JAX gate: these take the single-device exchange
        if shex is not None:
            d_v2e, d_e2v = shex.v2e, shex.e2v
        elif cfg.learn_mask or cfg.normalization == "bn" or inc.real is None:
            d_v2e, d_e2v = inc.v2e(), inc.e2v()
        else:
            d_v2e, d_e2v = inc.v2e_split(), inc.e2v_split()
        n_v2e = n_e2v = None  # the Deep Sets reduce's weights (execution order)
        if cfg.learn_mask and shex is not None:
            # canonical order on both Directions; the shards gather it
            n = self.importance * inc.norm
            d_v2e = dataclasses.replace(d_v2e, norm_canon=n)
            d_e2v = dataclasses.replace(d_e2v, norm_canon=n)
            n_v2e = n_e2v = None if cfg.pma else n
        elif not cfg.pma and cfg.learn_mask:
            n = self.importance * inc.norm  # canonical order, [(R,) nnz_padded]
            n_v2e, n_e2v = n, n[..., inc.node_perm]
        elif not cfg.pma:
            n_v2e, n_e2v = d_v2e.norm, d_e2v.norm
        kw = dict(aggr=cfg.aggregate, train=train, generator=generator)
        if cfg.gpr:
            xs = [torch.relu(self.gpr_mlp(batch.x, train, generator))]
            h = batch.x
        else:
            h = dropout(batch.x, 0.2, train, generator)  # fixed input dropout
        for i in range(cfg.all_num_layers):
            h = getattr(self, f"V2E_{i}")(h, d_v2e, n_v2e, **kw)  # ends in a relu
            h = dropout(h, p, train, generator)
            h = getattr(self, f"E2V_{i}")(h, d_e2v, n_e2v, **kw)
            if cfg.gpr:
                xs.append(h)
            h = dropout(h, p, train, generator)
        if cfg.gpr:
            stacked = torch.stack([t.float() for t in xs], dim=-1)  # [N, (R,) hid, L+1]
            h = self.GPRweights(stacked).squeeze(-1)
        return self.classifier(h, train, generator).float()
