"""HNHN: Hypergraph Networks with Hyperedge Neurons.

Counterpart of ``allset_tpu/models/hnhn.py`` (reference
``src/layers.py:233-315`` and ``src/models.py:207-249``). One conv:

    E  = D_e_beta_inv * segsum_e( (D_v_beta * (X W_v2e))[v] )   V->E
    E  = relu(E)                 (nonlinear_inbetween)
    X' = D_v_alpha_inv * segsum_v( (D_e_alpha * (E W_e2v))[e] ) E->V

with the four degree-powered vectors from ``graph.transforms.
generate_norm_hnhn`` in ``batch.extras``. Both passes are the sorted
exchange ``dir_spmm``; the destination norms are row scalings of its
output. On the self-loop split the per-edge vectors are laid out as the
N-slot table: [real edges | one slot per node], zero at holes.

Statistical runs: as in ``models/hcha.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.nn.init import Generators
from allset_tpu_torch.nn.modules import TorchDense, dropout, fold, row_scale, runs_of, unfold
from allset_tpu_torch.ops.exchange import dir_spmm

Tensor = torch.Tensor


class HNHNConv(nn.Module):
    def __init__(self, in_dim: int, hidden_channels: int, out_channels: int,
                 generator: Generators, nonlinear_inbetween: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.runs = runs_of(generator)
        self.nonlinear_inbetween = nonlinear_inbetween
        self.weight_v2e = TorchDense(in_dim, hidden_channels, generator, dtype=dtype)
        self.weight_e2v = TorchDense(hidden_channels, out_channels, generator, dtype=dtype)

    def forward(self, x: Tensor, batch: Batch, train: bool = False, generator=None) -> Tensor:
        inc, ex, R = batch.inc, batch.extras, self.runs
        if inc.real is not None:
            mr = inc.real.num_edges

            def slot(vec_e):
                tail = torch.zeros(inc.num_nodes, dtype=vec_e.dtype, device=vec_e.device)
                tail[inc.sl_node] = vec_e[mr:][: inc.num_sl_edges]
                return torch.cat([vec_e[:mr], tail])

            scale_e_out, scale_e_in = slot(ex["D_e_beta_inv"]), slot(ex["D_e_alpha"])
            dv, de = inc.v2e_split(), inc.e2v_split()
        else:
            scale_e_out, scale_e_in = ex["D_e_beta_inv"], ex["D_e_alpha"]
            dv, de = inc.v2e(), inc.e2v()

        x = row_scale(self.weight_v2e(x), ex["D_v_beta"])
        out = row_scale(dir_spmm(fold(x, R), dv), scale_e_out)
        if self.nonlinear_inbetween:
            out = torch.relu(out)
        out = row_scale(self.weight_e2v(unfold(out, R)), scale_e_in)
        out = dir_spmm(fold(out, R), de)
        return unfold(row_scale(out, ex["D_v_alpha_inv"]), R)


@dataclasses.dataclass(frozen=True)
class HNHNConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_hidden: int = 64
    dropout: float = 0.5
    nonlinear_inbetween: bool = True
    dtype: str = "float32"  # 'bfloat16' -> mixed precision (f32 reduce accumulation)


class HNHN(nn.Module):
    def __init__(self, cfg: HNHNConfig, generator: Generators):
        super().__init__()
        self.cfg = cfg
        self.runs = runs_of(generator)
        self.dt = torch.bfloat16 if cfg.dtype == "bfloat16" else None
        widths = [cfg.mlp_hidden] * (cfg.all_num_layers - 1) + [cfg.num_classes]
        self.num_layers = len(widths)
        for i, w in enumerate(widths):
            fan_in = cfg.num_features if i == 0 else cfg.mlp_hidden
            self.add_module(f"conv{i}", HNHNConv(fan_in, cfg.mlp_hidden, w, generator,
                                                 cfg.nonlinear_inbetween, dtype=self.dt))

    def forward(self, batch: Batch, train: bool = False, generator=None) -> Tensor:
        x = batch.x if self.dt is None else batch.x.to(self.dt)
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i}")(x, batch, train, generator)
            if i < self.num_layers - 1:
                x = torch.relu(x)
                x = dropout(x, self.cfg.dropout, train, generator)
        return x.float()
